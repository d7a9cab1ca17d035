"""StarCoder2-7B: dense GQA + RoPE, non-gated GELU MLP [arXiv:2402.19173].

Copied from ``repro/configs/starcoder2_7b.py``."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="starcoder2-7b", family="dense",
    n_layers=32, d_model=4608, n_heads=36, n_kv_heads=4,
    d_ff=18432, vocab_size=49152,
    mlp_kind="gelu", norm_kind="layernorm", rope=True,
    source="arXiv:2402.19173; hf",
))
