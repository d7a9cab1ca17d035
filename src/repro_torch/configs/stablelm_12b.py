"""StableLM-2-12B: dense GQA [hf:stabilityai/stablelm-2-12b].

Copied from ``repro/configs/stablelm_12b.py``."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="stablelm-12b", family="dense",
    n_layers=40, d_model=5120, n_heads=32, n_kv_heads=8,
    d_ff=13824, vocab_size=100352,
    mlp_kind="swiglu", norm_kind="layernorm", rope=True,
    source="hf:stabilityai/stablelm-2-1_6b family; hf",
))
