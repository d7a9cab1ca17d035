"""Gemma-2B: MQA (kv=1), GeGLU, head_dim=256 [arXiv:2403.08295].

Copied from ``repro/configs/gemma_2b.py``."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gemma-2b", family="dense",
    n_layers=18, d_model=2048, n_heads=8, n_kv_heads=1, d_head=256,
    d_ff=16384, vocab_size=256000,
    mlp_kind="geglu", norm_kind="rmsnorm", rope=True,
    tie_embeddings=True,
    source="arXiv:2403.08295; hf",
))
