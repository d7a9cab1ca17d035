"""Qwen3-1.7B (paper workload, Table 3) [arXiv:2505.09388].

Copied from ``repro/configs/qwen3_1_7b.py``. Like the reference, it has no
qk-norm and keeps the default ``rope_theta``: the port computes what the
reference computes."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-1.7b", family="dense",
    n_layers=28, d_model=2048, n_heads=16, n_kv_heads=8, d_head=128,
    d_ff=6144, vocab_size=151936,
    mlp_kind="swiglu", norm_kind="rmsnorm", rope=True, tie_embeddings=True,
    source="arXiv:2505.09388; hf",
))
