"""Qwen3-32B (paper workload, Table 3) [arXiv:2505.09388].

Copied from ``repro/configs/qwen3_32b.py``."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-32b", family="dense",
    n_layers=64, d_model=5120, n_heads=64, n_kv_heads=8, d_head=128,
    d_ff=25600, vocab_size=151936,
    mlp_kind="swiglu", norm_kind="rmsnorm", rope=True,
    source="arXiv:2505.09388; hf",
))
