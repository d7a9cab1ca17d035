"""Llama-3.1-8B (paper workload, Table 3) [arXiv:2407.21783].

Copied from ``repro/configs/llama_3_1_8b.py``."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="llama-3.1-8b", family="dense",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=128256,
    mlp_kind="swiglu", norm_kind="rmsnorm", rope=True, rope_theta=500_000.0,
    source="arXiv:2407.21783; hf",
))
