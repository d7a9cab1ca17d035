"""Qwen3-235B-A22B (paper workload, Table 3): MoE 128e top-8 [arXiv:2505.09388].

Copied from ``repro/configs/qwen3_235b.py``."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="qwen3-235b", family="moe",
    n_layers=94, d_model=4096, n_heads=64, n_kv_heads=4, d_head=128,
    d_ff=1536, vocab_size=151936,
    n_experts=128, experts_per_token=8, moe_d_ff=1536,
    mlp_kind="swiglu", norm_kind="rmsnorm", rope=True,
    source="arXiv:2505.09388; hf",
))
