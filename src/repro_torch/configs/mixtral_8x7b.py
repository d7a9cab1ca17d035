"""Mixtral-8x7B: 8 experts top-2, sliding-window attention [arXiv:2401.04088].

Copied from ``repro/configs/mixtral_8x7b.py``."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="mixtral-8x7b", family="moe",
    n_layers=32, d_model=4096, n_heads=32, n_kv_heads=8,
    d_ff=14336, vocab_size=32000,
    n_experts=8, experts_per_token=2, moe_d_ff=14336,
    sliding_window=4096,
    mlp_kind="swiglu", norm_kind="rmsnorm", rope=True,
    source="arXiv:2401.04088; hf",
))
