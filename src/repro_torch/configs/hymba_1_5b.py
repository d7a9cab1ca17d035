"""Hymba-1.5B: hybrid parallel attention + Mamba heads [arXiv:2411.13676].

Copied from ``repro/configs/hymba_1_5b.py``, with its deviation: sliding-window
attention in every layer (Hymba itself keeps 3 global-attention layers), the
Mamba branch carrying the global context."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hymba-1.5b", family="hybrid",
    n_layers=32, d_model=1600, n_heads=25, n_kv_heads=5,
    d_ff=5504, vocab_size=32001,
    block_kind="hybrid", ssm_state=16, ssm_expand=2,
    sliding_window=1024,
    mlp_kind="swiglu", norm_kind="rmsnorm", rope=True,
    source="arXiv:2411.13676; hf",
))
