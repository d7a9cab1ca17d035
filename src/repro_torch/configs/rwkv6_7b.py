"""RWKV6-World-7B "Finch": attention-free, data-dependent decay [arXiv:2404.05892].

Copied from ``repro/configs/rwkv6_7b.py``."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="rwkv6-7b", family="ssm",
    n_layers=32, d_model=4096, n_heads=0, n_kv_heads=0, d_head=64,
    d_ff=14336, vocab_size=65536,
    attn_kind="none", block_kind="rwkv6",
    mlp_kind="swiglu", norm_kind="layernorm", rope=False,
    source="arXiv:2404.05892; hf",
))
