"""GPT-OSS-20B (paper workload, Table 3): MoE 32e top-4 [arXiv:2508.10925].

Copied from ``repro/configs/gpt_oss_20b.py``."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="gpt-oss-20b", family="moe",
    n_layers=24, d_model=2880, n_heads=64, n_kv_heads=8, d_head=64,
    d_ff=2880, vocab_size=201088,
    n_experts=32, experts_per_token=4, moe_d_ff=2880,
    mlp_kind="swiglu", norm_kind="rmsnorm", rope=True,
    source="arXiv:2508.10925; hf",
))
