"""DeepSeek-V2-236B: MLA (kv_lora=512) + MoE 160 routed top-6, 2 shared
[arXiv:2405.04434].

Copied from ``repro/configs/deepseek_v2_236b.py``, with its deviation: the
real model's first layer is dense (first_k_dense_replace=1); all 60 layers
here are MoE, as in the reference.
"""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="deepseek-v2-236b", family="moe",
    n_layers=60, d_model=5120, n_heads=128, n_kv_heads=128, d_head=128,
    d_ff=1536, vocab_size=102400,
    attn_kind="mla", kv_lora_rank=512, qk_rope_dim=64, v_head_dim=128,
    n_experts=160, experts_per_token=6, n_shared_experts=2, moe_d_ff=1536,
    mlp_kind="swiglu", norm_kind="rmsnorm", rope=True,
    source="arXiv:2405.04434; hf",
))
