"""InternVL2-76B: InternViT frontend (stubbed) + Llama-3-70B-class LM
backbone [arXiv:2404.16821].  ``input_specs`` feeds precomputed patch
embeddings for train/prefill; decode runs the LM backbone on tokens.

Copied from ``repro/configs/internvl2_76b.py``."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="internvl2-76b", family="vlm",
    n_layers=80, d_model=8192, n_heads=64, n_kv_heads=8,
    d_ff=28672, vocab_size=128256,
    mlp_kind="swiglu", norm_kind="rmsnorm", rope=True,
    frontend="vision",
    source="arXiv:2404.16821; unverified",
))
