"""Nemotron-4-340B: dense GQA with squared-ReLU MLP [arXiv:2402.16819].

Copied from ``repro/configs/nemotron_4_340b.py``."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="nemotron-4-340b", family="dense",
    n_layers=96, d_model=18432, n_heads=96, n_kv_heads=8,
    d_ff=73728, vocab_size=256000,
    mlp_kind="relu2", norm_kind="layernorm", rope=True,
    source="arXiv:2402.16819; unverified",
))
