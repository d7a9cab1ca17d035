"""HuBERT-XLarge: encoder-only audio transformer [arXiv:2106.07447].

The conv feature extractor is a stubbed frontend: ``input_specs`` feeds
precomputed frame embeddings (B,S,1280); the head classifies 504 units.
No decode path (encoder-only) — decode/long shapes are skipped.

Copied from ``repro/configs/hubert_xlarge.py``."""
from repro_torch.models.config import ModelConfig, register

CONFIG = register(ModelConfig(
    name="hubert-xlarge", family="audio",
    n_layers=48, d_model=1280, n_heads=16, n_kv_heads=16,
    d_ff=5120, vocab_size=504,
    mlp_kind="gelu", norm_kind="layernorm", rope=False,
    causal=False, encoder_only=True, frontend="audio",
    source="arXiv:2106.07447; unverified",
))
