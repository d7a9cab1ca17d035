"""Serving steps of the port: prefill and one-token decode.

The counterparts of ``build_prefill_step`` and ``build_decode_step`` in
``repro/launch/steps.py``, without a mesh: plain functions that run under
``torch.inference_mode()`` on the device their inputs live on. Multi-card
serving is a later slice.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig


def build_prefill_step(cfg: ModelConfig, max_len: int):
    """prefill_step(params, batch) -> (last-position logits (B,V) fp32, cache).

    The cache takes the parameters' dtype. The reference always caches in
    bf16; with bf16 weights, as served, the two agree."""
    @torch.inference_mode()
    def prefill_step(params, batch):
        x, cache = T.prefill(params, batch, cfg, max_len, dtype=params["embed"].dtype)
        logits = (x[:, -1] @ T.lm_head_weights(params, cfg)).float()
        return logits, cache

    return prefill_step


def build_decode_step(cfg: ModelConfig):
    """decode(params, cache, tokens (B,)) -> (logits (B,V) fp32, cache); the
    cache's tensors are updated in place."""
    @torch.inference_mode()
    def decode(params, cache, tokens):
        return T.decode_step(params, cache, tokens, cfg)

    return decode
