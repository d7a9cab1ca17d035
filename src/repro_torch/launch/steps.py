"""Step configuration and serving steps of the port.

``StepConfig`` carries the reference's field names and defaults
(``repro/launch/steps.py``); the roundpipe train step is built from it by
``repro_torch.core.dispatch.build_roundpipe_train_step``.
``build_prefill_step`` and ``build_decode_step`` are the serving steps,
without a mesh: plain functions that run under ``torch.inference_mode()`` on
the device their inputs live on. Multi-card serving is a later slice.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Optional

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim import OptConfig


@dataclasses.dataclass(frozen=True)
class StepConfig:
    """The reference's ``StepConfig``, field for field (see its comments for
    each field's meaning). The port builds only the synchronous roundpipe
    step; ``dispatch`` refuses, by name, the values it cannot run yet."""
    strategy: str = "gspmd"          # gspmd | roundpipe (the port runs roundpipe)
    grad_accum: int | str = "auto"
    accum_dtype: Any = torch.float32
    async_optimizer: bool = True
    offload_boundaries: bool = False
    sequence_parallel: bool = True
    pure_dp: bool = False
    kv_chunk: int = 1024
    xent_chunk: int = 256
    partition: Any = None
    # The reference defaults to True. Its prefetch path is bit-identical to
    # whole-block injection (same function, other transfer order), and the
    # port has only whole-block injection in this slice, so False here; the
    # prefetch slice restores True.
    prefetch: bool = False
    prefetch_chunk_limit: Optional[int] = None
    lora: Any = None
    n_microbatches: Optional[int] = None
    pool_dtype: str = "none"
    grad_compress: str = "none"
    schedule: str = "hand"
    g0: int = 0
    device_scale: Any = None
    opt: OptConfig = dataclasses.field(default_factory=OptConfig)


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
