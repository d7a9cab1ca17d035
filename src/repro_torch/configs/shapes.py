"""Reduced smoke configs (same family, laptop-runnable).

``smoke_config`` is copied from ``repro/configs/shapes.py``; the rest of that
module (the assigned input shapes and their abstract specs) is JAX-specific
and not part of the port.
"""
from __future__ import annotations

import dataclasses

from repro_torch.models.config import ModelConfig, get_config


def smoke_config(cfg_or_name) -> ModelConfig:
    cfg = cfg_or_name if isinstance(cfg_or_name, ModelConfig) else get_config(cfg_or_name)
    kv = 0 if cfg.n_kv_heads == 0 else (1 if cfg.n_kv_heads == 1 else 2)
    heads = 0 if cfg.n_heads == 0 else 4
    return dataclasses.replace(
        cfg,
        name=cfg.name + "-smoke",
        n_layers=2,
        d_model=64,
        n_heads=heads,
        n_kv_heads=kv if not cfg.encoder_only else heads,
        d_head=16 if cfg.n_heads else cfg.d_head,
        d_ff=96 if not cfg.is_moe else 48,
        vocab_size=128,
        kv_lora_rank=16 if cfg.kv_lora_rank else 0,
        qk_rope_dim=8 if cfg.attn_kind == "mla" else cfg.qk_rope_dim,
        v_head_dim=16 if cfg.attn_kind == "mla" else None,
        n_experts=4 if cfg.is_moe else 0,
        experts_per_token=2 if cfg.is_moe else 0,
        n_shared_experts=min(cfg.n_shared_experts, 1),
        moe_d_ff=48 if cfg.is_moe else 0,
        # no-drop capacity at smoke scale (cf >= E/k) so teacher-forced forward
        # == incremental decode exactly; capacity dropping is tested separately
        capacity_factor=4.0 if cfg.is_moe else cfg.capacity_factor,
        sliding_window=8 if cfg.sliding_window else None,
        ssm_state=8 if cfg.ssm_state else 0,
    )
