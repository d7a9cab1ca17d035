"""Plain PyTorch versions of the ported kernels (the allclose targets).

Deliberately naive, as ``repro/kernels/ref.py``: everything is materialised
and the math is fp32. They define correctness, not speed. The CPU path of
``ops`` runs them, and ``chip_smoke.py`` holds each kernel against them on
the card.
"""
from __future__ import annotations

import math

import torch

NEG_INF = -1e30


def flash_attention_ref(q, k, v, *, causal=True, sliding_window=None, logit_scale=None):
    """q: (B,Sq,H,Dh); k,v: (B,Skv,KH,Dh|Dv) -> (B,Sq,H,Dv).  fp32 softmax."""
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, sq, kh, g, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    kv_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if sliding_window is not None:
        mask &= kv_pos > q_pos - sliding_window
    s = torch.where(mask, s, torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)


def decode_attention_ref(q, k_cache, v_cache, n_valid, *, logit_scale=None):
    """q: (B,H,Dh); caches: (B,S,KH,Dh|Dv); n_valid: an int, or an int tensor
    of shape () or (B,) -> (B,H,Dv).

    The output is reshaped with Dv. ``repro/kernels/ref.py`` reshapes it with
    Dh, which fails when Dv != Dh; no test compares the two there."""
    b, h, dh = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, kh, g, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    nv = torch.as_tensor(n_valid, device=q.device).reshape(-1, 1).expand(b, 1)
    valid = torch.arange(s, device=q.device)[None, :] < nv
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(b, h, v_cache.shape[-1]).to(q.dtype)
