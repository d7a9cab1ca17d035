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


def _scores(q, k, causal, sliding_window, scale):
    """fp32 scaled scores (B,KH,G,Sq,Skv) with masked entries at NEG_INF, and
    the mask itself."""
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    kv_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if sliding_window is not None:
        mask &= kv_pos > q_pos - sliding_window
    return torch.where(mask, s, torch.tensor(NEG_INF, device=q.device)), mask


def flash_attention_ref(q, k, v, *, causal=True, sliding_window=None, logit_scale=None,
                        return_lse=False):
    """q: (B,Sq,H,Dh); k,v: (B,Skv,KH,Dh|Dv) -> (B,Sq,H,Dv), and with
    ``return_lse`` also each row's log-sum-exp of its scaled scores (B,H,Sq)
    fp32.  fp32 softmax."""
    b, sq, h, dh = q.shape
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(dh)
    s, _ = _scores(q, k, causal, sliding_window, scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(b, h, sq)
    return o


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, sliding_window=None,
                            logit_scale=None):
    """The gradients (dq, dk, dv) of ``flash_attention_ref`` at output
    gradient ``do``, written out as the backward kernel computes them: P =
    exp(S - lse), dV = Pᵀ dO, dP = dO Vᵀ, D = rowsum(dO * O), dS = P (dP - D),
    dQ = scale dS K, dK = scale dSᵀ Q.  fp32 throughout; the gradients come
    back in the inputs' dtype."""
    b, sq, h, dh = q.shape
    skv, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kh
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(dh)
    s, mask = _scores(q, k, causal, sliding_window, scale)
    lse = lse.float().reshape(b, kh, g, sq)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros((), device=q.device))
    dog = do.float().reshape(b, sq, kh, g, dv)
    dvv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    dsum = (dog * o.float().reshape(b, sq, kh, g, dv)).sum(-1).permute(0, 2, 3, 1)
    ds = p * (dp - dsum[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, q.float().reshape(b, sq, kh, g, dh)) * scale
    return dq.reshape(b, sq, h, dh).to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)


def fused_xent_ref(x, w, labels, *, ignore_index=-100, return_lse=False):
    """x: (T,D); w: (D,V); labels: (T,) int -> per-token loss (T,) fp32, 0
    where the label is ``ignore_index``; with ``return_lse`` also the
    per-token log-sum-exp (T,) fp32.  Materialises the (T,V) logits."""
    logits = x.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels != ignore_index
    gold = logits.gather(1, torch.where(valid, labels, 0).long()[:, None])[:, 0]
    loss = torch.where(valid, lse - gold, torch.zeros((), device=x.device))
    return (loss, lse) if return_lse else loss


def xent_block_grad(logits, lse, labels, v0, g):
    """One vocabulary block of the cross-entropy gradient with respect to the
    logits: (softmax - onehot) * g, for logits (T,bv) of columns [v0, v0+bv),
    the rows' full log-sum-exp (T,), and g (T,) already zero on ignored
    tokens."""
    p = torch.exp(logits - lse[:, None])
    cols = torch.arange(v0, v0 + logits.shape[1], device=logits.device)
    p = p - (cols[None, :] == labels[:, None]).to(p.dtype)
    return p * g[:, None]


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
