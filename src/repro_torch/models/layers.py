"""Transformer building blocks: norms, RoPE, attention, MLPs.

The PyTorch counterpart of ``repro/models/layers.py``: plain functions over
tensors and parameter dicts, computing what the reference computes, with the
same rounding points (the cast to the input dtype in a norm comes before the
multiply by ``scale``). The two attention functions go through the kernel
entries of ``repro_torch.kernels.ops``, which run the hand-written kernels on
the card and their plain versions on the CPU.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops


# ---------------------------------------------------------------------------
# Norms
# ---------------------------------------------------------------------------

def rms_norm(x, scale, eps=1e-5):
    var = x.float().square().mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps)).to(x.dtype) * scale


def layer_norm(x, scale, bias, eps=1e-5):
    xf = x.float()
    mu = xf.mean(dim=-1, keepdim=True)
    var = xf.var(dim=-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps)).to(x.dtype) * scale + bias


def apply_norm(x, params, kind, eps=1e-5):
    if kind == "rmsnorm":
        return rms_norm(x, params["scale"], eps)
    return layer_norm(x, params["scale"], params["bias"], eps)


def init_norm(d, kind, dtype=torch.float32, device="cuda"):
    p = {"scale": torch.ones((d,), dtype=dtype, device=device)}
    if kind == "layernorm":
        p["bias"] = torch.zeros((d,), dtype=dtype, device=device)
    return p


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------

def rope_frequencies(d_head: int, theta: float, device="cuda"):
    exponent = torch.arange(0, d_head, 2, dtype=torch.float32, device=device) / d_head
    return 1.0 / (theta ** exponent)


def apply_rope(x, positions, theta=10_000.0):
    """x: (..., S, H, D) with D even; positions: broadcastable to (..., S).

    Rotates the two halves of each head, not interleaved pairs, as the
    reference does."""
    d = x.shape[-1]
    freqs = rope_frequencies(d, theta, x.device)                       # (D/2,)
    angles = positions[..., None].to(torch.float32) * freqs             # (..., S, D/2)
    cos = torch.cos(angles)[..., None, :]                               # (..., S, 1, D/2)
    sin = torch.sin(angles)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention
# ---------------------------------------------------------------------------

def chunked_attention(q, k, v, *, causal=True, sliding_window=None, q_offset=0,
                      logit_scale=None):
    """q: (B,Sq,H,Dh); k,v: (B,Skv,KH,Dh|Dv) -> (B,Sq,H,Dv).

    The reference scans kv chunks in jnp to bound memory; here the flash
    kernel tiles by itself, so there is no chunk size. Like the TPU kernel,
    it takes queries that start at position 0 only."""
    if q_offset != 0:
        raise NotImplementedError(
            "chunked_attention: q_offset != 0 (prefill continuation) is not supported "
            "by the flash kernel")
    return ops.flash_attention(q, k, v, causal=causal, sliding_window=sliding_window,
                               logit_scale=logit_scale)


def decode_attention(q, k_cache, v_cache, cache_len, *, logit_scale=None):
    """Single-token attention against a (possibly ring-buffered) KV cache.

    q: (B,1,H,Dh); caches: (B,S,KH,Dh|Dv); ``cache_len`` (an int, or an int
    tensor of shape () or (B,)) is the number of valid entries. Returns
    (B,1,H,Dv). The reference's optional sliding-window mask is not ported:
    the model keeps a window-sized ring instead and never passes one."""
    b, _, h, dh = q.shape
    out = ops.decode_attention(q.reshape(b, h, dh), k_cache, v_cache, cache_len,
                               logit_scale=logit_scale)
    return out.reshape(b, 1, h, v_cache.shape[-1])


# ---------------------------------------------------------------------------
# Dense MLPs
# ---------------------------------------------------------------------------

def mlp(x, p, kind):
    if kind == "swiglu":
        return (F.silu(x @ p["w_gate"]) * (x @ p["w_up"])) @ p["w_down"]
    # jax.nn.gelu defaults to the tanh approximation
    if kind == "geglu":
        return (F.gelu(x @ p["w_gate"], approximate="tanh") * (x @ p["w_up"])) @ p["w_down"]
    if kind == "relu2":
        return torch.square(F.relu(x @ p["w_up"])) @ p["w_down"]
    if kind == "gelu":
        return F.gelu(x @ p["w_up"], approximate="tanh") @ p["w_down"]
    raise ValueError(kind)


def init_normal(shape, scale, generator, dtype, device):
    return (torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
            * scale).to(dtype)


def init_mlp(generator, d, d_ff, kind, dtype, device="cuda"):
    """Weights are (in, out), as in the reference; x @ w applies them."""
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(d_ff)
    p = {"w_up": init_normal((d, d_ff), sc_in, generator, dtype, device),
         "w_down": init_normal((d_ff, d), sc_out, generator, dtype, device)}
    if kind in ("swiglu", "geglu"):
        p["w_gate"] = init_normal((d, d_ff), sc_in, generator, dtype, device)
    return p
