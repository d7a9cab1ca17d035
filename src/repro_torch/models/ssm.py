"""State-space / linear-recurrence blocks: Mamba selective scan (Hymba's SSM
heads) and RWKV6 "Finch" time-mix with data-dependent decay.

The PyTorch counterpart of ``repro/models/ssm.py``, with the reference's
parameter names, shapes, scales and state layouts. Each block has a
full-sequence path (prefill: ``*_seq``) and a single-token path (decode:
``*_step``) over an explicit recurrent state. The reference runs both
recurrences as jnp ``lax.scan``s and trains through their autodiff; the
port sends them through the kernel entries ``ops.ssm_scan`` and
``ops.rwkv_scan`` (hand-written CUDA kernels on the card, their plain
versions on the CPU), which compute the same functions with the same
argument layouts and are differentiable: on the card through each scan's
forward and backward kernels. Everything around them is plain PyTorch, as
the reference's is jnp, with the casts written out where JAX promotes types
by itself.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.kernels import ops

from .layers import init_normal, rms_norm

CONV_W = 4          # mamba depthwise conv window
DECAY_RANK = 32     # rwkv6 low-rank data-dependent decay
RWKV_HEAD = 64


def _init_uniform(shape, generator, dtype, device):
    return torch.rand(shape, generator=generator, dtype=torch.float32, device=device).to(dtype)


# ---------------------------------------------------------------------------
# Mamba selective scan
# ---------------------------------------------------------------------------

def init_mamba(generator, d_model, d_inner, n_state, dtype, device="cuda"):
    sc = 1.0 / math.sqrt(d_model)
    return {
        "w_in": init_normal((d_model, 2 * d_inner), sc, generator, dtype, device),
        "conv": init_normal((CONV_W, d_inner), 0.5, generator, dtype, device),
        "w_bcdt": init_normal((d_inner, 2 * n_state + 1), 1.0 / math.sqrt(d_inner), generator,
                              dtype, device),
        "dt_bias": torch.zeros((1,), dtype=dtype, device=device),
        "a_log": torch.zeros((d_inner, n_state), dtype=torch.float32, device=device),
        "d_skip": torch.ones((d_inner,), dtype=dtype, device=device),
        "w_out": init_normal((d_inner, d_model), 1.0 / math.sqrt(d_inner), generator, dtype,
                             device),
    }


def _mamba_inner(xz, p, n_state, h0, conv_state):
    """xz: (B,S,2*Di) post-in_proj.  Returns (y (B,S,Di) fp32, h_T, conv_state_T).

    y stays fp32, as the reference's scan output does: the kernel writes it
    in fp32, and ``y + x * d_skip`` and ``y * silu(z)`` promote to fp32 in
    PyTorch as in JAX."""
    x, z = xz.chunk(2, dim=-1)                                # (B,S,Di)
    s = x.shape[1]
    # depthwise causal conv over time
    xp = torch.cat([conv_state, x], dim=1)                    # (B, S+W-1, Di)
    conv_out = sum(xp[:, i:i + s] * p["conv"][i] for i in range(CONV_W))
    x = F.silu(conv_out)
    bcdt = x @ p["w_bcdt"]                                    # (B,S,2N+1)
    bmat = bcdt[..., :n_state].contiguous()
    cmat = bcdt[..., n_state:2 * n_state].contiguous()
    dt = F.softplus(bcdt[..., -1:] + p["dt_bias"]).contiguous()   # (B,S,1)
    a = -torch.exp(p["a_log"].float())                        # (Di,N) fp32
    y, h_t = ops.ssm_scan(x.contiguous(), dt, bmat, cmat, a, h0, out_dtype=torch.float32)
    y = y + x * p["d_skip"]
    y = y * F.silu(z)
    new_conv_state = xp[:, -(CONV_W - 1):] if CONV_W > 1 else conv_state
    return y, h_t, new_conv_state


def mamba_seq(x, p, n_state):
    """x: (B,S,D) -> (B,S,D); fresh state (prefill).  Returns (out, (h_T,
    conv_state_T))."""
    b = x.shape[0]
    di = p["w_in"].shape[1] // 2
    h0 = torch.zeros((b, di, n_state), dtype=torch.float32, device=x.device)
    conv0 = torch.zeros((b, CONV_W - 1, di), dtype=x.dtype, device=x.device)
    y, h_t, conv_t = _mamba_inner(x @ p["w_in"], p, n_state, h0, conv0)
    # fp32 y @ a bf16 weight: JAX promotes the product to fp32
    return (y @ p["w_out"].to(y.dtype)).to(x.dtype), (h_t, conv_t)


def mamba_step(x, p, n_state, state):
    """x: (B,1,D); state = (h, conv_state) -> (y, new_state)."""
    h, conv = state
    y, h_t, conv_t = _mamba_inner(x @ p["w_in"], p, n_state, h, conv)
    return (y @ p["w_out"].to(y.dtype)).to(x.dtype), (h_t, conv_t)


def mamba_state_shape(batch, d_inner, n_state, dtype=torch.bfloat16):
    """((shape, dtype) of h, (shape, dtype) of the conv state)."""
    return (((batch, d_inner, n_state), torch.float32),
            ((batch, CONV_W - 1, d_inner), dtype))


# ---------------------------------------------------------------------------
# RWKV6 (Finch)
# ---------------------------------------------------------------------------

def init_rwkv6(generator, d_model, d_ff, dtype, device="cuda"):
    d, r = d_model, DECAY_RANK
    sc = 1.0 / math.sqrt(d)

    def normal(shape, scale):
        return init_normal(shape, scale, generator, dtype, device)

    return {
        "time": {
            "mu": _init_uniform((5, d), generator, dtype, device),   # r,k,v,g,w shifts
            "w_r": normal((d, d), sc),
            "w_k": normal((d, d), sc),
            "w_v": normal((d, d), sc),
            "w_g": normal((d, d), sc),
            "w_o": normal((d, d), sc),
            "decay_a": normal((d, r), sc),
            "decay_b": normal((r, d), 1.0 / math.sqrt(r)),
            "w0": torch.full((d,), -6.0, dtype=torch.float32, device=device),  # base decay
            "u": torch.zeros((d,), dtype=torch.float32, device=device),        # first-token bonus
            "ln_x": torch.ones((d,), dtype=dtype, device=device),
        },
        "channel": {
            "mu": _init_uniform((2, d), generator, dtype, device),   # r,k shifts
            "w_r": normal((d, d), sc),
            "w_k": normal((d, d_ff), sc),
            "w_v": normal((d_ff, d), 1.0 / math.sqrt(d_ff)),
        },
    }


def _rwkv_time_mix(x, x_prev, p):
    """Project one token group.  x,x_prev: (B,S,D) with x_prev = shift(x)."""
    mu = p["mu"]

    def lerp(i):
        return x + mu[i] * (x_prev - x)

    r = lerp(0) @ p["w_r"]
    k = lerp(1) @ p["w_k"]
    v = lerp(2) @ p["w_v"]
    g = F.silu(lerp(3) @ p["w_g"])
    # data-dependent decay (Finch): w = exp(-exp(w0 + lora(x_w))), in fp32:
    # w is ~0.9975 and bf16 cannot hold it
    wx = torch.tanh(lerp(4) @ p["decay_a"]) @ p["decay_b"]
    w = torch.exp(-torch.exp(p["w0"] + wx.float()))          # (B,S,D) in (0,1)
    return r, k, v, g, w


def rwkv6_time_seq(x, p, x_last=None, s0=None):
    """Full-sequence time-mix.  x: (B,S,D).  Returns (out, (x_T, S_T))."""
    b, s, d = x.shape
    h, n = d // RWKV_HEAD, RWKV_HEAD
    if x_last is None:
        x_last = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
    x_prev = torch.cat([x_last, x[:, :-1]], dim=1)
    r, k, v, g, w = _rwkv_time_mix(x, x_prev, p)
    rh, kh, vh, wh = (t.reshape(b, s, h, n).float().contiguous() for t in (r, k, v, w))
    if s0 is None:
        s0 = torch.zeros((b, h, n, n), dtype=torch.float32, device=x.device)
    u = p["u"].reshape(h, n).float()
    y, s_t = ops.rwkv_scan(rh, kh, vh, wh, u, s0)
    y = y.reshape(b, s, d).to(x.dtype)
    y = rms_norm(y, p["ln_x"]) * g
    return y @ p["w_o"], (x[:, -1:], s_t)


def rwkv6_channel_seq(x, p, x_last=None):
    b, s, d = x.shape
    if x_last is None:
        x_last = torch.zeros((b, 1, d), dtype=x.dtype, device=x.device)
    x_prev = torch.cat([x_last, x[:, :-1]], dim=1)
    mu = p["mu"]
    xr = x + mu[0] * (x_prev - x)
    xk = x + mu[1] * (x_prev - x)
    k = torch.square(F.relu(xk @ p["w_k"]))
    return torch.sigmoid(xr @ p["w_r"]) * (k @ p["w_v"]), x[:, -1:]


def rwkv6_state_shape(batch, d_model, dtype=torch.bfloat16):
    """{leaf: (shape, dtype)} of one layer's recurrent state."""
    h = d_model // RWKV_HEAD
    return {
        "time_x": ((batch, 1, d_model), dtype),
        "time_s": ((batch, h, RWKV_HEAD, RWKV_HEAD), torch.float32),
        "chan_x": ((batch, 1, d_model), dtype),
    }
