"""Attention on the card: the wrappers of ``csrc/flash_attention.cu`` (forward)
and ``csrc/flash_attention_bwd.cu`` (backward), and the autograd Function that
joins them.

The forward replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` -> ``_flash_kernel``). The backward has no Pallas
counterpart: the reference differentiates its jnp ``chunked_attention``. Each
kernel's note says what bounds it on an H100 and how its design answers that.
The plain PyTorch versions are ``ref.flash_attention_ref`` and
``ref.flash_attention_bwd_ref``; ``ops.flash_attention`` picks between plain
and kernel by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

D_MAX = 128


@functools.cache
def _fwd_entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _bwd_entry():
    fn = _build.load("flash_attention_bwd").flash_attention_bwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 11 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def _check(name, q, k, v, sliding_window):
    """Shapes (B,Sq,H,Dh), (B,Skv,KH,Dh), (B,Skv,KH,Dv) the kernels take."""
    _build.check_tensors(name, q, k, v)
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"{name}: q, k, v must be 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, _, h, dh = q.shape
    kh = k.shape[2]
    dv = v.shape[3]
    if k.shape[0] != b or k.shape[3] != dh or tuple(v.shape[:3]) != tuple(k.shape[:3]):
        raise ValueError(f"{name}: shapes do not agree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if kh < 1 or h % kh:
        raise ValueError(f"{name}: {h} query heads over {kh} kv heads")
    if not (1 <= dh <= D_MAX and 1 <= dv <= D_MAX):
        raise ValueError(f"{name}: head dims ({dh}, {dv}) outside 1..{D_MAX}")
    if k.shape[1] < 1:
        raise ValueError(f"{name}: empty key sequence")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"{name}: sliding_window {sliding_window} < 1")


def flash_attention(q, k, v, *, causal=True, sliding_window=None, logit_scale=None,
                    return_lse=False):
    """q: (B,Sq,H,Dh); k: (B,Skv,KH,Dh); v: (B,Skv,KH,Dv) -> (B,Sq,H,Dv), and
    with ``return_lse`` also each row's fp32 log-sum-exp of its scaled scores,
    (B,H,Sq).

    Launches the forward kernel on PyTorch's current stream; raises for
    anything the kernel does not take (CPU tensors included). Computes values
    only: ``FlashAttention`` is the differentiable form."""
    _build.refuse_graph("flash_attention", q, k, v)
    _check("flash_attention", q, k, v, sliding_window)
    b, sq, h, dh = q.shape
    skv, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        return (out, lse) if return_lse else out
    with torch.cuda.device(q.device):   # launch on the tensors' card
        err = _fwd_entry()(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                           v.data_ptr(), out.data_ptr(),
                           lse.data_ptr() if return_lse else None,
                           b, sq, skv, h, kh, dh, dv,
                           *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                           int(causal), sliding_window or 0, float(scale),
                           _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, sliding_window=None,
                        logit_scale=None):
    """The gradients (dq, dk, dv) of ``flash_attention`` at output gradient
    ``do``, from the forward's output ``o`` and log-sum-exp ``lse`` (B,H,Sq)
    fp32. q, k, v, o and do may be strided with a dense last dimension; the
    gradients come back dense in the inputs' dtype.

    Launches the backward kernel (a pre-pass, the main pass and a cast of
    dq) on PyTorch's current stream; raises for anything it does not take."""
    _check("flash_attention_bwd", q, k, v, sliding_window)
    _build.check_tensors("flash_attention_bwd", q, o, do)
    b, sq, h, dh = q.shape
    skv, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(o.shape) != (b, sq, h, dv) or tuple(do.shape) != (b, sq, h, dv):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do {tuple(do.shape)} "
                         f"must be {(b, sq, h, dv)}")
    _build.check_dense("flash_attention_bwd", lse, torch.float32, (b, h, sq), q.device)
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(dh)
    dq = torch.empty((b, sq, h, dh), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, kh, dh), dtype=q.dtype, device=q.device)
    dvv = torch.empty((b, skv, kh, dv), dtype=q.dtype, device=q.device)
    if sq == 0 or b == 0:
        return dq, dk.zero_(), dvv.zero_()
    dsum = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    dq_acc = torch.zeros((b, sq, h, dh), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 15)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *o.stride()[:3], *do.stride()[:3])
    with torch.cuda.device(q.device):
        err = _bwd_entry()(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                           v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                           dsum.data_ptr(), dq_acc.data_ptr(), dq.data_ptr(), dk.data_ptr(),
                           dvv.data_ptr(), b, sq, skv, h, kh, dh, dv, strides, int(causal),
                           sliding_window or 0, float(scale), _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"flash_attention_bwd: kernel launch failed with CUDA error {err}")
    flash_attention_bwd.launches += 1
    return dq, dk, dvv


flash_attention_bwd.launches = 0


class FlashAttention(torch.autograd.Function):
    """Differentiable flash attention on the card: the forward kernel saves
    its output and log-sum-exp, the backward kernel recomputes the
    probabilities from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, sliding_window, logit_scale):
        o, lse = flash_attention(q, k, v, causal=causal, sliding_window=sliding_window,
                                 logit_scale=logit_scale, return_lse=True)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.opts = dict(causal=causal, sliding_window=sliding_window, logit_scale=logit_scale)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        if do.stride(-1) != 1:
            do = do.contiguous()
        dq, dk, dv = flash_attention_bwd(q, k, v, o, lse, do, **ctx.opts)
        return dq, dk, dv, None, None, None
