"""Prefill attention on the card: the wrapper of ``csrc/flash_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/flash_attention.py``
(``flash_attention`` -> ``_flash_kernel``). The kernel's note says what bounds
it on an H100 and how its design answers that. The plain PyTorch version of
the same function is ``ref.flash_attention_ref``; ``ops.flash_attention``
picks between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

D_MAX = 128


@functools.cache
def _entry():
    fn = _build.load("flash_attention").flash_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 4 + [ctypes.c_int] * 7
                   + [ctypes.c_longlong] * 9
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def flash_attention(q, k, v, *, causal=True, sliding_window=None, logit_scale=None):
    """q: (B,Sq,H,Dh); k: (B,Skv,KH,Dh); v: (B,Skv,KH,Dv) -> (B,Sq,H,Dv).

    Launches the CUDA kernel on PyTorch's current stream; raises for anything
    the kernel does not take (CPU tensors included)."""
    _build.check_tensors("flash_attention", q, k, v)
    if q.ndim != 4 or k.ndim != 4 or v.ndim != 4:
        raise ValueError(f"flash_attention: q, k, v must be 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    dv = v.shape[3]
    if k.shape[0] != b or k.shape[3] != dh or tuple(v.shape[:3]) != tuple(k.shape[:3]):
        raise ValueError(f"flash_attention: shapes do not agree: q {tuple(q.shape)}, "
                         f"k {tuple(k.shape)}, v {tuple(v.shape)}")
    if kh < 1 or h % kh:
        raise ValueError(f"flash_attention: {h} query heads over {kh} kv heads")
    if not (1 <= dh <= D_MAX and 1 <= dv <= D_MAX):
        raise ValueError(f"flash_attention: head dims ({dh}, {dv}) outside 1..{D_MAX}")
    if skv < 1:
        raise ValueError("flash_attention: empty key sequence")
    if sliding_window is not None and sliding_window < 1:
        raise ValueError(f"flash_attention: sliding_window {sliding_window} < 1")
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    with torch.cuda.device(q.device):   # launch on the tensors' card
        err = _entry()(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(), v.data_ptr(),
                       out.data_ptr(), b, sq, skv, h, kh, dh, dv,
                       *q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                       int(causal), sliding_window or 0, float(scale),
                       _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"flash_attention: kernel launch failed with CUDA error {err}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0
