"""Flash-decode on the card: the wrapper of ``csrc/decode_attention.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/decode_attention.py``
(``decode_attention`` -> ``_decode_kernel``). The kernel's note says what
bounds it on an H100 and how its design answers that. The plain PyTorch
version of the same function is ``ref.decode_attention_ref``;
``ops.decode_attention`` picks between the two by the tensors' device.
"""
from __future__ import annotations

import ctypes
import functools
import math

import torch

from . import _build

D_MAX = 128
G_MAX = 16


@functools.cache
def _entry():
    fn = _build.load("decode_attention").decode_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6
                   + [ctypes.c_longlong] * 8 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k_cache, v_cache, n_valid, *, logit_scale=None):
    """q: (B,H,Dh); caches: (B,S,KH,Dh) and (B,S,KH,Dv); n_valid: an int, or an
    int tensor of shape () or (B,) on the card -> (B,H,Dv).

    Launches the CUDA kernel on PyTorch's current stream; raises for anything
    the kernel does not take (CPU tensors included)."""
    _build.refuse_graph("decode_attention", q, k_cache, v_cache)
    _build.check_tensors("decode_attention", q, k_cache, v_cache)
    if q.ndim != 3 or k_cache.ndim != 4 or v_cache.ndim != 4:
        raise ValueError(f"decode_attention: q must be 3-D and the caches 4-D, got "
                         f"{tuple(q.shape)}, {tuple(k_cache.shape)}, {tuple(v_cache.shape)}")
    b, h, dh = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    dv = v_cache.shape[3]
    if (k_cache.shape[0] != b or k_cache.shape[3] != dh
            or tuple(v_cache.shape[:3]) != tuple(k_cache.shape[:3])):
        raise ValueError(f"decode_attention: shapes do not agree: q {tuple(q.shape)}, "
                         f"k {tuple(k_cache.shape)}, v {tuple(v_cache.shape)}")
    if kh < 1 or h % kh or h // kh > G_MAX:
        raise ValueError(f"decode_attention: {h} query heads over {kh} kv heads "
                         f"(at most {G_MAX} per kv head)")
    if not (1 <= dh <= D_MAX and 1 <= dv <= D_MAX):
        raise ValueError(f"decode_attention: head dims ({dh}, {dv}) outside 1..{D_MAX}")
    if s < 1:
        raise ValueError("decode_attention: empty cache")
    if isinstance(n_valid, int):
        nv = torch.full((b,), n_valid, dtype=torch.int32, device=q.device)
    else:
        if n_valid.device != q.device or n_valid.dtype not in (torch.int32, torch.int64):
            raise ValueError(f"decode_attention: n_valid must be an int tensor on "
                             f"{q.device}, got {n_valid.dtype} on {n_valid.device}")
        if n_valid.shape not in ((), (b,)):
            raise ValueError(f"decode_attention: n_valid of shape {tuple(n_valid.shape)}")
        nv = n_valid.to(torch.int32).expand(b).contiguous()
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(dh)
    out = torch.empty((b, h, dv), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    q_sb, q_sh = q.stride()[:2]
    with torch.cuda.device(q.device):   # launch on the tensors' card
        err = _entry()(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
                       v_cache.data_ptr(), nv.data_ptr(), out.data_ptr(),
                       b, s, h, kh, dh, dv, q_sb, q_sh,
                       *k_cache.stride()[:3], *v_cache.stride()[:3], float(scale),
                       _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"decode_attention: kernel launch failed with CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
