"""The RWKV6 recurrence on the card: the wrapper of ``csrc/rwkv_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/rwkv_scan.py`` (``rwkv_scan``
-> ``_rwkv_kernel``). The kernel's note says what bounds it on an H100 (shared
loads and fp32 issue, with the bytes as the bound) and how its design answers
that: the state in tiles of N/8 rows x 4 columns a thread, 2 N threads a
(batch, head), Σ r u k formed once a step, chunks of 32 steps staged by
double-buffered 16-byte ``cp.async`` copies (``geometry``). The plain PyTorch
version of the same function is ``ref.rwkv_scan_ref``, and
``ref.rwkv_scan_tiled_ref`` follows the kernel's split of the state and its
order of sums; ``ops.rwkv_scan`` picks between the kernel and the plain version
by the tensors' device. Forward only: the reference has no backward kernel
either (it differentiates its jnp scan).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

N_MAX = 64


def geometry(n: int) -> tuple[int, int]:
    """(width, chunk) of the kernel's launch for head size n: the state width
    the kernel computes at (``ref.scan_width``) and the time steps it stages a
    pass. The kernel refuses a pair it does not build."""
    return ref.scan_width(n), 32


@functools.cache
def _entry():
    fn = _build.load("rwkv_scan").rwkv_scan
    fn.argtypes = ([ctypes.c_int] * 3 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def rwkv_scan(r, k, v, w, u, s0):
    """r, k, v, w: (B,S,H,N), one dtype (float32 or bfloat16); u: (H,N) fp32;
    s0: (B,H,N,N) fp32 -> (y (B,S,H,N) in r's dtype, S_T (B,H,N,N) fp32).

    Launches the CUDA kernel on PyTorch's current stream; raises for anything
    the kernel does not take (CPU tensors included)."""
    _build.refuse_graph("rwkv_scan", r, k, v, w, u, s0)
    _build.check_tensors("rwkv_scan", r, k, v, w)
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w)):
        raise ValueError(f"rwkv_scan: r, k, v, w must share one (B,S,H,N) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w)]}")
    b, s, h, n = r.shape
    if not 1 <= n <= N_MAX:
        raise ValueError(f"rwkv_scan: head size {n} outside 1..{N_MAX}")
    if b * h > 2**31 - 1:
        raise ValueError(f"rwkv_scan: {b * h} (batch, head) pairs exceed the grid")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w)):
        if not t.is_contiguous():
            raise ValueError(f"rwkv_scan: {name} must be contiguous")
    _build.check_dense("rwkv_scan", u, torch.float32, (h, n), r.device)
    _build.check_dense("rwkv_scan", s0, torch.float32, (b, h, n, n), r.device)
    y = torch.empty_like(r)
    s_t = torch.empty_like(s0)
    if b * h == 0:
        return y, s_t
    if s == 0:
        return y, s_t.copy_(s0)
    pack = 16 // r.element_size()
    vec = n % pack == 0 and all(t.data_ptr() % 16 == 0 for t in (r, k, v, w, y))
    width, chunk = geometry(n)
    with torch.cuda.device(r.device):   # launch on the tensors' card
        err = _entry()(_build.DTYPE_CODES[r.dtype], width, chunk, r.data_ptr(),
                       k.data_ptr(), v.data_ptr(), w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                       y.data_ptr(), s_t.data_ptr(), b, s, h, n, int(vec),
                       _build.stream_handle(r.device))
    if err:
        raise RuntimeError(f"rwkv_scan: kernel launch failed with CUDA error {err}")
    rwkv_scan.launches += 1
    return y, s_t


rwkv_scan.launches = 0
