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
by the tensors' device.

The backward is ``rwkv_scan_bwd``, the wrapper of ``csrc/rwkv_scan_bwd.cu``:
a kernel with no Pallas counterpart (the reference differentiates its jnp
scan), whose note says what bounds it and how it runs the chunks of time in
parallel without dividing by w: a local pass per chunk (its decay product,
state and adjoint from zero), a carry pass across the chunks, and a walk
from each chunk's true start and end, whose partials are added in a fixed
order (``bwd_geometry``). Its plain versions are
``ref.rwkv_scan_bwd_ref`` and ``ref.rwkv_scan_bwd_tiled_ref``. ``RwkvScan``
joins forward and backward for autograd.
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


def bwd_geometry(n: int) -> tuple[int, int]:
    """(width, chunk) of the backward's launches for head size n: the state
    width and the steps of a chunk (the local and walk passes take one (batch,
    head, chunk) a block, all N rows of the head; the carry pass crosses the
    chunks). The wrapper sizes the scratch from these and passes them on; the
    kernel refuses a chunk that is not its own."""
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


@functools.cache
def _bwd_entry():
    fn = _build.load("rwkv_scan_bwd").rwkv_scan_bwd
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 17 + [ctypes.c_int] * 5 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def rwkv_scan_bwd(r, k, v, w, u, s0, dy, ds_t=None):
    """The gradients of ``rwkv_scan`` at output gradients dy (B,S,H,N), in
    r's dtype, and ds_t (B,H,N,N) fp32 or None (zero) -> (dr, dk, dv, dw) in
    r's dtype, du (H,N) fp32, ds0 (B,H,N,N) fp32.

    Launches the backward's local, carry and walk passes and the pass that
    adds du's partials on PyTorch's current stream; raises for anything the
    kernel does not take (CPU tensors included)."""
    _build.check_tensors("rwkv_scan_bwd", r, k, v, w, dy)
    if r.ndim != 4 or any(t.shape != r.shape for t in (k, v, w, dy)):
        raise ValueError(f"rwkv_scan_bwd: r, k, v, w, dy must share one (B,S,H,N) shape, got "
                         f"{[tuple(t.shape) for t in (r, k, v, w, dy)]}")
    b, s, h, n = r.shape
    if not 1 <= n <= N_MAX:
        raise ValueError(f"rwkv_scan_bwd: head size {n} outside 1..{N_MAX}")
    for name, t in (("r", r), ("k", k), ("v", v), ("w", w), ("dy", dy)):
        if not t.is_contiguous():
            raise ValueError(f"rwkv_scan_bwd: {name} must be contiguous")
    _build.check_dense("rwkv_scan_bwd", u, torch.float32, (h, n), r.device)
    _build.check_dense("rwkv_scan_bwd", s0, torch.float32, (b, h, n, n), r.device)
    if ds_t is not None:
        _build.check_dense("rwkv_scan_bwd", ds_t, torch.float32, (b, h, n, n), r.device)
    dr, dk, dv, dw = (torch.empty_like(r) for _ in range(4))
    du = torch.empty_like(u)
    ds0 = torch.empty_like(s0)
    if b * h == 0 or s == 0:
        for t in (dr, dk, dv, dw, du):
            t.zero_()
        return dr, dk, dv, dw, du, ds0.zero_() if ds_t is None else ds0.copy_(ds_t)
    width, chunk = bwd_geometry(n)
    chunks = -(-s // chunk)
    if b * h * chunks > 2**31 - 1:
        raise ValueError(f"rwkv_scan_bwd: {b * h * chunks} (batch, head, chunk) items exceed "
                         f"the grid")
    f32 = dict(dtype=torch.float32, device=r.device)
    states = torch.empty((2, b * h, chunks, width, width), **f32)
    decay = torch.empty((b * h, chunks, width), **f32)
    du_part = torch.empty((b, chunks, h, n), **f32)
    with torch.cuda.device(r.device):   # launch on the tensors' card
        err = _bwd_entry()(_build.DTYPE_CODES[r.dtype], width, r.data_ptr(), k.data_ptr(),
                           v.data_ptr(), w.data_ptr(), u.data_ptr(), s0.data_ptr(),
                           dy.data_ptr(), None if ds_t is None else ds_t.data_ptr(),
                           states.data_ptr(), decay.data_ptr(), dr.data_ptr(), dk.data_ptr(),
                           dv.data_ptr(), dw.data_ptr(), du.data_ptr(), ds0.data_ptr(),
                           du_part.data_ptr(), b, s, h, n, chunk,
                           _build.stream_handle(r.device))
    if err:
        raise RuntimeError(f"rwkv_scan_bwd: kernel launch failed with CUDA error {err}")
    rwkv_scan_bwd.launches += 1
    return dr, dk, dv, dw, du, ds0


rwkv_scan_bwd.launches = 0


class RwkvScan(torch.autograd.Function):
    """The differentiable RWKV6 recurrence: ``forward_fn`` (the kernel on the
    card, the plain version in the CPU tests) gives y and S_T and keeps its
    inputs; ``backward_fn`` (the backward kernel, or its plain version)
    replays the states it needs from them. A gradient that never arrives
    (S_T unused) reaches the backward as None and counts as zero."""

    @staticmethod
    def forward(ctx, r, k, v, w, u, s0, forward_fn, backward_fn):
        y, s_t = forward_fn(r, k, v, w, u, s0)
        ctx.save_for_backward(r, k, v, w, u, s0)
        ctx.backward_fn = backward_fn
        ctx.set_materialize_grads(False)
        return y, s_t

    @staticmethod
    def backward(ctx, dy, ds_t):
        r, k, v, w, u, s0 = ctx.saved_tensors
        dy = torch.zeros_like(r) if dy is None else dy.to(r.dtype).contiguous()
        grads = ctx.backward_fn(r, k, v, w, u, s0, dy,
                                None if ds_t is None else ds_t.float().contiguous())
        return (*grads, None, None)
