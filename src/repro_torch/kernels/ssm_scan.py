"""The Mamba selective scan on the card: the wrapper of ``csrc/ssm_scan.cu``.

Replaces the Pallas TPU kernel ``repro/kernels/ssm_scan.py`` (``ssm_scan`` ->
``_ssm_kernel``). The kernel's note says what bounds it on an H100 (the
dependent issue of its step loop, once every device-memory access has left
it) and how its design answers that: each channel's state split over 4
lanes, 16 channels (two warps) a block, chunks of 64 steps (32 at N > 32)
staged by double-buffered 16-byte ``cp.async`` copies (``geometry``), the
decay as one ``ex2.approx`` of dt A log2 e. Unlike the Pallas kernel, it takes
any ``d_inner`` (the last channel block is masked) and any sequence length,
and it can write y in another type than x's (``out_dtype``): the model keeps
y in fp32, as the reference's jnp scan does. The plain PyTorch version of the
same function is ``ref.ssm_scan_ref``, and ``ref.ssm_scan_tiled_ref`` follows
the kernel's split of the state and its order of sums; ``ops.ssm_scan`` picks
between the kernel and the plain version by the tensors' device.

The backward is ``ssm_scan_bwd``, the wrapper of ``csrc/ssm_scan_bwd.cu``: a
kernel with no Pallas counterpart (the reference differentiates its jnp
scan), whose note says what bounds it and how it gets h_{t-1} and g_t at the
same step without dividing by the decay (chunk checkpoints and replays,
blocks of channels, partials added in a fixed order: ``bwd_geometry``). Its
plain versions are ``ref.ssm_scan_bwd_ref`` and ``ref.ssm_scan_bwd_tiled_ref``.
``SsmScan`` joins forward and backward for autograd.
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build, ref

N_MAX = 64


def geometry(n: int) -> tuple[int, int]:
    """(width, chunk) of the kernel's launch for state size n: the state width
    the kernel computes at (``ref.scan_width``) and the time steps it stages a
    pass (32 at width 64, where 64 would pass 48 KB of static shared memory).
    The kernel refuses a pair it does not build."""
    width = ref.scan_width(n)
    return width, 32 if width == 64 else 64


def bwd_geometry(n: int) -> tuple[int, int, int]:
    """(width, chunk, channels) of the backward's launch for state size n:
    the state width, the steps between checkpoints, and the channels of a
    block (width / 4 lanes a channel, 4 entries a lane, 128 threads a block).
    The wrapper sizes the scratch from these and passes them on; the kernel
    refuses any that are not its own."""
    width = ref.scan_width(n)
    return width, 32, 128 // (width // 4)


@functools.cache
def _entry():
    fn = _build.load("ssm_scan").ssm_scan
    fn.argtypes = ([ctypes.c_int] * 4 + [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5
                   + [ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def ssm_scan(x, dt, bmat, cmat, a, h0, *, out_dtype=None):
    """x: (B,S,Di); dt: (B,S,1); bmat, cmat: (B,S,N), one dtype (float32 or
    bfloat16); a: (Di,N) fp32; h0: (B,Di,N) fp32 -> (y (B,S,Di) in
    ``out_dtype``, x's dtype by default, h_T (B,Di,N) fp32).

    Launches the CUDA kernel on PyTorch's current stream; raises for anything
    the kernel does not take (CPU tensors included)."""
    _build.refuse_graph("ssm_scan", x, dt, bmat, cmat, a, h0)
    _build.check_tensors("ssm_scan", x, dt, bmat, cmat)
    out_dtype = out_dtype or x.dtype
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"ssm_scan: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if x.ndim != 3:
        raise ValueError(f"ssm_scan: x must be (B,S,Di), got {tuple(x.shape)}")
    b, s, di = x.shape
    n = bmat.shape[-1] if bmat.ndim == 3 else -1
    if (tuple(dt.shape) != (b, s, 1) or tuple(bmat.shape) != (b, s, n)
            or tuple(cmat.shape) != (b, s, n)):
        raise ValueError(f"ssm_scan: shapes do not agree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, B {tuple(bmat.shape)}, C {tuple(cmat.shape)}")
    if not 1 <= n <= N_MAX:
        raise ValueError(f"ssm_scan: state size {n} outside 1..{N_MAX}")
    if b > 65535:
        raise ValueError(f"ssm_scan: batch {b}; the kernel's grid takes at most 65535")
    for name, t in (("x", x), ("dt", dt), ("B", bmat), ("C", cmat)):
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan: {name} must be contiguous")
    _build.check_dense("ssm_scan", a, torch.float32, (di, n), x.device)
    _build.check_dense("ssm_scan", h0, torch.float32, (b, di, n), x.device)
    y = torch.empty((b, s, di), dtype=out_dtype, device=x.device)
    h_t = torch.empty_like(h0)
    if b * di == 0:
        return y, h_t
    if s == 0:
        return y, h_t.copy_(h0)
    width, chunk = geometry(n)
    pack = 16 // x.element_size()
    vec = di % pack == 0 and n % pack == 0 and all(t.data_ptr() % 16 == 0
                                                   for t in (x, bmat, cmat))
    with torch.cuda.device(x.device):   # launch on the tensors' card
        err = _entry()(_build.DTYPE_CODES[x.dtype], _build.DTYPE_CODES[out_dtype], width,
                       chunk, x.data_ptr(), dt.data_ptr(), bmat.data_ptr(),
                       cmat.data_ptr(), a.data_ptr(), h0.data_ptr(), y.data_ptr(),
                       h_t.data_ptr(), b, s, di, n, int(vec), _build.stream_handle(x.device))
    if err:
        raise RuntimeError(f"ssm_scan: kernel launch failed with CUDA error {err}")
    ssm_scan.launches += 1
    return y, h_t


ssm_scan.launches = 0


@functools.cache
def _bwd_entry():
    fn = _build.load("ssm_scan_bwd").ssm_scan_bwd
    fn.argtypes = [ctypes.c_int] * 2 + [ctypes.c_void_p] * 17 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def ssm_scan_bwd(x, dt, bmat, cmat, a, h0, dy, dh_t=None):
    """The gradients of ``ssm_scan`` at output gradients dy (B,S,Di), any
    float type (the kernel reads it in fp32), and dh_t (B,Di,N) fp32 or None
    (zero) -> (dx, ddt, dB, dC) in x's dtype, da (Di,N) fp32, dh0 (B,Di,N)
    fp32.

    Launches the backward kernel and the pass that adds its partials on
    PyTorch's current stream; raises for anything the kernel does not take
    (CPU tensors included)."""
    _build.check_tensors("ssm_scan_bwd", x, dt, bmat, cmat)
    if x.ndim != 3:
        raise ValueError(f"ssm_scan_bwd: x must be (B,S,Di), got {tuple(x.shape)}")
    b, s, di = x.shape
    n = bmat.shape[-1] if bmat.ndim == 3 else -1
    if (tuple(dt.shape) != (b, s, 1) or tuple(bmat.shape) != (b, s, n)
            or tuple(cmat.shape) != (b, s, n) or tuple(dy.shape) != (b, s, di)):
        raise ValueError(f"ssm_scan_bwd: shapes do not agree: x {tuple(x.shape)}, dt "
                         f"{tuple(dt.shape)}, B {tuple(bmat.shape)}, C {tuple(cmat.shape)}, "
                         f"dy {tuple(dy.shape)}")
    if not 1 <= n <= N_MAX:
        raise ValueError(f"ssm_scan_bwd: state size {n} outside 1..{N_MAX}")
    if b > 65535:
        raise ValueError(f"ssm_scan_bwd: batch {b}; the kernel's grid takes at most 65535")
    for name, t in (("x", x), ("dt", dt), ("B", bmat), ("C", cmat)):
        if not t.is_contiguous():
            raise ValueError(f"ssm_scan_bwd: {name} must be contiguous")
    if dy.device != x.device:
        raise ValueError(f"ssm_scan_bwd: dy on {dy.device}, x on {x.device}")
    dy = dy.float().contiguous()
    _build.check_dense("ssm_scan_bwd", a, torch.float32, (di, n), x.device)
    _build.check_dense("ssm_scan_bwd", h0, torch.float32, (b, di, n), x.device)
    if dh_t is not None:
        _build.check_dense("ssm_scan_bwd", dh_t, torch.float32, (b, di, n), x.device)
    dx, ddt, db, dc = (torch.empty_like(t) for t in (x, dt, bmat, cmat))
    da = torch.empty_like(a)
    dh0 = torch.empty_like(h0)
    if b * di == 0 or s == 0:
        for t in (dx, ddt, db, dc, da):
            t.zero_()
        return dx, ddt, db, dc, da, dh0.zero_() if dh_t is None else dh0.copy_(dh_t)
    width, chunk, channels = bwd_geometry(n)
    nblk = -(-di // channels)
    f32 = dict(dtype=torch.float32, device=x.device)
    ckpt = torch.empty((b, -(-s // chunk), nblk * channels, width), **f32)
    part = torch.empty((nblk, b, s, 2 * n + 1), **f32)
    da_part = torch.empty((b, di, n), **f32)
    with torch.cuda.device(x.device):   # launch on the tensors' card
        err = _bwd_entry()(_build.DTYPE_CODES[x.dtype], width, x.data_ptr(), dt.data_ptr(),
                           bmat.data_ptr(), cmat.data_ptr(), a.data_ptr(), h0.data_ptr(),
                           dy.data_ptr(), None if dh_t is None else dh_t.data_ptr(),
                           ckpt.data_ptr(), dx.data_ptr(), ddt.data_ptr(), db.data_ptr(),
                           dc.data_ptr(), da.data_ptr(), dh0.data_ptr(), part.data_ptr(),
                           da_part.data_ptr(), b, s, di, n, chunk, channels,
                           _build.stream_handle(x.device))
    if err:
        raise RuntimeError(f"ssm_scan_bwd: kernel launch failed with CUDA error {err}")
    ssm_scan_bwd.launches += 1
    return dx, ddt, db, dc, da, dh0


ssm_scan_bwd.launches = 0


class SsmScan(torch.autograd.Function):
    """The differentiable selective scan: ``forward_fn`` (the kernel on the
    card, the plain version in the CPU tests) gives y in ``out_dtype`` and h_T
    and keeps its inputs; ``backward_fn`` (the backward kernel, or its plain
    version) replays the states it needs from them. A gradient that never
    arrives (h_T unused) reaches the backward as None and counts as zero."""

    @staticmethod
    def forward(ctx, x, dt, bmat, cmat, a, h0, out_dtype, forward_fn, backward_fn):
        y, h_t = forward_fn(x, dt, bmat, cmat, a, h0, out_dtype=out_dtype)
        ctx.save_for_backward(x, dt, bmat, cmat, a, h0)
        ctx.backward_fn = backward_fn
        ctx.set_materialize_grads(False)
        return y, h_t

    @staticmethod
    def backward(ctx, dy, dh_t):
        x, dt, bmat, cmat, a, h0 = ctx.saved_tensors
        dy = torch.zeros(x.shape, device=x.device) if dy is None else dy.float().contiguous()
        grads = ctx.backward_fn(x, dt, bmat, cmat, a, h0, dy,
                                None if dh_t is None else dh_t.float().contiguous())
        return (*grads, None, None, None)
