"""Fused LM-head cross-entropy: the wrapper of ``csrc/fused_xent.cu`` (the
forward kernel), its streamed backward, and the autograd Function that joins
them.

The forward replaces the Pallas TPU kernel ``repro/kernels/fused_xent.py``
(``fused_xent`` -> ``_xent_kernel``). In bf16 it is a pipelined wgmma GEMM
(TMA-fed, blocks of 128 tokens by tiles of 256 vocabulary columns) with the
online log-sum-exp in its epilogue; the grid splits the vocabulary so that
one wave fills the card (``vocab_splits``), and a merge kernel joins the
splits' partials. The kernel's note says what bounds it on an H100 and how
its design answers that. The reference's backward (``_bwd``) is jnp outside
any Pallas kernel: products streamed over vocabulary blocks.
``xent_backward`` is its counterpart here, plain PyTorch over vocabulary
blocks, reusing the forward's log-sum-exp in place of the reference's first
pass; it never holds (T,V). A fused CUDA backward is a later speed item
(ROADMAP.md, Queue 2). The plain version of the forward is
``ref.fused_xent_ref``; ``ops.fused_xent`` picks between the two by device.
"""
from __future__ import annotations

import ctypes
import functools

import torch
from torch.profiler import record_function

from . import _build, ref
from .flash_attention import pad_head_dim, tma_describable

TOKENS_PER_BLOCK = 128    # csrc/fused_xent.cu kXtTok (bf16)
VOCAB_TILE = 256          # csrc/fused_xent.cu kVocabTile: the unit of a split
H100_SMS = 132            # one wave of blocks on an H100 (one block per SM)
BWD_BLOCK_V = 8192        # vocabulary columns per step of the backward


@functools.cache
def _entry():
    fn = _build.load("fused_xent").fused_xent_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 3
                   + [ctypes.c_longlong] * 4 + [ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def vocab_splits(t: int, v: int, sms: int = H100_SMS) -> tuple[int, int]:
    """(n_split, tiles_per_split): as many vocabulary splits as let the grid
    of token blocks x splits fill the card's SMs once, each split a run of
    whole tiles (fewer splits when a split would get no tile)."""
    n_tiles = -(-v // VOCAB_TILE)
    token_blocks = -(-t // TOKENS_PER_BLOCK)
    want = max(1, min(n_tiles, sms // token_blocks))
    per = -(-n_tiles // want)
    return -(-n_tiles // per), per


def head_rows(x, w):
    """x and the head as (V,D) rows, as the bf16 kernel's TMA loads read
    them: ``w.T`` in place when its rows are dense (the tied head), else a
    dense copy; and fresh copies of both zero-padded along D to a multiple
    of 8 when either cannot be described (rows not 16-byte multiples apart,
    a misaligned base). Zero columns leave x Wᵀ unchanged."""
    rows = w.T
    if rows.stride(-1) != 1:
        rows = rows.contiguous()
    if tma_describable(x) and tma_describable(rows):
        return x, rows
    return pad_head_dim(x), pad_head_dim(rows)


def fused_xent(x, w, labels, *, ignore_index=-100):
    """x: (T,D); w: (D,V), any strides (the tied head ``embed.T`` is read in
    place); labels: (T,) int -> (per-token loss (T,) fp32, log-sum-exp (T,)
    fp32). A token labelled ``ignore_index`` has loss 0.

    Launches the forward kernel on PyTorch's current stream; raises for
    anything the kernel does not take (CPU tensors included). Computes values
    only: ``FusedXent`` is the differentiable form."""
    _build.refuse_graph("fused_xent", x, w)
    _build.check_tensors("fused_xent", x)
    if x.ndim != 2 or w.ndim != 2 or x.shape[1] != w.shape[0]:
        raise ValueError(f"fused_xent: x {tuple(x.shape)} and w {tuple(w.shape)} "
                         "must be (T,D) and (D,V)")
    if w.device != x.device or w.dtype != x.dtype:
        raise TypeError(f"fused_xent: w is {w.dtype} on {w.device}, x {x.dtype} on {x.device}")
    t, d = x.shape
    v = w.shape[1]
    if labels.device != x.device or labels.shape != (t,) or labels.dtype not in (
            torch.int32, torch.int64):
        raise ValueError(f"fused_xent: labels must be an int (T,) tensor on {x.device}, got "
                         f"{labels.dtype} {tuple(labels.shape)} on {labels.device}")
    if d < 1 or v < 1:
        raise ValueError(f"fused_xent: empty head {tuple(w.shape)}")
    labels = labels.to(torch.int64).contiguous()
    loss = torch.empty((t,), dtype=torch.float32, device=x.device)
    lse = torch.empty((t,), dtype=torch.float32, device=x.device)
    if t == 0:
        return loss, lse
    sms = torch.cuda.get_device_properties(x.device).multi_processor_count
    n_split, per = vocab_splits(t, v, sms)
    part = torch.empty((3, n_split, t), dtype=torch.float32, device=x.device)
    if x.dtype == torch.bfloat16:
        # a named range: a profiler trace reads the copy's device time from it
        with record_function("fused_xent.head_rows"):
            x, rows = head_rows(x, w)
    else:
        rows = w.T
    d = x.shape[1]
    w_sv, w_sd = rows.stride()   # element (v, d) of the head at v * w_sv + d * w_sd
    with torch.cuda.device(x.device):
        err = _entry()(_build.DTYPE_CODES[x.dtype], x.data_ptr(), rows.data_ptr(),
                       labels.data_ptr(), loss.data_ptr(), lse.data_ptr(), part.data_ptr(),
                       t, d, v, x.stride(0), w_sv, w_sd, ignore_index, n_split, per,
                       _build.stream_handle(x.device))
    if err:
        raise RuntimeError(f"fused_xent: kernel launch failed with CUDA error {err}")
    fused_xent.launches += 1
    return loss, lse


fused_xent.launches = 0


def xent_backward(x, w, labels, lse, g, ignore_index=-100, block_v=BWD_BLOCK_V, *,
                  want_dw=True):
    """Gradients of sum(g * loss) with respect to x (T,D) and w (D,V), from
    the forward's log-sum-exp: per vocabulary block, G_b = (softmax - onehot)
    g with ignored tokens masked, dx += G_b W_bᵀ and dW_b = xᵀ G_b. fp32
    products, as the reference's ``_bwd``; the gradients come back in the
    dtypes of x and w, dw as a (D,V) view of a dense (V,D) tensor. With
    ``want_dw=False`` (a frozen head) dw is None: neither its products nor
    its (V,D) tensor are made, and dx is the same, bit for bit."""
    t, d = x.shape
    v = w.shape[1]
    xf = x.float()
    gm = torch.where(labels != ignore_index, g.float(), torch.zeros((), device=g.device))
    dx = torch.zeros((t, d), dtype=torch.float32, device=x.device)
    dw = torch.empty((v, d), dtype=w.dtype, device=w.device) if want_dw else None
    for v0 in range(0, v, block_v):
        wb = w[:, v0:v0 + block_v].float()                       # (D, bv)
        gb = ref.xent_block_grad(xf @ wb, lse, labels, v0, gm)   # (T, bv)
        dx += gb @ wb.T
        if want_dw:
            dw[v0:v0 + block_v] = (gb.T @ xf).to(w.dtype)
    return dx.to(x.dtype), None if dw is None else dw.T


class FusedXent(torch.autograd.Function):
    """Differentiable per-token loss: ``forward_fn`` (the kernel on the card,
    the plain version on the CPU) gives loss and log-sum-exp; the backward is
    ``xent_backward``, which skips dw where the head needs no gradient."""

    @staticmethod
    def forward(ctx, x, w, labels, ignore_index, forward_fn):
        loss, lse = forward_fn(x, w, labels, ignore_index=ignore_index)
        ctx.save_for_backward(x, w, labels, lse)
        ctx.ignore_index = ignore_index
        return loss

    @staticmethod
    def backward(ctx, g):
        x, w, labels, lse = ctx.saved_tensors
        dx, dw = xent_backward(x, w, labels, lse, g, ctx.ignore_index,
                               want_dw=ctx.needs_input_grad[1])
        return dx, dw, None, None, None
