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
from typing import NamedTuple

import torch

from . import _build

D_MAX = 256
BWD_TILE_Q = 64   # csrc/flash_attention_bwd.cu kTileQ: lse, D and dQ's buffer are padded to it


class BwdPlan(NamedTuple):
    """How the bf16 backward cuts its work: blocks of ``block_kv`` kv rows of
    one kv head, each work item taking ``heads`` of its group's query heads
    (the last item of a group the rest), ``splits`` items a group."""
    block_kv: int
    splits: int
    heads: int


def padded_head_dim(dh: int, dv: int) -> int:
    """The head dim the bf16 kernels run at: the larger of Dh and Dv rounded
    up to a multiple of 64 (one 128-byte row of a TMA box): 64, 128, 192 or
    256. dQ's fp32 buffer in the backward has this many columns a row."""
    return -(-max(dh, dv) // 64) * 64


def bwd_block_kv(dh: int, dv: int) -> int:
    """The kv rows a block of the bf16 backward owns
    (``csrc/flash_attention_bwd.cu`` ``bw_rows``): 128, or 64 when the padded
    head dim is above 128."""
    return 64 if padded_head_dim(dh, dv) > 128 else 128


def bwd_plan(b: int, skv: int, h: int, kh: int, dh: int, dv: int, sms: int) -> BwdPlan:
    """The bf16 backward's plan. Up to 128 padded head dims a block sees its
    whole group (128-row blocks fill the card at the training shapes). Above,
    a block holds 64 kv rows and one block runs on an SM; where the (kv tile,
    kv head, batch) items are fewer than ``sms``, the group's query heads are
    split over ``splits`` items of ``heads`` heads each, at least one wave of
    items (as many as the group allows), the heads spread evenly. The items
    then add dK and dV to fp32 buffers; ``splits == 1`` writes them
    directly."""
    block = bwd_block_kv(dh, dv)
    group = h // kh
    items = -(-skv // block) * kh * b
    if padded_head_dim(dh, dv) <= 128 or items >= sms:
        return BwdPlan(block, 1, group)
    want = -(-sms // items)                    # items each group must become
    splits = -(-group // max(1, group // want))
    return BwdPlan(block, splits, -(-group // splits))


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
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 12 + [ctypes.c_int] * 7
                   + [ctypes.POINTER(ctypes.c_longlong)]
                   + [ctypes.c_int, ctypes.c_int, ctypes.c_float, ctypes.c_void_p, ctypes.c_int,
                      ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


@functools.cache
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def _check(name, q, k, v, sliding_window):
    """Shapes (B,Sq,H,Dh), (B,Skv,KH,Dh), (B,Skv,KH,Dv) the kernels take,
    checked on the host before the tensors' devices and types."""
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
    _build.check_tensors(name, q, k, v)


def tma_describable(t: torch.Tensor) -> bool:
    """Whether the bf16 kernels' TMA loads can read ``t`` ((B,S,H,D), or the
    (rows, D) operands of the cross-entropy) where it lies: a 16-byte
    aligned base, every stride but the last a multiple of 16 bytes and a
    dense last dimension."""
    e = t.element_size()
    return (t.stride(-1) == 1 and t.data_ptr() % 16 == 0
            and all(st * e % 16 == 0 for st in t.stride()[:-1]))


def tma_inputs(q, k, v):
    """q, k, v as the bf16 forward's TMA loads can read them: the tensors
    themselves when all three are describable, else fresh dense copies with
    the head dims zero-padded to a multiple of 8 (16 bytes). Zero dims add
    nothing to the scores, and the output's padded dims are sliced off; the
    caller keeps the logit scale of the original Dh."""
    if all(tma_describable(t) for t in (q, k, v)):
        return q, k, v
    return pad_head_dim(q), pad_head_dim(k), pad_head_dim(v)


def tma_bwd_inputs(q, k, v, o, do):
    """q, k, v, o and do as the bf16 backward's TMA loads can read them: the
    tensors themselves when q, k, v and do are describable, else fresh dense
    copies of all five with the head dims zero-padded to a multiple of 8.
    Zero dims add nothing to the scores, to dP or to D = rowsum(dO * O); the
    caller slices the gradients' padded dims off and keeps the logit scale
    of the original Dh."""
    if all(tma_describable(t) for t in (q, k, v, do)):
        return q, k, v, o, do
    return tuple(pad_head_dim(t) for t in (q, k, v, o, do))


def pad_head_dim(t: torch.Tensor) -> torch.Tensor:
    """A fresh dense copy of ``t`` with its last dim zero-padded to a multiple
    of 8 elements (16 bytes in bf16): describable by ``tma_describable``."""
    out = t.new_zeros((*t.shape[:-1], -(-t.shape[-1] // 8) * 8))
    out[..., :t.shape[-1]] = t
    return out


def flash_attention(q, k, v, *, causal=True, sliding_window=None, logit_scale=None,
                    return_lse=False):
    """q: (B,Sq,H,Dh); k: (B,Skv,KH,Dh); v: (B,Skv,KH,Dv) -> (B,Sq,H,Dv), and
    with ``return_lse`` also each row's fp32 log-sum-exp of its scaled scores,
    (B,H,Sq).

    Launches the forward kernel on PyTorch's current stream; raises for
    anything the kernel does not take (CPU tensors included). bf16 inputs that
    TMA cannot describe go to the same kernel as padded copies
    (``tma_inputs``). Computes values only: ``FlashAttention`` is the
    differentiable form."""
    _build.refuse_graph("flash_attention", q, k, v)
    _check("flash_attention", q, k, v, sliding_window)
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(q.shape[3])
    dv_out = v.shape[3]
    if q.dtype == torch.bfloat16:
        q, k, v = tma_inputs(q, k, v)
    b, sq, h, dh = q.shape
    skv, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    out = torch.empty((b, sq, h, dv), dtype=q.dtype, device=q.device)
    lse = (torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
           if return_lse else None)
    if out.numel() == 0:
        out = out[..., :dv_out]
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
    out = out[..., :dv_out]
    return (out, lse) if return_lse else out


flash_attention.launches = 0


def flash_attention_bwd(q, k, v, o, lse, do, *, causal=True, sliding_window=None,
                        logit_scale=None):
    """The gradients (dq, dk, dv) of ``flash_attention`` at output gradient
    ``do``, from the forward's output ``o`` and log-sum-exp ``lse`` (B,H,Sq)
    fp32. q, k, v, o and do may be strided with a dense last dimension; the
    gradients come back dense in the inputs' dtype.

    Launches the backward kernel (a pre-pass, the main pass and a cast of
    dq, and of dk and dv where ``bwd_plan`` splits a group's query heads) on
    PyTorch's current stream; raises for anything it does not take. bf16
    inputs that TMA cannot describe go to the same kernel as padded copies
    (``tma_bwd_inputs``)."""
    _check("flash_attention_bwd", q, k, v, sliding_window)
    _build.check_tensors("flash_attention_bwd", q, o, do)
    b, sq, h, dh = q.shape
    skv, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    if tuple(o.shape) != (b, sq, h, dv) or tuple(do.shape) != (b, sq, h, dv):
        raise ValueError(f"flash_attention_bwd: o {tuple(o.shape)} and do {tuple(do.shape)} "
                         f"must be {(b, sq, h, dv)}")
    _build.check_dense("flash_attention_bwd", lse, torch.float32, (b, h, sq), q.device)
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(dh)
    if q.dtype == torch.bfloat16:
        q, k, v, o, do = tma_bwd_inputs(q, k, v, o, do)
    dhp, dvp = q.shape[3], v.shape[3]
    dq = torch.empty((b, sq, h, dhp), dtype=q.dtype, device=q.device)
    dk = torch.empty((b, skv, kh, dhp), dtype=q.dtype, device=q.device)
    dvv = torch.empty((b, skv, kh, dvp), dtype=q.dtype, device=q.device)
    if sq == 0 or b == 0:
        dk.zero_()
        dvv.zero_()
    else:
        sq_pad = -(-sq // BWD_TILE_Q) * BWD_TILE_Q
        d_pad = padded_head_dim(dhp, dvp)
        dsum = torch.empty((2, b, h, sq_pad), dtype=torch.float32, device=q.device)
        dq_acc = torch.zeros((b, h, sq_pad, d_pad), dtype=torch.float32, device=q.device)
        heads, dkv_acc = h // kh, None   # dK's and dV's fp32 sums where the group is split
        if q.dtype == torch.bfloat16:
            plan = bwd_plan(b, skv, h, kh, dhp, dvp, _sm_count(q.device.index))
            heads = plan.heads
            if plan.splits > 1:
                skv_pad = -(-skv // plan.block_kv) * plan.block_kv
                dkv_acc = torch.zeros((2, b, kh, skv_pad, d_pad), dtype=torch.float32,
                                      device=q.device)
        strides = (ctypes.c_longlong * 15)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                           *o.stride()[:3], *do.stride()[:3])
        with torch.cuda.device(q.device):
            err = _bwd_entry()(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k.data_ptr(),
                               v.data_ptr(), o.data_ptr(), do.data_ptr(), lse.data_ptr(),
                               dsum[0].data_ptr(), dsum[1].data_ptr(), dq_acc.data_ptr(),
                               dq.data_ptr(), dk.data_ptr(), dvv.data_ptr(), b, sq, skv, h, kh,
                               dhp, dvp, strides, int(causal), sliding_window or 0,
                               float(scale), None if dkv_acc is None else dkv_acc.data_ptr(),
                               heads, _build.stream_handle(q.device))
        if err:
            raise RuntimeError(f"flash_attention_bwd: kernel launch failed with CUDA error {err}")
        flash_attention_bwd.launches += 1
    if (dhp, dvp) != (dh, dv):
        return dq[..., :dh].contiguous(), dk[..., :dh].contiguous(), dvv[..., :dv].contiguous()
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
