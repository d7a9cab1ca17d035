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
from typing import NamedTuple

import torch

from . import _build
from .flash_attention import _sm_count, pad_head_dim, padded_head_dim, tma_describable

D_MAX = 256
G_MAX = 16
SPLIT_TILE = 64        # slots per tile of the bf16 kernel: splits are whole tiles
BLOCKS_PER_SM = 2      # blocks of the split pass the plan aims for on each SM
# The wide kernel (bf16, padded head dims 192 and 256): one launch whose
# clusters merge their splits.
WIDE_CLUSTER_MAX = 16  # blocks a cluster; above 8 a size the card must be asked for
WIDE_ROUND_MAX = 128   # slots a block scores in one round (8 groups of 16)
WIDE_PAIR_SLOTS = 80   # the longest split whose blocks fit two to an SM
WIDE_BLOCKS_PER_SM = 0.5   # blocks of the grid the plan aims for on each SM


def decode_plan(s: int, b: int, kh: int, sms: int) -> tuple[int, int]:
    """(splits, chunk): the cache of ``s`` slots is cut into ``splits``
    splits of ``chunk`` slots (the last may be shorter), a whole number of
    64-slot tiles each, so that the (KH, B, splits) grid puts about
    ``BLOCKS_PER_SM`` blocks on each of ``sms`` SMs. Depends on shapes only,
    never on ``n_valid``, which lives on the card: reading it here would
    synchronise every decode step. The head dims above 128 in bf16 take
    ``decode_wide_plan``."""
    want = -(-BLOCKS_PER_SM * sms // max(b * kh, 1))
    per = -(-s // want)
    chunk = max(1, (per + SPLIT_TILE // 2) // SPLIT_TILE) * SPLIT_TILE
    return -(-s // chunk), chunk


class WidePlan(NamedTuple):
    """How the wide kernel cuts a cache: clusters of ``cluster`` blocks per
    (batch row, kv head), each block ``chunk`` slots (whole 16-slot groups;
    the last blocks may hold fewer, or none), scored in rounds of ``rows``
    slots through a ring of ``stages`` rounds (one stage where the chunk is
    one round)."""
    cluster: int
    chunk: int
    rows: int
    stages: int


def _groups16(n: int) -> int:
    return -(-n // 16) * 16


def wide_ring(d: int) -> tuple[int, int]:
    """(slots a round, stages) of the wide kernel's ring at padded head dim
    ``d``, for splits longer than one round: two stages of 128 slots at 192
    dims, three of 64 at 256 (what 227 KB of shared memory holds)."""
    return (128, 2) if d <= 192 else (64, 3)


def decode_wide_plan(s: int, b: int, kh: int, d: int, sms: int) -> WidePlan:
    """The wide kernel's plan for a cache of ``s`` slots at (B, KH) and padded
    head dim ``d`` (192 or 256) on ``sms`` SMs: the power-of-two cluster
    (up to ``WIDE_CLUSTER_MAX``, and no more splits than 16-slot groups)
    nearest below ``WIDE_BLOCKS_PER_SM`` blocks an SM, since a block's fixed
    costs (its first loads, the merge) outweigh its slots' work on the main
    path; a cluster above 8 only where its blocks fit two to an SM (splits
    of at most ``WIDE_PAIR_SLOTS``), else 8. A split of at most
    ``WIDE_ROUND_MAX`` slots is one round; longer ones go through the ring
    of ``wide_ring(d)``. Shapes only, never ``n_valid``."""
    pairs = max(b * kh, 1)
    cap = min(WIDE_CLUSTER_MAX, 1 << ((-(-s // 16)).bit_length() - 1))
    cluster = 1
    while cluster * 2 <= cap and pairs * cluster * 2 <= WIDE_BLOCKS_PER_SM * sms:
        cluster *= 2
    chunk = _groups16(-(-s // cluster))
    if cluster > 8 and chunk > WIDE_PAIR_SLOTS:
        cluster, chunk = 8, _groups16(-(-s // 8))
    if chunk <= WIDE_ROUND_MAX:
        return WidePlan(cluster, chunk, chunk, 1)
    rows, stages = wide_ring(d)
    return WidePlan(cluster, chunk, rows, min(-(-chunk // rows), stages))


def aligned_caches(k_cache, v_cache):
    """The caches as the split pass's 16-byte ``cp.async`` copies can read
    them: themselves when the base and the B, S and KH strides of both are
    16-byte multiples (``flash_attention.tma_describable``), else the fresh
    zero-padded copies the flash forward makes (``pad_head_dim``). The kernel
    is given the original Dh and Dv and never reads the padding."""
    if tma_describable(k_cache) and tma_describable(v_cache):
        return k_cache, v_cache
    return pad_head_dim(k_cache), pad_head_dim(v_cache)


@functools.cache
def _entry():
    fn = _build.load("decode_attention").decode_attention_fwd
    fn.argtypes = ([ctypes.c_int] + [ctypes.c_void_p] * 6 + [ctypes.c_int] * 10
                   + [ctypes.c_longlong] * 8 + [ctypes.c_float, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def decode_attention(q, k_cache, v_cache, n_valid, *, logit_scale=None):
    """q: (B,H,Dh); caches: (B,S,KH,Dh) and (B,S,KH,Dv); n_valid: an int, or an
    int tensor of shape () or (B,) on the card -> (B,H,Dv).

    Launches the split pass and the merge of the splits (one C call) on
    PyTorch's current stream, with fp32 partials in a scratch buffer, or in
    bf16 above 128 padded head dims the one wide kernel (``decode_wide_plan``);
    raises for anything the kernel does not take (CPU tensors included).
    Caches the 16-byte copies (or TMA) cannot read go to the same kernel as
    padded copies (``aligned_caches``), and on the wide path so does such a
    q."""
    _build.refuse_graph("decode_attention", q, k_cache, v_cache)
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
    _build.check_tensors("decode_attention", q, k_cache, v_cache)
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
    k_cache, v_cache = aligned_caches(k_cache, v_cache)
    sms = _sm_count(q.device.index)
    if q.dtype == torch.bfloat16 and padded_head_dim(dh, dv) > 128:
        if not tma_describable(q):   # q's rows go by 16-byte copies too
            q = pad_head_dim(q)
        splits, chunk, rows, stages = decode_wide_plan(s, b, kh, padded_head_dim(dh, dv), sms)
        scratch = torch.empty(b * kh * splits * (32 + 16 * -(-dv // 4) * 4),
                              dtype=torch.float32, device=q.device)
    else:
        (splits, chunk), rows, stages = decode_plan(s, b, kh, sms), 0, 0
        scratch = torch.empty(b * h * splits * (dv + 2), dtype=torch.float32, device=q.device)
    q_sb, q_sh = q.stride()[:2]
    with torch.cuda.device(q.device):   # launch on the tensors' card
        err = _entry()(_build.DTYPE_CODES[q.dtype], q.data_ptr(), k_cache.data_ptr(),
                       v_cache.data_ptr(), nv.data_ptr(), out.data_ptr(), scratch.data_ptr(),
                       b, s, h, kh, dh, dv, splits, chunk, rows, stages, q_sb, q_sh,
                       *k_cache.stride()[:3], *v_cache.stride()[:3], float(scale),
                       _build.stream_handle(q.device))
    if err:
        raise RuntimeError(f"decode_attention: kernel launch failed with CUDA error {err}")
    decode_attention.launches += 1
    return out


decode_attention.launches = 0
