"""Dequant-on-upload: the blockwise-absmax codec of the quantized resident
pool, and the wrapper of ``csrc/dequant.cu``.

The PyTorch counterpart of ``repro/kernels/dequant.py``. The pool streams as
codes (int8, or two int4 nibbles per uint8) with one fp32 scale per
``QUANT_BLOCK`` elements; ``dequant_rows`` rebuilds the standby block in
compute precision straight from them at promote time, so the codes never pass
through a separately materialised fp32 copy. The kernel replaces the Pallas
TPU kernels ``_dequant8_kernel`` and ``_dequant4_kernel``; its note says what
bounds it on an H100. Its plain version is ``ref.dequant_rows_ref``, and
``ops.dequant_rows`` picks between the two by device.

Quantization (master weights -> codes) runs once per step, off the tick loop,
and is plain PyTorch here as it is plain jnp in the reference: ``quantize_rows``
gives the reference's codes and scales bit for bit (round half to even, a true
division by the scale, the scale clamped at 1e-12 so all-zero blocks stay
exact).
"""
from __future__ import annotations

import ctypes
import functools

import torch

from . import _build

QUANT_BLOCK = 256      # elements per scale (optim.compress.BLOCK)
INT8_QMAX = 127.0
INT4_QMAX = 7.0        # symmetric signed nibbles in [-7, 7]


def quantize_rows(rows, *, bits: int = 8, block: int = QUANT_BLOCK):
    """rows (R, E) float -> (codes, scales).

    codes: (R, ceil(E/block)*block) int8 for ``bits=8``, or the packed
    (R, ceil(E/block)*block // 2) uint8 nibble pairs for ``bits=4``;
    scales: (R, ceil(E/block)) fp32, each block's absmax / qmax, at least
    1e-12."""
    if bits not in (8, 4):
        raise ValueError(f"unsupported pool quantization bits: {bits}")
    r, e = rows.shape
    nb = -(-e // block)
    flat = torch.nn.functional.pad(rows.float(), (0, nb * block - e))
    blocks = flat.reshape(r, nb, block)
    qmax = INT8_QMAX if bits == 8 else INT4_QMAX
    scale = torch.clamp_min(blocks.abs().amax(dim=2) / qmax, 1e-12)
    codes = torch.clamp(torch.round(blocks / scale[..., None]), -qmax, qmax).to(torch.int8)
    codes = codes.reshape(r, nb * block)
    if bits == 4:
        codes = pack_int4(codes)
    return codes, scale


def pack_int4(codes):
    """int8 codes in [-8, 7], even last dimension -> uint8 nibble pairs:
    element 2i in the low nibble of byte i, element 2i+1 in the high one."""
    u = (codes.to(torch.int32) & 0xF).to(torch.uint8)
    return u[..., 0::2] | (u[..., 1::2] << 4)


def widen_nibble(n):
    """[0, 15] nibbles -> signed int32 in [-8, 7] (two's complement)."""
    n = n.to(torch.int32)
    return n - 16 * (n >> 3)


def unpack_int4(packed):
    """uint8 nibble pairs -> int8 codes, the inverse of ``pack_int4``."""
    p = packed.to(torch.int32)
    pair = torch.stack([widen_nibble(p & 0xF), widen_nibble((p >> 4) & 0xF)], dim=-1)
    return pair.reshape(*packed.shape[:-1], packed.shape[-1] * 2).to(torch.int8)


@functools.cache
def _entry():
    fn = _build.load("dequant").dequant_rows
    fn.argtypes = ([ctypes.c_int] * 2 + [ctypes.c_void_p] * 3 + [ctypes.c_int]
                   + [ctypes.c_longlong] * 2 + [ctypes.c_int, ctypes.c_void_p])
    fn.restype = ctypes.c_int
    return fn


def dequant_rows(codes, scales, *, block: int = QUANT_BLOCK, out_dtype=torch.float32):
    """(codes, scales) from ``quantize_rows`` -> (R, nb*block) rows in
    ``out_dtype`` (float32 or bfloat16).

    int8 codes hold one code per element, uint8 codes two nibbles: the dtype
    is the format tag. Launches the kernel on PyTorch's current stream and
    raises for anything it does not take, CPU tensors included."""
    for name, x in (("codes", codes), ("scales", scales)):
        if x.device.type != "cuda":
            raise ValueError(f"dequant_rows: the kernel takes CUDA tensors, {name} is on "
                             f"{x.device}")
    if codes.device != scales.device:
        raise ValueError(f"dequant_rows: codes on {codes.device}, scales on {scales.device}")
    if codes.dtype not in (torch.int8, torch.uint8) or scales.dtype != torch.float32:
        raise TypeError(f"dequant_rows: needs int8 or uint8 codes and float32 scales, got "
                        f"{codes.dtype} and {scales.dtype}")
    if out_dtype not in _build.DTYPE_CODES:
        raise TypeError(f"dequant_rows: out_dtype must be float32 or bfloat16, got {out_dtype}")
    if scales.ndim != 2 or codes.ndim != 2:
        raise ValueError(f"dequant_rows: codes {tuple(codes.shape)} and scales "
                         f"{tuple(scales.shape)} must be 2-D")
    if block < 32 or block % 32:
        raise ValueError(f"dequant_rows: block {block} must be a positive multiple of 32")
    r, nb = scales.shape
    packed = codes.dtype == torch.uint8
    code_cols = block // 2 if packed else block
    if tuple(codes.shape) != (r, nb * code_cols):
        raise ValueError(f"dequant_rows: codes {tuple(codes.shape)} do not match scales "
                         f"{tuple(scales.shape)} with block={block}")
    if r > 65535:
        raise ValueError(f"dequant_rows: {r} rows; the kernel's grid takes at most 65535")
    for name, x in (("codes", codes), ("scales", scales)):
        if not x.is_contiguous() or x.data_ptr() % 16:
            raise ValueError(f"dequant_rows: {name} must be contiguous and 16-byte aligned")
    out = torch.empty((r, nb * block), dtype=out_dtype, device=codes.device)
    if r == 0 or nb == 0:
        return out
    with torch.cuda.device(codes.device):
        err = _entry()(int(packed), _build.DTYPE_CODES[out_dtype], codes.data_ptr(),
                       scales.data_ptr(), out.data_ptr(), r, codes.shape[1], nb, block,
                       _build.stream_handle(codes.device))
    if err:
        raise RuntimeError(f"dequant_rows: kernel launch failed with CUDA error {err}")
    dequant_rows.launches += 1
    return out


dequant_rows.launches = 0
