"""Gradient compression: int8 blockwise quantization with error feedback.

The PyTorch counterpart of ``compress_int8`` and ``decompress_int8`` in
``repro/optim/compress.py``, operation for operation, so codes, scales and
residuals agree with the reference bit for bit. The ring's compressed
deposits (``core.ring.RingMachine.deposit_ef``) run every gradient row through
them; the quantization error is carried into the next deposit of the same row
(the residual lives beside the optimizer state). ``psum_compressed`` belongs
to the gspmd baseline and is not ported yet (ROADMAP.md, Queue 1).
"""
from __future__ import annotations

import math

import torch

BLOCK = 256


def compress_int8(g, residual=None):
    """g: float tensor -> (int8 codes (nb, BLOCK), fp32 per-block scales
    (nb,), new fp32 residual shaped like g)."""
    gf = g.float()
    if residual is not None:
        gf = gf + residual
    flat = gf.reshape(-1)
    flat = torch.nn.functional.pad(flat, (0, (-flat.numel()) % BLOCK))
    blocks = flat.reshape(-1, BLOCK)
    scale = torch.clamp_min(blocks.abs().amax(dim=1, keepdim=True) / 127.0, 1e-12)
    codes = torch.clamp(torch.round(blocks / scale), -127, 127).to(torch.int8)
    deq = (codes.float() * scale).reshape(-1)[:gf.numel()].reshape(g.shape)
    return codes, scale[:, 0], gf - deq


def decompress_int8(codes, scale, shape):
    n = math.prod(int(s) for s in shape)
    deq = codes.float() * scale[:, None]
    return deq.reshape(-1)[:n].reshape(shape)
