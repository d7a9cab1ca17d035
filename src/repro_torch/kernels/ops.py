"""The kernel entry points the models call.

Each entry chooses by the device of the tensors it is given: tensors on the
CPU take the plain PyTorch version in ``ref``; tensors anywhere else go to the
hand-written CUDA kernel, whose wrapper launches it or raises. There is no
fallback from a failed kernel to the plain version and no switch to force one.
"""
from __future__ import annotations

import functools

import torch

from . import ref
from .decode_attention import decode_attention as _decode_kernel
from .dequant import dequant_rows as _dequant_kernel
from .flash_attention import FlashAttention
from .flash_attention import flash_attention as _flash_kernel
from .fused_xent import FusedXent
from .fused_xent import fused_xent as _xent_kernel
from .rwkv_scan import RwkvScan
from .rwkv_scan import rwkv_scan as _rwkv_kernel
from .rwkv_scan import rwkv_scan_bwd as _rwkv_bwd_kernel
from .ssm_scan import SsmScan
from .ssm_scan import ssm_scan as _ssm_kernel
from .ssm_scan import ssm_scan_bwd as _ssm_bwd_kernel


def _needs_grad(*tensors) -> bool:
    return torch.is_grad_enabled() and any(t.requires_grad for t in tensors)


def flash_attention(q, k, v, *, causal=True, sliding_window=None, logit_scale=None):
    """q: (B,Sq,H,Dh); k,v: (B,Skv,KH,Dh|Dv) -> (B,Sq,H,Dv).

    Differentiable: on the CPU through autograd of the plain version, on the
    card through the forward and backward kernels (``FlashAttention``)."""
    if q.device.type == "cpu":
        return ref.flash_attention_ref(q, k, v, causal=causal, sliding_window=sliding_window,
                                       logit_scale=logit_scale)
    if _needs_grad(q, k, v):
        return FlashAttention.apply(q, k, v, causal, sliding_window, logit_scale)
    return _flash_kernel(q, k, v, causal=causal, sliding_window=sliding_window,
                         logit_scale=logit_scale)


def decode_attention(q, k_cache, v_cache, n_valid, *, logit_scale=None):
    """q: (B,H,Dh); caches: (B,S,KH,Dh|Dv); n_valid: int or (B,) -> (B,H,Dv)."""
    fn = ref.decode_attention_ref if q.device.type == "cpu" else _decode_kernel
    return fn(q, k_cache, v_cache, n_valid, logit_scale=logit_scale)


def fused_xent(x, w, labels, *, ignore_index=-100):
    """Per-token loss (T,) fp32 for x: (T,D), w: (D,V), labels: (T,); 0 for a
    token labelled ``ignore_index``.

    Differentiable through ``FusedXent``: its forward is the kernel on the
    card and the plain version on the CPU; its streamed backward is the same
    code on both."""
    fwd = (functools.partial(ref.fused_xent_ref, return_lse=True)
           if x.device.type == "cpu" else _xent_kernel)
    return FusedXent.apply(x, w, labels, ignore_index, fwd)


def dequant_rows(codes, scales, *, block=256, out_dtype=torch.float32):
    """Dequant-on-upload: blockwise-absmax codes (int8, or uint8 nibble pairs)
    and (R, nb) fp32 scales -> (R, nb*block) rows in ``out_dtype``, written
    straight in that type on the card."""
    if codes.device.type == "cpu":
        return ref.dequant_rows_ref(codes, scales, block=block).to(out_dtype)
    return _dequant_kernel(codes, scales, block=block, out_dtype=out_dtype)


def rwkv_scan(r, k, v, w, u, s0):
    """The RWKV6 recurrence.  r,k,v,w: (B,S,H,N); u: (H,N) fp32; s0:
    (B,H,N,N) fp32 -> (y (B,S,H,N) in r's dtype, S_T (B,H,N,N) fp32).

    Differentiable: on the CPU through autograd of the plain version, on the
    card through the forward and backward kernels (``RwkvScan``)."""
    if r.device.type == "cpu":
        return ref.rwkv_scan_ref(r, k, v, w, u, s0)
    if _needs_grad(r, k, v, w, u, s0):
        return RwkvScan.apply(r, k, v, w, u, s0, _rwkv_kernel, _rwkv_bwd_kernel)
    return _rwkv_kernel(r, k, v, w, u, s0)


def ssm_scan(x, dt, bmat, cmat, a, h0, *, out_dtype=None):
    """The Mamba selective scan.  x: (B,S,Di); dt: (B,S,1); bmat,cmat:
    (B,S,N); a: (Di,N) fp32; h0: (B,Di,N) fp32 -> (y (B,S,Di) in
    ``out_dtype``, x's dtype by default, h_T (B,Di,N) fp32).

    Differentiable: on the CPU through autograd of the plain version, on the
    card through the forward and backward kernels (``SsmScan``)."""
    if x.device.type == "cpu":
        return ref.ssm_scan_ref(x, dt, bmat, cmat, a, h0, out_dtype=out_dtype)
    if _needs_grad(x, dt, bmat, cmat, a, h0):
        return SsmScan.apply(x, dt, bmat, cmat, a, h0, out_dtype, _ssm_kernel, _ssm_bwd_kernel)
    return _ssm_kernel(x, dt, bmat, cmat, a, h0, out_dtype=out_dtype)
