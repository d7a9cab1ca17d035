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
from .flash_attention import FlashAttention
from .flash_attention import flash_attention as _flash_kernel
from .fused_xent import FusedXent
from .fused_xent import fused_xent as _xent_kernel


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
