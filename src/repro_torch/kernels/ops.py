"""The kernel entry points the models call.

Each entry chooses by the device of the tensors it is given: tensors on the
CPU take the plain PyTorch version in ``ref``; tensors anywhere else go to the
hand-written CUDA kernel, whose wrapper launches it or raises. There is no
fallback from a failed kernel to the plain version and no switch to force one.
"""
from __future__ import annotations

from . import ref
from .decode_attention import decode_attention as _decode_kernel
from .flash_attention import flash_attention as _flash_kernel


def flash_attention(q, k, v, *, causal=True, sliding_window=None, logit_scale=None):
    """q: (B,Sq,H,Dh); k,v: (B,Skv,KH,Dh|Dv) -> (B,Sq,H,Dv)."""
    fn = ref.flash_attention_ref if q.device.type == "cpu" else _flash_kernel
    return fn(q, k, v, causal=causal, sliding_window=sliding_window, logit_scale=logit_scale)


def decode_attention(q, k_cache, v_cache, n_valid, *, logit_scale=None):
    """q: (B,H,Dh); caches: (B,S,KH,Dh|Dv); n_valid: int or (B,) -> (B,H,Dv)."""
    fn = ref.decode_attention_ref if q.device.type == "cpu" else _decode_kernel
    return fn(q, k_cache, v_cache, n_valid, logit_scale=logit_scale)
