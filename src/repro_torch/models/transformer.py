"""Dense decoder of the port: init, forward and loss, and serving with a KV
cache.

The PyTorch counterpart of the dense GQA branch of
``repro/models/transformer.py``. Parameters are plain dicts with the
reference's leaf names, scales and (in, out) weight layout; the reference's
stacked layer axis becomes a list of per-layer dicts (``convert`` moves
weights between the two). Serving keeps a cache dict ``{"len": int, "k",
"v"}`` whose tensors are (L, B, W, KH, Dh), as in the reference, and which
``decode_step`` updates in place.

MoE, MLA, RWKV6, hybrid and the ``embeds`` front end are later slices of the
port (ROADMAP.md, Queue 1, item 13) and raise ``NotImplementedError``.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops

from .config import ModelConfig
from .layers import (apply_norm, apply_rope, chunked_attention, decode_attention, init_mlp,
                     init_norm, init_normal, mlp)

_LATER = "is not ported yet (ROADMAP.md, Queue 1, item 13: non-dense families)"


def _require_dense(cfg: ModelConfig) -> None:
    if cfg.block_kind != "attn":
        raise NotImplementedError(f"{cfg.name}: block kind {cfg.block_kind!r} {_LATER}")
    if cfg.attn_kind != "gqa":
        raise NotImplementedError(f"{cfg.name}: attention kind {cfg.attn_kind!r} {_LATER}")
    if cfg.is_moe:
        raise NotImplementedError(f"{cfg.name}: MoE MLP {_LATER}")


# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_attn(generator, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    sc = 1.0 / math.sqrt(d)
    return {
        "w_q": init_normal((d, cfg.q_dim), sc, generator, dtype, device),
        "w_k": init_normal((d, cfg.kv_dim), sc, generator, dtype, device),
        "w_v": init_normal((d, cfg.kv_dim), sc, generator, dtype, device),
        "w_o": init_normal((cfg.q_dim, d), 1.0 / math.sqrt(cfg.q_dim), generator, dtype, device),
    }


def init_layer(generator, cfg: ModelConfig, dtype=torch.bfloat16, device="cuda"):
    _require_dense(cfg)
    return {"norm1": init_norm(cfg.d_model, cfg.norm_kind, dtype, device),
            "norm2": init_norm(cfg.d_model, cfg.norm_kind, dtype, device),
            "attn": _init_attn(generator, cfg, dtype, device),
            "mlp": init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype, device)}


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=torch.bfloat16,
                device="cuda"):
    """Random weights with the reference's leaf names, shapes and scales.

    ``generator`` must live on ``device``. The numbers differ from the
    reference's ``jax.random`` ones; to compare the two, move the reference's
    weights over with ``convert.params_from_jax``."""
    _require_dense(cfg)
    d = cfg.d_model
    p = {
        "embed": init_normal((cfg.vocab_size, d), 1.0 / math.sqrt(d), generator, dtype, device),
        "layers": [init_layer(generator, cfg, dtype, device) for _ in range(cfg.n_layers)],
        "final_norm": init_norm(d, cfg.norm_kind, dtype, device),
    }
    if not cfg.tie_embeddings:
        p["lm_head"] = init_normal((d, cfg.vocab_size), 1.0 / math.sqrt(d), generator, dtype,
                                   device)
    return p


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _attention_block(x, p, cfg: ModelConfig):
    """Full-sequence attention from position 0.  x: (B,S,D).  Returns the
    block's output and the post-RoPE k and v, which prefill caches."""
    b, s, _ = x.shape
    q = (x @ p["w_q"]).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = (x @ p["w_k"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = (x @ p["w_v"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.rope:
        pos = torch.arange(s, device=x.device)
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    o = chunked_attention(q, k, v, causal=cfg.causal, sliding_window=cfg.sliding_window)
    return o.reshape(b, s, -1) @ p["w_o"], k, v


def _layer(x, p, cfg: ModelConfig):
    """One pre-norm residual layer; also returns the layer's cache entries."""
    h = apply_norm(x, p["norm1"], cfg.norm_kind, cfg.norm_eps)
    a, k, v = _attention_block(h, p["attn"], cfg)
    x = x + a
    h = apply_norm(x, p["norm2"], cfg.norm_kind, cfg.norm_eps)
    return x + mlp(h, p["mlp"], cfg.mlp_kind), k, v


def layer_forward(x, p, cfg: ModelConfig):
    """One decoder layer, pre-norm residual.  x: (B,S,D)."""
    _require_dense(cfg)
    return _layer(x, p, cfg)[0]


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def embed_inputs(params, batch, cfg: ModelConfig):
    if "embeds" in batch:
        raise NotImplementedError(
            "the 'embeds' front end (audio / vision stubs) is not ported yet "
            "(ROADMAP.md, Queue 1, item 13)")
    return params["embed"][batch["tokens"]]


def forward(params, batch, cfg: ModelConfig, *, remat: bool = True, kv_chunk: int = 1024):
    """Token inputs -> final hidden states (B,S,D).

    Differentiable. With ``remat`` each layer runs under
    ``torch.utils.checkpoint`` (its activations are recomputed in the
    backward), where the reference wraps each layer in ``jax.remat``.
    ``kv_chunk`` is accepted as in the reference and unused: the flash kernel
    tiles by itself."""
    del kv_chunk
    _require_dense(cfg)
    x = embed_inputs(params, batch, cfg)
    for p in params["layers"]:
        if remat and torch.is_grad_enabled():
            x = checkpoint(layer_forward, x, p, cfg, use_reentrant=False)
        else:
            x = layer_forward(x, p, cfg)
    return apply_norm(x, params["final_norm"], cfg.norm_kind, cfg.norm_eps)


def lm_head_weights(params, cfg: ModelConfig):
    return params["embed"].T if cfg.tie_embeddings else params["lm_head"]


def chunked_softmax_xent(x, w_head, labels, *, chunk: int = 512, ignore_index: int = -100):
    """Cross-entropy without materialising (B,S,V): the fused LM-head kernel
    streams the vocabulary by itself, so ``chunk`` is accepted and unused.
    x: (B,S,D); w_head: (D,V); labels: (B,S).  Returns (sum of the per-token
    losses fp32, number of tokens not labelled ``ignore_index``)."""
    del chunk
    d = x.shape[-1]
    loss = ops.fused_xent(x.reshape(-1, d), w_head, labels.reshape(-1),
                          ignore_index=ignore_index)
    return loss.sum(), (labels != ignore_index).sum()


def loss_fn(params, batch, cfg: ModelConfig, *, remat: bool = True, kv_chunk: int = 1024,
            xent_chunk: int = 512):
    """Mean next-token cross-entropy over the tokens not labelled -100."""
    x = forward(params, batch, cfg, remat=remat, kv_chunk=kv_chunk)
    tot, cnt = chunked_softmax_xent(x, lm_head_weights(params, cfg), batch["labels"],
                                    chunk=xent_chunk)
    return tot / torch.clamp(cnt, min=1)


# ---------------------------------------------------------------------------
# Serving: cache init / prefill / decode
# ---------------------------------------------------------------------------

def cache_window(cfg: ModelConfig, max_len: int) -> int:
    """Physical KV length: SWA needs only its window (ring buffer)."""
    if cfg.attn_kind == "none":
        return 0
    if cfg.sliding_window is not None:
        return min(cfg.sliding_window, max_len)
    return max_len


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="meta"):
    """The cache's layout. On the default ``meta`` device it allocates
    nothing, as the reference's ShapeDtypeStruct spec; ``zero_cache`` gives a
    real one."""
    _require_dense(cfg)
    shape = (cfg.n_layers, batch, cache_window(cfg, max_len), cfg.n_kv_heads, cfg.d_head)
    return {"len": 0,
            "k": torch.zeros(shape, dtype=dtype, device=device),
            "v": torch.zeros(shape, dtype=dtype, device=device)}


def zero_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=torch.bfloat16,
               device="cuda"):
    return init_cache(cfg, batch, max_len, dtype, device)


def _decode_attn_layer(x, p, cfg: ModelConfig, k_all, v_all, layer, pos, slot, n_valid):
    """One-token attention with in-place cache insert.  x: (B,1,D); k_all and
    v_all: (L,B,W,KH,Dh); pos and slot: (1,) int tensors; n_valid: (B,) int32."""
    b = x.shape[0]
    q = (x @ p["w_q"]).reshape(b, 1, cfg.n_heads, cfg.d_head)
    k = (x @ p["w_k"]).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    v = (x @ p["w_v"]).reshape(b, 1, cfg.n_kv_heads, cfg.d_head)
    if cfg.rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    # In place at slot pos % window, where the reference returns a new cache
    # from dynamic_update_slice: the port keeps one live cache buffer.
    k_all[layer].index_copy_(1, slot, k.to(k_all.dtype))
    v_all[layer].index_copy_(1, slot, v.to(v_all.dtype))
    # ring buffers are softmax-permutation-safe: mask on validity only
    o = decode_attention(q, k_all[layer], v_all[layer], n_valid)
    return o.reshape(b, 1, -1) @ p["w_o"]


def decode_step(params, cache, tokens, cfg: ModelConfig):
    """One decoding step.  tokens: (B,) int.  Returns (logits (B,V) fp32,
    cache); the cache's tensors are updated in place and its ``len`` is one
    more."""
    _require_dense(cfg)
    x = params["embed"][tokens[:, None]]
    b = x.shape[0]
    pos = cache["len"]
    w = cache["k"].shape[2]
    dev = x.device
    pos_t = torch.tensor([pos], device=dev)
    slot = torch.tensor([pos % w], device=dev)
    n_valid = torch.full((b,), min(pos + 1, w), dtype=torch.int32, device=dev)
    for layer, p in enumerate(params["layers"]):
        h = apply_norm(x, p["norm1"], cfg.norm_kind, cfg.norm_eps)
        x = x + _decode_attn_layer(h, p["attn"], cfg, cache["k"], cache["v"], layer,
                                   pos_t, slot, n_valid)
        h = apply_norm(x, p["norm2"], cfg.norm_kind, cfg.norm_eps)
        x = x + mlp(h, p["mlp"], cfg.mlp_kind)
    x = apply_norm(x, params["final_norm"], cfg.norm_kind, cfg.norm_eps)
    logits = (x[:, 0] @ lm_head_weights(params, cfg)).float()
    return logits, {**cache, "len": pos + 1}


def prefill(params, batch, cfg: ModelConfig, max_len: int, *, dtype=torch.bfloat16):
    """Run the prompt through the model, filling a cache of ``dtype``.
    Returns (final hidden (B,S,D), cache)."""
    _require_dense(cfg)
    x = embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    w = cache_window(cfg, max_len)
    cache = zero_cache(cfg, b, max_len, dtype, x.device)
    for layer, p in enumerate(params["layers"]):
        x, k, v = _layer(x, p, cfg)
        cache["k"][layer] = _fit_window(k, w, dtype)
        cache["v"][layer] = _fit_window(v, w, dtype)
    cache["len"] = s
    x = apply_norm(x, params["final_norm"], cfg.norm_kind, cfg.norm_eps)
    return x, cache


def _fit_window(t, w, dtype):
    """Keep the last ``w`` positions along axis 1 (ring-equivalent for SWA).

    For SWA the prompt suffix modulo-aligns with the decode ring: slot
    ``pos % w`` of position ``pos`` — we roll so future inserts land right.
    A prompt shorter than the window is padded with zeros up to ``w``."""
    s = t.shape[1]
    t = t.to(dtype)
    if s == w:
        return t
    if s > w:
        # align ring phase: position p sits at slot p % w
        return torch.roll(t[:, s - w:], shifts=s % w, dims=1)
    pad = torch.zeros((t.shape[0], w - s) + tuple(t.shape[2:]), dtype=dtype, device=t.device)
    return torch.cat([t, pad], dim=1)
