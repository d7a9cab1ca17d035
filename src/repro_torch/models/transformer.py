"""Decoder of the port: init, forward and loss, and serving with a cache.

The PyTorch counterpart of ``repro/models/transformer.py`` for all of its
block kinds: attention (GQA, or DeepSeek-V2's multi-head latent attention,
``attn_kind="mla"``), RWKV6 (``block_kind="rwkv6"``) and the hybrid of
sliding-window attention in parallel with Mamba heads
(``block_kind="hybrid"``), each with a dense or a Mixture-of-Experts MLP
(``models/moe.py``; ``MOE_CHUNK_TOKENS`` bounds its dispatch buffers on long
inputs). Inputs are tokens, or the ``embeds`` of a stubbed audio or vision
front end ((B,S,D), cast to the embedding table's dtype; decode takes
(B,) tokens or (B,1,D) embeds). Parameters are plain dicts with the reference's
leaf names, scales and (in, out) weight layout; the reference's stacked layer
axis becomes a list of per-layer dicts (``convert`` moves weights between the
two). Serving keeps the reference's cache layout, its tensors stacked per
layer as (L, ...), and ``decode_step`` updates them in place:

- dense: ``{"len", "k", "v"}``, k and v (L, B, W, KH, Dh);
- MLA: ``{"len", "c_kv", "k_pe"}``, the compressed latent (L, B, W,
  kv_lora_rank) and the post-RoPE shared key (L, B, W, qk_rope_dim); decode
  attends in the compressed space (the absorbed form), prefill and training
  on the materialised keys and values through the flash kernel at Dh =
  d_head + qk_rope_dim, Dv = v_head_dim;
- rwkv6: ``{"len", "rwkv": {"time_x", "time_s", "chan_x"}}``, (L, B, 1, D),
  (L, B, H, 64, 64) fp32 and (L, B, 1, D);
- hybrid: ``{"len", "k", "v", "ssm_h", "ssm_conv"}``, the attention ring of
  the sliding window plus (L, B, Di, N) fp32 and (L, B, CONV_W-1, Di).

Every kind trains: the rwkv6 and hybrid families through the scans' forward
and backward kernels on the card. The training launcher refuses the
front-end archs, which have no embeds dataset; the ring trains them from
embeds batches through ``core.dispatch``.
"""
from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from repro_torch.kernels import ops
from repro_torch.optim.adam import tree_leaves

from .config import ModelConfig
from .layers import (apply_norm, apply_rope, chunked_attention, decode_attention, init_mlp,
                     init_norm, init_normal, mlp)
from .moe import init_moe, moe_block
from .ssm import (init_mamba, init_rwkv6, mamba_seq, mamba_state_shape, mamba_step,
                  rwkv6_channel_seq, rwkv6_state_shape, rwkv6_time_seq)

# ---------------------------------------------------------------------------
# Init
# ---------------------------------------------------------------------------

def _init_attn(generator, cfg: ModelConfig, dtype, device):
    d = cfg.d_model
    sc = 1.0 / math.sqrt(d)
    if cfg.attn_kind == "mla":
        r, h, dv = cfg.kv_lora_rank, cfg.n_heads, cfg.v_head_dim
        return {
            "w_dkv": init_normal((d, r), sc, generator, dtype, device),
            "w_kpe": init_normal((d, cfg.qk_rope_dim), sc, generator, dtype, device),
            "w_uk": init_normal((r, h, cfg.d_head), 1.0 / math.sqrt(r), generator, dtype, device),
            "w_uv": init_normal((r, h, dv), 1.0 / math.sqrt(r), generator, dtype, device),
            "w_q": init_normal((d, h, cfg.d_head + cfg.qk_rope_dim), sc, generator, dtype,
                               device),
            "w_o": init_normal((h * dv, d), 1.0 / math.sqrt(h * dv), generator, dtype, device),
        }
    return {
        "w_q": init_normal((d, cfg.q_dim), sc, generator, dtype, device),
        "w_k": init_normal((d, cfg.kv_dim), sc, generator, dtype, device),
        "w_v": init_normal((d, cfg.kv_dim), sc, generator, dtype, device),
        "w_o": init_normal((cfg.q_dim, d), 1.0 / math.sqrt(cfg.q_dim), generator, dtype, device),
    }


def init_layer(generator, cfg: ModelConfig, dtype=torch.bfloat16, device="cuda"):
    p: dict = {"norm1": init_norm(cfg.d_model, cfg.norm_kind, dtype, device),
               "norm2": init_norm(cfg.d_model, cfg.norm_kind, dtype, device)}
    if cfg.block_kind == "rwkv6":
        p["rwkv"] = init_rwkv6(generator, cfg.d_model, cfg.d_ff, dtype, device)
        return p
    p["attn"] = _init_attn(generator, cfg, dtype, device)
    if cfg.block_kind == "hybrid":
        p["mamba"] = init_mamba(generator, cfg.d_model, cfg.d_inner, cfg.ssm_state, dtype,
                                device)
        p["norm_attn_out"] = init_norm(cfg.d_model, "rmsnorm", dtype, device)
        p["norm_mamba_out"] = init_norm(cfg.d_model, "rmsnorm", dtype, device)
    if cfg.is_moe:
        p["moe"] = init_moe(generator, cfg, dtype, device)
    else:
        p["mlp"] = init_mlp(generator, cfg.d_model, cfg.d_ff, cfg.mlp_kind, dtype, device)
    return p


def init_params(cfg: ModelConfig, generator: torch.Generator, dtype=torch.bfloat16,
                device="cuda"):
    """Random weights with the reference's leaf names, shapes and scales.

    ``generator`` must live on ``device``. The numbers differ from the
    reference's ``jax.random`` ones; to compare the two, move the reference's
    weights over with ``convert.params_from_jax``."""
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


def _numel(tree) -> int:
    return sum(x.numel() for x in tree_leaves(tree))


def param_count(cfg: ModelConfig) -> int:
    """N from the init's shapes: ``init_params`` on the meta device, which
    allocates nothing (the reference's ``eval_shape``)."""
    return _numel(init_params(cfg, None, device="meta"))


def active_param_count(cfg: ModelConfig) -> int:
    """Params touched per token: MoE counts top-k routed + shared experts only."""
    n = param_count(cfg)
    if not cfg.is_moe:
        return n
    expert_total = cfg.n_layers * _numel(init_moe(None, cfg, torch.bfloat16, "meta")["experts"])
    return n - expert_total + expert_total * cfg.experts_per_token // cfg.n_experts


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------

def _attention_block(x, p, cfg: ModelConfig):
    """Full-sequence attention from position 0.  x: (B,S,D).  Returns the
    block's output and the layer's cache entries: the post-RoPE k and v, or
    under MLA the latent c_kv (B,S,r) and the post-RoPE k_pe (B,S,rope)."""
    b, s, d = x.shape
    pos = torch.arange(s, device=x.device)
    if cfg.attn_kind == "mla":
        h, dh, rope = cfg.n_heads, cfg.d_head, cfg.qk_rope_dim
        c_kv = x @ p["w_dkv"]                                               # (B,S,r)
        k_pe = apply_rope((x @ p["w_kpe"]).reshape(b, s, 1, rope), pos, cfg.rope_theta)
        k_c = (c_kv @ p["w_uk"].flatten(1)).reshape(b, s, h, dh)            # (B,S,H,dh)
        v = (c_kv @ p["w_uv"].flatten(1)).reshape(b, s, h, cfg.v_head_dim)
        q = (x @ p["w_q"].reshape(d, -1)).reshape(b, s, h, dh + rope)       # (B,S,H,dh+rope)
        q = torch.cat([q[..., :dh], apply_rope(q[..., dh:], pos, cfg.rope_theta)], dim=-1)
        k = torch.cat([k_c, k_pe.expand(b, s, h, rope)], dim=-1)
        o = chunked_attention(q, k, v, causal=cfg.causal, sliding_window=cfg.sliding_window,
                              logit_scale=1.0 / math.sqrt(dh + rope))
        return o.reshape(b, s, -1) @ p["w_o"], {"c_kv": c_kv, "k_pe": k_pe.reshape(b, s, rope)}
    q = (x @ p["w_q"]).reshape(b, s, cfg.n_heads, cfg.d_head)
    k = (x @ p["w_k"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    v = (x @ p["w_v"]).reshape(b, s, cfg.n_kv_heads, cfg.d_head)
    if cfg.rope:
        q = apply_rope(q, pos, cfg.rope_theta)
        k = apply_rope(k, pos, cfg.rope_theta)
    o = chunked_attention(q, k, v, causal=cfg.causal, sliding_window=cfg.sliding_window)
    return o.reshape(b, s, -1) @ p["w_o"], {"k": k, "v": v}


MOE_CHUNK_TOKENS = 65_536


def _mlp_block(x, p, cfg: ModelConfig):
    """The layer's MLP, dense or MoE.  x: (B,S,D)."""
    if not cfg.is_moe:
        return mlp(x, p["mlp"], cfg.mlp_kind)
    b, s, d = x.shape
    t = b * s
    flat = x.reshape(t, d)
    if t <= MOE_CHUNK_TOKENS:
        return moe_block(flat, p["moe"], cfg).reshape(b, s, d)
    # long inputs: route and dispatch in token chunks so that the capacity
    # buffers stay bounded (a capacity per chunk, as streaming MoE has it);
    # the last chunk is padded with zero tokens, as the reference pads it
    n_chunks = -(-t // MOE_CHUNK_TOKENS)
    pad = n_chunks * MOE_CHUNK_TOKENS - t
    if pad:
        flat = torch.cat([flat, flat.new_zeros((pad, d))])
    out = torch.cat([moe_block(c, p["moe"], cfg) for c in flat.split(MOE_CHUNK_TOKENS)])
    return out[:t].reshape(b, s, d)


def _mix(a, m, p, cfg: ModelConfig):
    """The hybrid layer's merge of its attention and Mamba branches."""
    return 0.5 * (apply_norm(a, p["norm_attn_out"], "rmsnorm", cfg.norm_eps)
                  + apply_norm(m, p["norm_mamba_out"], "rmsnorm", cfg.norm_eps))


def _layer(x, p, cfg: ModelConfig):
    """One pre-norm residual layer from a fresh state.  x: (B,S,D).  Also
    returns the layer's cache entries (before the window fit): k and v
    (post-RoPE) or MLA's c_kv and k_pe, and the recurrent states of the
    rwkv6 and Mamba blocks."""
    h = apply_norm(x, p["norm1"], cfg.norm_kind, cfg.norm_eps)
    if cfg.block_kind == "rwkv6":
        t_out, (tx, ts) = rwkv6_time_seq(h, p["rwkv"]["time"])
        x = x + t_out
        h = apply_norm(x, p["norm2"], cfg.norm_kind, cfg.norm_eps)
        c_out, cx = rwkv6_channel_seq(h, p["rwkv"]["channel"])
        return x + c_out, {"time_x": tx, "time_s": ts, "chan_x": cx}
    a, entries = _attention_block(h, p["attn"], cfg)
    if cfg.block_kind == "hybrid":
        m, (entries["ssm_h"], entries["ssm_conv"]) = mamba_seq(h, p["mamba"], cfg.ssm_state)
        a = _mix(a, m, p, cfg)
    x = x + a
    h = apply_norm(x, p["norm2"], cfg.norm_kind, cfg.norm_eps)
    return x + _mlp_block(h, p, cfg), entries


def layer_forward(x, p, cfg: ModelConfig):
    """One decoder layer, pre-norm residual.  x: (B,S,D)."""
    return _layer(x, p, cfg)[0]


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------

def embed_inputs(params, batch, cfg: ModelConfig):
    if "embeds" in batch:                      # audio / vlm stubbed frontend
        return batch["embeds"].to(params["embed"].dtype)
    return params["embed"][batch["tokens"]]


def forward(params, batch, cfg: ModelConfig, *, remat: bool = True, kv_chunk: int = 1024):
    """Token/embedding inputs -> final hidden states (B,S,D).

    Differentiable. With ``remat`` each layer runs under
    ``torch.utils.checkpoint`` (its activations are recomputed in the
    backward), where the reference wraps each layer in ``jax.remat``.
    ``kv_chunk`` is accepted as in the reference and unused: the flash kernel
    tiles by itself."""
    del kv_chunk
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
    """Mean next-token (or frame-classification) cross-entropy over the
    positions not labelled -100."""
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
    real one. The recurrent states are fp32 whatever ``dtype`` is."""
    l = cfg.n_layers

    def zeros(shape, dt):
        return torch.zeros((l,) + shape, dtype=dt, device=device)

    if cfg.block_kind == "rwkv6":
        return {"len": 0, "rwkv": {name: zeros(shape, dt) for name, (shape, dt)
                                   in rwkv6_state_shape(batch, cfg.d_model, dtype).items()}}
    w = cache_window(cfg, max_len)
    if cfg.attn_kind == "mla":
        return {"len": 0, "c_kv": zeros((batch, w, cfg.kv_lora_rank), dtype),
                "k_pe": zeros((batch, w, cfg.qk_rope_dim), dtype)}
    shape = (batch, w, cfg.n_kv_heads, cfg.d_head)
    cache = {"len": 0, "k": zeros(shape, dtype), "v": zeros(shape, dtype)}
    if cfg.block_kind == "hybrid":
        (h_shape, h_dt), (c_shape, c_dt) = mamba_state_shape(batch, cfg.d_inner, cfg.ssm_state,
                                                             dtype)
        cache["ssm_h"] = zeros(h_shape, h_dt)
        cache["ssm_conv"] = zeros(c_shape, c_dt)
    return cache


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


def _decode_mla_layer(x, p, cfg: ModelConfig, ckv_all, kpe_all, layer, pos, mask):
    """One-token MLA in the compressed space, with in-place cache insert at
    ``pos``.  x: (B,1,D); ckv_all (L,B,W,r) and kpe_all (L,B,W,rope); pos:
    (1,) int tensor; mask: (W,) bool, the slots up to ``pos``. The query is
    absorbed into w_uk and the context into w_uv, so no key or value of the
    cache is materialised; the scores go to fp32 for the softmax and the
    probabilities back to the cache's dtype, as in the reference."""
    b = x.shape[0]
    h, dh, rope = cfg.n_heads, cfg.d_head, cfg.qk_rope_dim
    c_kv = x @ p["w_dkv"]                                               # (B,1,r)
    k_pe = apply_rope((x @ p["w_kpe"]).reshape(b, 1, 1, rope), pos, cfg.rope_theta)
    ckv_all[layer].index_copy_(1, pos, c_kv.to(ckv_all.dtype))
    kpe_all[layer].index_copy_(1, pos, k_pe.reshape(b, 1, rope).to(kpe_all.dtype))
    ckv, kpe = ckv_all[layer], kpe_all[layer]
    q = (x[:, 0] @ p["w_q"].flatten(1)).reshape(b, h, dh + rope)          # (B,H,dh+rope)
    q_pe = apply_rope(q[:, None, :, dh:], pos, cfg.rope_theta)[:, 0]
    q_c = torch.einsum("bhd,rhd->bhr", q[..., :dh], p["w_uk"])
    scores = (torch.einsum("bhr,bsr->bhs", q_c, ckv)
              + torch.einsum("bhe,bse->bhs", q_pe, kpe)) * (1.0 / math.sqrt(dh + rope))
    pr = torch.softmax(torch.where(mask, scores.float(), -1e30), dim=-1)
    ctx = torch.einsum("bhs,bsr->bhr", pr.to(ckv.dtype), ckv)
    o = torch.einsum("bhr,rhd->bhd", ctx, p["w_uv"]).reshape(b, 1, -1)
    return o @ p["w_o"]


def decode_step(params, cache, tokens, cfg: ModelConfig):
    """One decoding step.  tokens: (B,) int (or (B,1,D) embeds).  Returns
    (logits (B,V) fp32, cache); the cache's tensors are updated in place and
    its ``len`` is one more."""
    if tokens.ndim == 1:
        x = params["embed"][tokens[:, None]]
    else:
        x = tokens.to(params["embed"].dtype)
    pos = cache["len"]
    if cfg.block_kind == "rwkv6":
        st = cache["rwkv"]
        for layer, p in enumerate(params["layers"]):
            h = apply_norm(x, p["norm1"], cfg.norm_kind, cfg.norm_eps)
            t_out, (tx, ts) = rwkv6_time_seq(h, p["rwkv"]["time"], st["time_x"][layer],
                                             st["time_s"][layer])
            x = x + t_out
            h = apply_norm(x, p["norm2"], cfg.norm_kind, cfg.norm_eps)
            c_out, cx = rwkv6_channel_seq(h, p["rwkv"]["channel"], st["chan_x"][layer])
            x = x + c_out
            for name, new in (("time_x", tx), ("time_s", ts), ("chan_x", cx)):
                st[name][layer].copy_(new)
    else:
        dev = x.device
        pos_t = torch.tensor([pos], device=dev)
        if cfg.attn_kind == "mla":
            mask = torch.arange(cache["c_kv"].shape[2], device=dev) <= pos

            def attend(h, p, layer):
                return _decode_mla_layer(h, p, cfg, cache["c_kv"], cache["k_pe"], layer, pos_t,
                                         mask)
        else:
            w = cache["k"].shape[2]
            slot = torch.tensor([pos % w], device=dev)
            n_valid = torch.full((x.shape[0],), min(pos + 1, w), dtype=torch.int32, device=dev)

            def attend(h, p, layer):
                return _decode_attn_layer(h, p, cfg, cache["k"], cache["v"], layer, pos_t, slot,
                                          n_valid)
        for layer, p in enumerate(params["layers"]):
            h = apply_norm(x, p["norm1"], cfg.norm_kind, cfg.norm_eps)
            a = attend(h, p["attn"], layer)
            if cfg.block_kind == "hybrid":
                m, (sh, sc) = mamba_step(h, p["mamba"], cfg.ssm_state,
                                         (cache["ssm_h"][layer], cache["ssm_conv"][layer]))
                a = _mix(a, m, p, cfg)
                cache["ssm_h"][layer].copy_(sh)
                cache["ssm_conv"][layer].copy_(sc)
            x = x + a
            h = apply_norm(x, p["norm2"], cfg.norm_kind, cfg.norm_eps)
            x = x + _mlp_block(h, p, cfg)
    x = apply_norm(x, params["final_norm"], cfg.norm_kind, cfg.norm_eps)
    logits = (x[:, 0] @ lm_head_weights(params, cfg)).float()
    return logits, {**cache, "len": pos + 1}


def prefill(params, batch, cfg: ModelConfig, max_len: int, *, dtype=torch.bfloat16):
    """Run the prompt through the model, filling a cache of ``dtype`` (the
    recurrent states fp32).  Returns (final hidden (B,S,D), cache)."""
    x = embed_inputs(params, batch, cfg)
    b, s, _ = x.shape
    w = cache_window(cfg, max_len)
    cache = zero_cache(cfg, b, max_len, dtype, x.device)
    states = cache["rwkv"] if cfg.block_kind == "rwkv6" else cache
    for layer, p in enumerate(params["layers"]):
        x, entries = _layer(x, p, cfg)
        for name, t in entries.items():
            if name in _WINDOWED:
                t = _fit_window(t, w, dtype)
            states[name][layer] = t
    cache["len"] = s
    x = apply_norm(x, params["final_norm"], cfg.norm_kind, cfg.norm_eps)
    return x, cache


_WINDOWED = ("k", "v", "c_kv", "k_pe")     # the cache entries with a position axis


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
