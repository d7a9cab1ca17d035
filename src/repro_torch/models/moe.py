"""Mixture-of-Experts block: top-k routing with sort-based capacity dispatch.

The PyTorch counterpart of ``repro/models/moe.py``. Expert compute scales
with the active experts, not all E: the (token, choice) assignments are
sorted by expert, packed into per-expert capacity buffers with gathers (no
(T,E) one-hot products), run through the experts as one batched product, and
summed back per token with ``index_add``. An assignment past its expert's
capacity is dropped (the standard capacity-factor rule): it lands in a junk
slot whose output is zero. Shared experts (DeepSeek-V2) run as one dense
MLP. No Pallas kernel is involved, so this module is plain PyTorch.

The capacity slot of an assignment is its rank within its expert's group in
token order, so the sort must be stable, as ``jnp.argsort`` is.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from .layers import init_mlp, init_normal, mlp


def expert_capacity(n_tokens: int, n_experts: int, k: int, capacity_factor: float) -> int:
    return max(1, int(math.ceil(n_tokens * k / n_experts * capacity_factor)))


def _experts(h, w, kind):
    """The experts' MLPs over their capacity buffers: h (E,C,D) -> (E,C,D)."""
    if kind in ("swiglu", "geglu"):
        act = F.silu if kind == "swiglu" else (lambda a: F.gelu(a, approximate="tanh"))
        h = act(torch.bmm(h, w["w_gate"])) * torch.bmm(h, w["w_up"])
    elif kind == "relu2":
        h = torch.square(F.relu(torch.bmm(h, w["w_up"])))
    else:   # jax.nn.gelu defaults to the tanh approximation
        h = F.gelu(torch.bmm(h, w["w_up"]), approximate="tanh")
    return torch.bmm(h, w["w_down"])


def moe_block(x, p, cfg):
    """x: (T, D) flattened tokens -> (T, D).  p: router/experts/(shared)."""
    t, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    cap = expert_capacity(t, e, k, cfg.capacity_factor)
    dev = x.device

    logits = (x @ p["router"]).float()                                  # (T, E)
    top_w, top_i = torch.topk(logits, k, dim=-1)                        # (T, k)
    top_w = torch.softmax(top_w, dim=-1)

    flat_expert = top_i.reshape(-1)                                     # (T*k,)
    flat_token = torch.arange(t, device=dev).repeat_interleave(k)
    flat_w = top_w.reshape(-1)

    # sort assignments by expert; the position within the expert's group is
    # the capacity slot, and positions past the capacity are dropped
    order = torch.argsort(flat_expert, stable=True)
    se, stok, sw = flat_expert[order], flat_token[order], flat_w[order]
    group_start = torch.searchsorted(se, torch.arange(e, device=dev))
    pos = torch.arange(t * k, device=dev) - group_start[se]
    keep = pos < cap
    slot = torch.where(keep, se * cap + pos, e * cap)                   # drop -> junk slot

    # every kept slot is written once; only the junk slot is written twice
    buf = x.new_zeros((e * cap + 1, d)).index_copy(0, slot, x[stok])
    h = _experts(buf[: e * cap].reshape(e, cap, d), p["experts"], cfg.mlp_kind)

    out_slots = torch.cat([h.reshape(e * cap, d), h.new_zeros((1, d))])  # junk slot -> 0
    contrib = out_slots[slot] * (sw * keep)[:, None].to(h.dtype)
    out = x.new_zeros((t, d)).index_add(0, stok, contrib.to(x.dtype))

    if "shared" in p:                                                   # DeepSeek shared experts
        out = out + mlp(x, p["shared"], cfg.mlp_kind)
    return out


def init_moe(generator, cfg, dtype, device="cuda"):
    """The reference's leaves and scales; weights are (in, out) per expert."""
    d, e, f = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    sc_in, sc_out = 1.0 / math.sqrt(d), 1.0 / math.sqrt(f)
    experts = {"w_up": init_normal((e, d, f), sc_in, generator, dtype, device),
               "w_down": init_normal((e, f, d), sc_out, generator, dtype, device)}
    if cfg.mlp_kind in ("swiglu", "geglu"):
        experts["w_gate"] = init_normal((e, d, f), sc_in, generator, dtype, device)
    p = {"router": init_normal((d, e), 1.0 / math.sqrt(d), generator, dtype, device),
         "experts": experts}
    if cfg.n_shared_experts:
        p["shared"] = init_mlp(generator, d, cfg.n_shared_experts * cfg.moe_d_ff,
                               cfg.mlp_kind, dtype, device)
    return p


def aux_load_balance_loss(x, router, cfg):
    """Switch-style auxiliary loss (fraction-dispatched x router-prob)."""
    logits = (x @ router).float()
    probs = torch.softmax(logits, dim=-1)
    _, top_i = torch.topk(logits, cfg.experts_per_token, dim=-1)
    onehot = F.one_hot(top_i, cfg.n_experts).sum(dim=1).float()
    frac_tokens = onehot.mean(dim=0)
    frac_prob = probs.mean(dim=0)
    return cfg.n_experts * torch.sum(frac_tokens * frac_prob)
