"""Low-rank adapters (LoRA) over the layer pool.

The PyTorch counterpart of ``repro/models/lora.py``. The base model is
frozen: only rank-``r`` adapter factors train, so the ring's traveling
gradient buffer, its deposits and the optimizer state shrink from parameter
size to adapter size. This module owns the adapter math; the frozen-base
ring runs in :mod:`repro_torch.core.dispatch`.

Representation
--------------
The reference stacks its layers, so a targeted leaf is ``(L, din, dout)``
and its adapter ``{"A": (L, r, dout), "B": (L, din, r)}``. The port keeps
``params["layers"]`` as a list of per-layer dicts, and the adapters as a list
of per-layer dicts beside it: each targeted leaf ``(din, dout)`` of a layer
becomes ``{"A": (r, dout), "B": (din, r)}`` at the same path. The adapted
weight is

    W_eff = W + (alpha / r) * B @ A

with ``B`` zero-initialised (a fresh adapter is a bit-exact no-op) and ``A``
Gaussian. The adapter list pads, ships and deposits like the layer list.

Only a layer's matrices (rank-2 leaves, the reference's stacked rank-3 ones)
are adaptable; norm scales stay frozen. ``target_modules`` selects among them
by dotted path (``"attn"`` matches every ``attn.*`` matrix, ``"attn.w_q"``
exactly one). Paths come in the reference's flatten order (dict keys sorted).
"""
from __future__ import annotations

import dataclasses
import math

import torch

DEFAULT_TARGETS = ("attn", "mlp")


@dataclasses.dataclass(frozen=True)
class LoraConfig:
    rank: int = 8
    alpha: float = 16.0
    target_modules: tuple = DEFAULT_TARGETS

    def __post_init__(self):
        if self.rank < 1:
            raise ValueError(f"rank must be >= 1, got {self.rank}")
        object.__setattr__(self, "target_modules", tuple(self.target_modules))

    @property
    def scale(self) -> float:
        return self.alpha / self.rank


def _one_layer(layers):
    """One layer dict of ``layers`` (a layer list, or one layer dict)."""
    return layers[0] if isinstance(layers, list) else layers


def _paths(layer, prefix=""):
    """(dotted path, leaf) of one layer dict, dict keys sorted (the
    reference's ``tree_flatten_with_path`` order)."""
    out = []
    for k in sorted(layer):
        v, dotted = layer[k], f"{prefix}{k}"
        if isinstance(v, dict):
            out += _paths(v, dotted + ".")
        else:
            out.append((dotted, v))
    return out


def _matches(dotted: str, targets) -> bool:
    return any(dotted == t or dotted.startswith(t + ".") for t in targets)


def _adaptable(layer) -> list[str]:
    return [d for d, leaf in _paths(layer) if leaf.ndim == 2]


def target_leaf_paths(layers, cfg: LoraConfig) -> list[str]:
    """Dotted paths (within one layer) of the leaves ``cfg`` adapts, in the
    reference's flatten order. ``layers`` is the layer list or one layer
    dict (tensors, meta tensors included).

    Raises ValueError for a target that matches no adaptable leaf, so a
    typo'd or inapplicable module never trains fewer adapters than asked."""
    adaptable = _adaptable(_one_layer(layers))
    unmatched = [t for t in cfg.target_modules if not any(_matches(d, (t,)) for d in adaptable)]
    if unmatched:
        raise ValueError(f"target_modules {unmatched} match no matrix leaf of the layer pool "
                         f"(adaptable: {adaptable})")
    return [d for d in adaptable if _matches(d, cfg.target_modules)]


def _meta_layer(model_cfg):
    from . import transformer as T
    return T.init_layer(None, model_cfg, device="meta")


def applicable_targets(model_cfg, targets=DEFAULT_TARGETS) -> tuple:
    """The subset of ``targets`` that matches at least one adaptable leaf of
    ``model_cfg``'s layer; raises if nothing matches."""
    adaptable = _adaptable(_meta_layer(model_cfg))
    out = tuple(t for t in targets if any(_matches(d, (t,)) for d in adaptable))
    if not out:
        raise ValueError(f"none of {list(targets)} matches an adaptable matrix leaf of the "
                         f"layer pool (adaptable: {adaptable})")
    return out


def _is_pair(node) -> bool:
    return isinstance(node, dict) and set(node) == {"A", "B"}


def at_path(tree, dotted):
    """The node at dotted path ``dotted`` of nested dicts."""
    for k in dotted.split("."):
        tree = tree[k]
    return tree


def _put(tree, dotted, value):
    keys = dotted.split(".")
    for k in keys[:-1]:
        tree = tree.setdefault(k, {})
    tree[keys[-1]] = value


def init_adapters(generator, layers, cfg: LoraConfig, dtype=None):
    """Fresh adapters for the layer list ``layers``: one dict per layer with
    ``{"A", "B"}`` at each targeted leaf's path. ``B`` is zeros; ``A`` is
    Gaussian times ``1/sqrt(din)``, drawn from the seeded ``generator`` (on
    the layers' device) layer by layer, leaf by leaf in flatten order.
    ``dtype=None`` follows each base leaf's dtype."""
    targets = target_leaf_paths(layers, cfg)       # raises on dead targets
    out = []
    for layer in layers:
        ad: dict = {}
        for dotted in targets:
            w = at_path(layer, dotted)
            din, dout = w.shape
            dt = dtype or w.dtype
            a = torch.randn((cfg.rank, dout), generator=generator, dtype=torch.float32,
                            device=w.device) * (1.0 / math.sqrt(din))
            _put(ad, dotted, {"A": a.to(dt),
                              "B": torch.zeros((din, cfg.rank), dtype=dt, device=w.device)})
        out.append(ad)
    return out


def adapter_params_per_layer(model_cfg, cfg: LoraConfig) -> int:
    """Trainable parameters one layer's adapters hold: ``r * (din + dout)``
    summed over the targeted leaves (the cost model's ``trainable_bytes``)."""
    layer = _meta_layer(model_cfg)
    return sum(cfg.rank * sum(at_path(layer, d).shape) for d in target_leaf_paths(layer, cfg))


# ---------------------------------------------------------------------------
# Merge / unmerge
# ---------------------------------------------------------------------------

def _delta(pair, w, scale):
    """(alpha/r) B@A as the reference forms it: the product in fp32, times
    the scale, cast to the base leaf's dtype."""
    d = torch.matmul(pair["B"].float(), pair["A"].float()) * scale
    return d.reshape(w.shape).to(w.dtype)


def _merge_layer(base, ad, scale):
    out = dict(base)
    for k, v in ad.items():
        out[k] = base[k] + _delta(v, base[k], scale) if _is_pair(v) else \
            _merge_layer(base[k], v, scale)
    return out


def merge_layers(layers, adapters, cfg: LoraConfig, *, sign: float = 1.0):
    """``W + sign * (alpha/r) * B @ A`` leafwise, over a layer list (the
    pool, a worker's shard or a ring block, with the matching adapter list)
    or one layer dict (with its adapter dict). Differentiable in both."""
    scale = sign * cfg.scale
    if isinstance(layers, dict):
        return _merge_layer(layers, adapters, scale)
    if len(layers) != len(adapters):
        raise ValueError(f"{len(layers)} layers against {len(adapters)} adapter layers")
    return [_merge_layer(lw, aw, scale) for lw, aw in zip(layers, adapters)]


def merge_params(params, adapters, cfg: LoraConfig):
    """Dense single-program view: the base with every adapter folded in --
    the merged-dense reference the equivalence checks differentiate."""
    out = {k: v for k, v in params.items() if k != "lora"}
    out["layers"] = merge_layers(params["layers"], adapters, cfg)
    return out


def unmerge_params(params, adapters, cfg: LoraConfig):
    """Inverse of :func:`merge_params`: subtract the adapter deltas."""
    out = {k: v for k, v in params.items() if k != "lora"}
    out["layers"] = merge_layers(params["layers"], adapters, cfg, sign=-1.0)
    return out


# ---------------------------------------------------------------------------
# Optimizer mask
# ---------------------------------------------------------------------------

def opt_mask(adapters):
    """All-True tree over the adapters: the structure of the gradients the
    frozen-base ring deposits."""
    if isinstance(adapters, dict):
        return {k: opt_mask(v) for k, v in adapters.items()}
    if isinstance(adapters, list):
        return [opt_mask(v) for v in adapters]
    return True


def param_mask(params) -> dict:
    """Boolean tree over a roundpipe param dict: True on the adapters (the
    ``"lora"`` subtree), False on every frozen base leaf. Structural over
    dict nodes, as the reference's: anything else is a leaf, so the layer
    list and the adapter list are each one leaf of the mask. Feed to
    ``optim.trainable_leaves`` for the adapter-only optimizer state."""
    def fill(node, v):
        if isinstance(node, dict):
            return {k: fill(sub, v) for k, sub in node.items()}
        return v

    return {k: fill(sub, k == "lora") for k, sub in params.items()}
