"""Mixed-precision optimizer: AdamW and the Adafactor-factored variant.

The PyTorch counterpart of ``repro/optim/adam.py``. The fp32 master and the
moments are the paper's host-resident optimizer copy. With
``placement="device"`` they live on the device with the parameters; with
``placement="host"`` they live in CPU memory (pinned when a card is present,
so copies to and from it are asynchronous DMA) and ``apply_updates`` runs on
the CPU, taking the gradients to the host and returning the new parameters
there (``optim.async_opt.HostAsyncRoundPipe`` uploads them).

Trees are nested dicts and lists of tensors, as the port's parameters are.
``apply_updates`` updates the optimizer state's tensors IN PLACE (the
reference returns new arrays): at full width the master and the moments are
~21 GB, and a functional update would hold two copies at once. The
arithmetic is the reference's, operation for operation, in fp32.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class OptConfig:
    mode: str = "adamw"            # adamw | adafactor
    lr: float = 1e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.0
    grad_clip: float = 1.0
    master_dtype: Any = torch.float32
    placement: str = "device"      # device | host (pinned CPU memory)


def tree_map(fn, tree, *rest):
    """``fn`` over the leaves of nested dicts and lists, with the matching
    leaves of ``rest`` as further arguments."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest)) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_map(fn, v, *(r[i] for r in rest)) for i, v in enumerate(tree)]
    return fn(tree, *rest)


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def _factored(shape) -> bool:
    return len(shape) >= 2 and shape[-1] > 1 and shape[-2] > 1


def _layer_list(tree):
    """The list of per-layer trees under ``tree["layers"]``, or None. The
    reference stacks these into one (L, ...) pool, which Adafactor factors
    leaf by leaf; the port's list is factored as that stack would be."""
    layers = tree.get("layers") if isinstance(tree, dict) else None
    return layers if isinstance(layers, list) and layers else None


def _check_placement(cfg: OptConfig) -> None:
    if cfg.placement not in ("device", "host"):
        raise ValueError(f"unknown optimizer placement {cfg.placement!r}; expected "
                         "device|host")


def _allocator(cfg: OptConfig):
    """``new(shape, dtype, device)`` -> zeros where ``cfg.placement`` keeps the
    optimizer state: on ``device``, or in CPU memory, pinned when a card is
    present (so copies between it and the card are asynchronous DMA)."""
    if cfg.placement == "device":
        return lambda shape, dtype, device: torch.zeros(shape, dtype=dtype, device=device)
    pin = torch.cuda.is_available()
    return lambda shape, dtype, device: torch.zeros(shape, dtype=dtype, pin_memory=pin)


# ---------------------------------------------------------------------------
# Frozen-base masking (LoRA / adapter fine-tuning)
# ---------------------------------------------------------------------------

def trainable_leaves(tree, mask):
    """Prune ``tree`` to the ``mask``-True leaves; dict nodes whose every
    leaf is frozen are dropped, so the result is exactly the trainable
    substructure. ``mask`` has ``tree``'s structure with bools for leaves."""
    if isinstance(tree, dict):
        out = {}
        for k in tree:
            sub = trainable_leaves(tree[k], mask[k])
            if sub is not None:
                out[k] = sub
        return out or None
    return tree if mask else None


def merge_trainable(full, trainable, mask):
    """Inverse of :func:`trainable_leaves`: graft updated trainable leaves
    back into the full tree; mask-False leaves pass through untouched."""
    if isinstance(full, dict):
        sub = trainable or {}
        return {k: merge_trainable(full[k], sub.get(k), mask[k]) for k in full}
    if mask:
        if trainable is None:
            raise ValueError("mask marks a leaf trainable but the updated "
                             "subtree does not provide it")
        return trainable
    return full


# ---------------------------------------------------------------------------
# State and update
# ---------------------------------------------------------------------------

def init_opt_state(params, cfg: OptConfig):
    """master (a real fp32 copy, never a view of an fp32 parameter) + first
    and second moments (+ step counter)."""
    _check_placement(cfg)
    new = _allocator(cfg)
    master = tree_map(lambda p: new(p.shape, cfg.master_dtype, p.device).copy_(p.detach()),
                      params)
    step = new((), torch.int32, tree_leaves(params)[0].device)
    if cfg.mode == "adamw":
        zeros = lambda p: new(p.shape, torch.float32, p.device)  # noqa: E731
        return {"master": master, "m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": step}

    def vrow(shape, device):
        shape = shape[:-1] if _factored(shape) else shape
        return new(shape, torch.float32, device)

    def vcol(shape, device):
        shape = shape[:-2] + shape[-1:] if _factored(shape) else (1,)
        return new(shape, torch.float32, device)

    vr = tree_map(lambda p: vrow(p.shape, p.device), params)
    vc = tree_map(lambda p: vcol(p.shape, p.device), params)
    layers = _layer_list(params)
    if layers:   # one factored pair per leaf over the stacked (L, ...) pool
        def stacked(fn):
            return tree_map(lambda p, *_: fn((len(layers), *p.shape), p.device), *layers)
        vr["layers"], vc["layers"] = stacked(vrow), stacked(vcol)
    return {"master": master,
            "m": tree_map(lambda p: new(p.shape, torch.bfloat16, p.device), params),
            "vr": vr, "vc": vc, "step": step}


def global_grad_norm(grads):
    """sqrt of the sum over leaves of each leaf's sum of squares, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))


def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def apply_updates(opt_state, grads, cfg: OptConfig, param_like=None, grad_norm=None, out=None):
    """Returns (new_params, opt_state, metrics); ``opt_state``'s tensors are
    updated in place and the same dict is returned with the step advanced.

    Clipping to ``cfg.grad_clip`` by the global norm (``grad_norm``
    overrides it), bias correction, decoupled weight decay. ``param_like``
    (a params tree) fixes each returned parameter's dtype, bf16 everywhere
    by default; a returned fp32 parameter is a copy of the master, never the
    master itself. ``out`` (a params tree) receives the new parameters in
    place, cast to its own dtypes, and is returned in place of fresh tensors.
    With ``cfg.placement="host"`` the update runs where the state lives, on
    the CPU: the gradients (and ``grad_norm``) are taken there first."""
    _check_placement(cfg)
    home = opt_state["step"].device
    if cfg.placement == "host":
        grads = tree_map(lambda g: g.to(home), grads)
        if grad_norm is not None:
            grad_norm = grad_norm.to(home)
    step = opt_state["step"] + 1
    gnorm = global_grad_norm(grads) if grad_norm is None else grad_norm
    dev = step.device
    if cfg.grad_clip:
        scale = torch.minimum(_f32(1.0, dev), cfg.grad_clip / torch.clamp(gnorm, min=1e-12))
    else:
        scale = _f32(1.0, dev)
    t = step.float()
    if cfg.mode == "adamw":
        bc1 = 1.0 - _f32(cfg.b1, dev) ** t
        bc2 = 1.0 - _f32(cfg.b2, dev) ** t

        def upd(master, g, m, v):
            g = g.float() * scale
            m.copy_(cfg.b1 * m + (1 - cfg.b1) * g)
            v.copy_(cfg.b2 * v + (1 - cfg.b2) * torch.square(g))
            u = (m / bc1) / (torch.sqrt(v / bc2) + cfg.eps)
            master.copy_(master - cfg.lr * (u + cfg.weight_decay * master))

        tree_map(upd, opt_state["master"], grads, opt_state["m"], opt_state["v"])
    else:
        def denom_of(g, vr, vc):
            """The factored (or, for vectors, plain) second moment's update
            in place, and the update's denominator."""
            g2 = torch.square(g) + 1e-30
            if _factored(g.shape):
                vr.copy_(cfg.b2 * vr + (1 - cfg.b2) * g2.mean(dim=-1))
                vc.copy_(cfg.b2 * vc + (1 - cfg.b2) * g2.mean(dim=-2))
                return torch.sqrt(vr[..., None] * vc[..., None, :]
                                  / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None],
                                                min=1e-30)) + cfg.eps
            vr.copy_(cfg.b2 * vr + (1 - cfg.b2) * g2)
            return torch.sqrt(vr) + cfg.eps

        def step_leaf(master, g, m, denom):
            mf = cfg.b1 * m.float() + (1 - cfg.b1) * g
            master.copy_(master - cfg.lr * (mf / denom + cfg.weight_decay * master))
            m.copy_(mf.to(torch.bfloat16))

        def upd(master, g, m, vr, vc):
            g = g.float() * scale
            step_leaf(master, g, m, denom_of(g, vr, vc))

        def upd_layers(vr, vc, *per_layer):
            """One leaf of every layer: L masters, then L grads, then L first
            moments."""
            n = len(per_layer) // 3
            masters, gs, ms = per_layer[:n], per_layer[n:2 * n], per_layer[2 * n:]
            if masters[0].ndim < 2:
                # a vector per layer is a matrix of the pool: factored across layers
                g = torch.stack([x.float() for x in gs]) * scale
                denom = denom_of(g, vr, vc)
                for i, (master, m) in enumerate(zip(masters, ms)):
                    step_leaf(master, g[i], m, denom[i])
                return
            for i, (master, g, m) in enumerate(zip(masters, gs, ms)):
                # the stacked and the per-layer factorings of a matrix coincide
                g = g.float() * scale
                step_leaf(master, g, m, denom_of(g, vr[i], vc[i] if _factored(g.shape) else vc))

        layers = _layer_list(opt_state["master"])
        trees = [opt_state["master"], grads, opt_state["m"], opt_state["vr"], opt_state["vc"]]
        if layers:
            trees = [{k: v for k, v in tree.items() if k != "layers"} for tree in trees]
        tree_map(upd, *trees)
        if layers:
            tree_map(upd_layers, opt_state["vr"]["layers"], opt_state["vc"]["layers"],
                     *layers, *grads["layers"], *opt_state["m"]["layers"])
    opt_state["step"] = step
    if out is not None:
        params = tree_map(lambda o, x: o.copy_(x), out, opt_state["master"])
    elif param_like is not None:
        params = tree_map(lambda x, p: x.to(p.dtype, copy=True), opt_state["master"], param_like)
    else:
        params = tree_map(lambda x: x.to(torch.bfloat16), opt_state["master"])
    return params, opt_state, {"grad_norm": gnorm, "step": step}
