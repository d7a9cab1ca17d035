"""Mixed-precision optimizer: AdamW and the Adafactor-factored variant.

The PyTorch counterpart of ``repro/optim/adam.py``. The fp32 master and the
moments are the paper's host-resident optimizer copy; in this slice they live
on the device with the parameters (``placement="device"``), and
``placement="host"`` raises until the host-offloaded copy is ported.

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
    placement: str = "device"      # device | host (not ported yet)


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


def _check_placement(cfg: OptConfig) -> None:
    if cfg.placement != "device":
        raise NotImplementedError(
            f"optimizer placement {cfg.placement!r} is not ported yet: the port keeps the "
            "fp32 master and moments on the device (ROADMAP.md, Queue 1, item 10)")


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
    master = tree_map(lambda p: p.detach().to(cfg.master_dtype, copy=True), params)
    step = torch.zeros((), dtype=torch.int32, device=tree_leaves(params)[0].device)
    if cfg.mode == "adamw":
        zeros = lambda p: torch.zeros(p.shape, dtype=torch.float32, device=p.device)  # noqa: E731
        return {"master": master, "m": tree_map(zeros, params), "v": tree_map(zeros, params),
                "step": step}

    def vrow(p):
        shape = p.shape[:-1] if _factored(p.shape) else p.shape
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    def vcol(p):
        shape = p.shape[:-2] + p.shape[-1:] if _factored(p.shape) else (1,)
        return torch.zeros(shape, dtype=torch.float32, device=p.device)

    return {"master": master,
            "m": tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device),
                          params),
            "vr": tree_map(vrow, params), "vc": tree_map(vcol, params), "step": step}


def global_grad_norm(grads):
    """sqrt of the sum over leaves of each leaf's sum of squares, in fp32."""
    return torch.sqrt(sum(torch.sum(torch.square(g.float())) for g in tree_leaves(grads)))


def _f32(x, device):
    return torch.tensor(x, dtype=torch.float32, device=device)


@torch.no_grad()
def apply_updates(opt_state, grads, cfg: OptConfig, param_like=None, grad_norm=None):
    """Returns (new_params, opt_state, metrics); ``opt_state``'s tensors are
    updated in place and the same dict is returned with the step advanced.

    Clipping to ``cfg.grad_clip`` by the global norm (``grad_norm``
    overrides it), bias correction, decoupled weight decay. ``param_like``
    (a params tree) fixes each returned parameter's dtype, bf16 everywhere
    by default; a returned fp32 parameter is a copy of the master, never the
    master itself."""
    _check_placement(cfg)
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
        def upd(master, g, m, vr, vc):
            g = g.float() * scale
            mf = cfg.b1 * m.float() + (1 - cfg.b1) * g
            g2 = torch.square(g) + 1e-30
            if _factored(g.shape):
                vr.copy_(cfg.b2 * vr + (1 - cfg.b2) * g2.mean(dim=-1))
                vc.copy_(cfg.b2 * vc + (1 - cfg.b2) * g2.mean(dim=-2))
                denom = torch.sqrt(vr[..., None] * vc[..., None, :]
                                   / torch.clamp(vr.mean(dim=-1, keepdim=True)[..., None],
                                                 min=1e-30)) + cfg.eps
            else:
                vr.copy_(cfg.b2 * vr + (1 - cfg.b2) * g2)
                denom = torch.sqrt(vr) + cfg.eps
            master.copy_(master - cfg.lr * (mf / denom + cfg.weight_decay * master))
            m.copy_(mf.to(torch.bfloat16))

        tree_map(upd, opt_state["master"], grads, opt_state["m"], opt_state["vr"],
                 opt_state["vc"])
    opt_state["step"] = step
    if param_like is not None:
        params = tree_map(lambda x, p: x.to(p.dtype, copy=True), opt_state["master"], param_like)
    else:
        params = tree_map(lambda x: x.to(torch.bfloat16), opt_state["master"])
    return params, opt_state, {"grad_norm": gnorm, "step": step}
