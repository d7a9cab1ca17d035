"""Move weights, and the roundpipe train state, between the reference's
trees and the port's.

The reference stacks its layers along a leading axis (one pytree whose
leaves are (L, ...)); the port keeps a list of per-layer dicts. The LoRA
adapter pool (``"lora"``) is stacked and listed the same way. Both keep
weights as (in, out), so no leaf is transposed. Trees cross between the two
as nested dicts of numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}
_POOLED = ("layers", "lora")     # stacked on the reference's side, lists on the port's


def _leaf(a, dtype, device):
    a = np.asarray(a)
    # np.asarray of a JAX bf16 array is an ml_dtypes.bfloat16 array, which
    # torch.from_numpy refuses; float32 holds every bf16 value exactly.
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=device, dtype=dtype or _DTYPES[a.dtype.name])


def _map(fn, node):
    return {k: _map(fn, v) for k, v in node.items()} if isinstance(node, dict) else fn(node)


def params_from_jax(tree, *, dtype=None, device="cuda"):
    """The reference's parameters (nested dicts of numpy arrays, the layer
    and adapter pools stacked) -> the port's (each pool a list of per-layer
    dicts). Each leaf keeps its dtype unless ``dtype`` is given. A tree
    without a layer pool (an adapter-only optimizer tree) converts too."""
    out = {}
    for k, v in tree.items():
        if k not in _POOLED:
            out[k] = _map(lambda a: _leaf(a, dtype, device), v)
            continue
        n_layers = len(next(iter(_leaves(v))))
        out[k] = [_map(lambda a, i=i: _leaf(np.asarray(a)[i], dtype, device), v)
                  for i in range(n_layers)]
    return out


def params_to_numpy(params):
    """The port's parameters -> the reference's layout as float32 numpy
    arrays (bf16 values are exact in float32), each pool stacked on axis 0."""
    def f32(t):
        return t.detach().to(device="cpu", dtype=torch.float32).numpy()

    return {k: _stack([_map(f32, p) for p in v]) if k in _POOLED else _map(f32, v)
            for k, v in params.items()}


_STATE_TREES = {"adamw": ("master", "m", "v"), "adafactor": ("master", "m")}
_FACTORS = ("vr", "vc")     # Adafactor's statistics: the layer pool's stay stacked


def _opt_mode(opt) -> str:
    keys = set(opt) - {"grad_residual", "step"}
    for mode, trees in _STATE_TREES.items():
        if keys == set(trees) | (set(_FACTORS) if mode == "adafactor" else set()):
            return mode
    raise NotImplementedError(f"optimizer state with {sorted(opt)}: only AdamW's "
                              "{master, m, v, step} and Adafactor's {master, m, vr, vc, "
                              "step}, with or without grad_residual, convert")


def state_from_jax(state, *, device="cuda"):
    """The reference's roundpipe train state (``init_roundpipe_state``:
    ``{"params", "opt": {"master", "m", "v", "step"}}`` for AdamW or ``{...,
    "opt": {"master", "m", "vr", "vc", "step"}}`` for Adafactor, pool padded
    to ``pool_rows``, as nested dicts of numpy arrays) -> the port's, each leaf
    in its own dtype and the padding rows kept as zero layers. Adafactor's
    factored statistics keep the reference's layout, the layer pool's stacked
    (L, ...), as ``optim.adam.init_opt_state`` keeps them. The
    error-feedback residual ``opt["grad_residual"]`` (stacked like the pool)
    becomes a list of fp32 layer dicts. A LoRA state (``params["lora"]``)
    converts with optimizer trees that hold ``{"lora"}`` only and an
    adapter-shaped residual."""
    opt = state["opt"]
    mode = _opt_mode(opt)
    out = {k: params_from_jax(opt[k], device=device) for k in _STATE_TREES[mode]}
    if mode == "adafactor":
        out.update({k: _map(lambda a: _leaf(a, None, device), opt[k]) for k in _FACTORS})
    out["step"] = torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32, device=device)
    if "grad_residual" in opt:
        out["grad_residual"] = params_from_jax({"layers": opt["grad_residual"]},
                                               device=device)["layers"]
    return {"params": params_from_jax(state["params"], device=device), "opt": out}


def state_to_numpy(state):
    """The port's roundpipe train state -> the reference's layout as float32
    numpy arrays (layers stacked on axis 0), with an int32 step and, when the
    state has one, the stacked residual."""
    mode = _opt_mode(state["opt"])
    opt = {k: params_to_numpy(state["opt"][k]) for k in _STATE_TREES[mode]}
    if mode == "adafactor":
        opt.update({k: _map(lambda t: t.detach().to(device="cpu", dtype=torch.float32).numpy(),
                            state["opt"][k]) for k in _FACTORS})
    opt["step"] = np.asarray(int(state["opt"]["step"]), np.int32)
    if "grad_residual" in state["opt"]:
        opt["grad_residual"] = params_to_numpy({"layers": state["opt"]["grad_residual"]})[
            "layers"]
    return {"params": params_to_numpy(state["params"]), "opt": opt}


def _stack(trees):
    first = trees[0]
    if isinstance(first, dict):
        return {k: _stack([t[k] for t in trees]) for k in first}
    return np.stack(trees)


def _leaves(node):
    if isinstance(node, dict):
        for v in node.values():
            yield from _leaves(v)
    else:
        yield node
