"""Move weights, and the roundpipe train state, between the reference's
trees and the port's.

The reference stacks its layers along a leading axis (one pytree whose
leaves are (L, ...)); the port keeps a list of per-layer dicts. Both keep
weights as (in, out), so no leaf is transposed. Trees cross between the two
as nested dicts of numpy arrays.
"""
from __future__ import annotations

import numpy as np
import torch

_DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16, "float16": torch.float16}


def _leaf(a, dtype, device):
    a = np.asarray(a)
    # np.asarray of a JAX bf16 array is an ml_dtypes.bfloat16 array, which
    # torch.from_numpy refuses; float32 holds every bf16 value exactly.
    t = torch.from_numpy(np.array(a, dtype=np.float32))
    return t.to(device=device, dtype=dtype or _DTYPES[a.dtype.name])


def _map(fn, node):
    return {k: _map(fn, v) for k, v in node.items()} if isinstance(node, dict) else fn(node)


def params_from_jax(tree, *, dtype=None, device="cuda"):
    """The reference's parameters (nested dicts of numpy arrays, layers
    stacked) -> the port's (layers as a list). Each leaf keeps its dtype
    unless ``dtype`` is given."""
    out = {k: _map(lambda a: _leaf(a, dtype, device), v)
           for k, v in tree.items() if k != "layers"}
    stacked = tree["layers"]
    n_layers = len(next(iter(_leaves(stacked))))
    out["layers"] = [_map(lambda a, i=i: _leaf(np.asarray(a)[i], dtype, device), stacked)
                     for i in range(n_layers)]
    return out


def params_to_numpy(params):
    """The port's parameters -> the reference's layout as float32 numpy
    arrays (bf16 values are exact in float32), layers stacked on axis 0."""
    def f32(t):
        return t.detach().to(device="cpu", dtype=torch.float32).numpy()

    out = {k: _map(f32, v) for k, v in params.items() if k != "layers"}
    per_layer = [_map(f32, p) for p in params["layers"]]
    out["layers"] = _stack(per_layer)
    return out


_STATE_TREES = ("master", "m", "v")


def state_from_jax(state, *, device="cuda"):
    """The reference's roundpipe train state (``init_roundpipe_state``:
    ``{"params", "opt": {"master", "m", "v", "step"}}``, pool padded to
    ``pool_rows``, as nested dicts of numpy arrays) -> the port's, each leaf
    in its own dtype and the padding rows kept as zero layers. AdamW state
    only: the reference's Adafactor factors its stacked (L, d) leaves across
    layers, which per-layer leaves cannot hold."""
    opt = state["opt"]
    if set(opt) != {*_STATE_TREES, "step"}:
        raise NotImplementedError(f"optimizer state with {sorted(opt)}: only AdamW's "
                                  "{master, m, v, step} converts")
    out = {k: params_from_jax(opt[k], device=device) for k in _STATE_TREES}
    out["step"] = torch.tensor(int(np.asarray(opt["step"])), dtype=torch.int32, device=device)
    return {"params": params_from_jax(state["params"], device=device), "opt": out}


def state_to_numpy(state):
    """The port's roundpipe train state -> the reference's layout as float32
    numpy arrays (layers stacked on axis 0), with an int32 step."""
    opt = {k: params_to_numpy(state["opt"][k]) for k in _STATE_TREES}
    opt["step"] = np.asarray(int(state["opt"]["step"]), np.int32)
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
