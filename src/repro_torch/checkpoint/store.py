"""Atomic, resumable checkpoints of the port's train state, in the
reference's on-disk form.

The PyTorch counterpart of ``repro/checkpoint/store.py`` (``save_checkpoint``,
``latest_step``, ``load_checkpoint``, ``CheckpointManager``), and the two
packages read each other's checkpoints:

  * one ``.npy`` file a leaf and a ``manifest.json`` (each leaf's path, file,
    shape and dtype, and the step), written into a ``.tmp-<step>``
    directory that an atomic ``os.replace`` renames to ``step_<step>`` after
    the manifest: a checkpoint without a manifest is invisible, so a crash
    mid-write never hides the newest restorable state;
  * the leaves in the reference's layout: the port's lists of per-layer
    dicts (``params["layers"]``, ``params["lora"]``, their optimizer mirrors
    and ``opt["grad_residual"]``) stacked on axis 0, paths in
    ``jax.tree_util.keystr`` form (``['params']['layers']['attn']['w_q']``,
    ``['opt']['step']``), dict keys in sorted order, each leaf in its own
    dtype. A bf16 leaf is written as its raw 2-byte words with manifest
    dtype ``"bfloat16"`` (numpy has no bf16); the reference's loader views
    such an array as the manifest's dtype, and this one reads the
    reference's ``|V2`` words the same way;
  * retention keeps the newest ``keep`` checkpoints.

A pooled leaf is written and read one layer row at a time, so no stacked
copy of a pool is ever made on the device or the host.
"""
from __future__ import annotations

import json
import os
import shutil
from pathlib import Path

import numpy as np
import torch

_NP = {torch.float32: np.float32, torch.float64: np.float64, torch.float16: np.float16,
       torch.bfloat16: np.uint16, torch.int64: np.int64, torch.int32: np.int32,
       torch.int16: np.int16, torch.int8: np.int8, torch.uint8: np.uint8, torch.bool: np.bool_}
_TORCH = {str(t).removeprefix("torch."): t for t in _NP}


def _flatten(tree, prefix: str = "") -> dict:
    """path -> leaf, in ``jax.tree_util`` order (dict keys sorted). A list of
    per-layer trees is one stacked tree: its leaves are lists of row tensors."""
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flatten(tree[k], f"{prefix}[{k!r}]"))
        return out
    if isinstance(tree, list):
        return _flatten_rows(tree, prefix)
    return {prefix: tree}


def _flatten_rows(rows: list, prefix: str) -> dict:
    if not rows:
        raise ValueError(f"an empty layer list at {prefix}")
    if isinstance(rows[0], dict):
        out = {}
        for k in sorted(rows[0]):
            out.update(_flatten_rows([r[k] for r in rows], f"{prefix}[{k!r}]"))
        return out
    return {prefix: list(rows)}


def _rebuild(like, got: dict, prefix: str = ""):
    """``like``'s structure (its own key order) holding the leaves of ``got``."""
    if isinstance(like, dict):
        return {k: _rebuild(v, got, f"{prefix}[{k!r}]") for k, v in like.items()}
    if isinstance(like, list):
        def row(node, pre, i):
            if isinstance(node, dict):
                return {k: row(v, f"{pre}[{k!r}]", i) for k, v in node.items()}
            return got[pre][i]
        return [row(like[0], prefix, i) for i in range(len(like))]
    return got[prefix]


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _to_numpy(t: torch.Tensor) -> np.ndarray:
    t = t.detach().to("cpu")
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(np.uint16)
    return t.numpy()


def _from_numpy(arr: np.ndarray, dtype_name: str, device) -> torch.Tensor:
    dtype = _TORCH.get(dtype_name)
    if dtype is None:
        raise ValueError(f"checkpoint leaf dtype {dtype_name!r} has no torch counterpart")
    if dtype == torch.bfloat16:     # raw 2-byte words: |V2 from the reference, <u2 from here
        t = torch.from_numpy(np.array(arr).view(np.int16)).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.array(arr, dtype=_NP[dtype]))
    return t.to(device)


def save_checkpoint(directory, step: int, state, *, keep: int = 3) -> Path:
    directory = Path(directory)
    directory.mkdir(parents=True, exist_ok=True)
    tmp = directory / f".tmp-{step}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir()
    manifest = {"step": step, "leaves": []}
    for i, (path, leaf) in enumerate(_flatten(state).items()):
        fname = f"leaf{i:05d}.npy"
        if isinstance(leaf, list):      # a pool: stacked on axis 0, written row by row
            first = leaf[0]
            shape = (len(leaf), *first.shape)
            out = np.lib.format.open_memmap(tmp / fname, mode="w+", dtype=_NP[first.dtype],
                                            shape=shape)
            for r, row in enumerate(leaf):
                out[r] = _to_numpy(row)
            out.flush()
            del out
        else:
            first = leaf
            shape = tuple(leaf.shape)
            np.save(tmp / fname, _to_numpy(leaf))
        manifest["leaves"].append({"path": path, "file": fname, "shape": list(shape),
                                   "dtype": _dtype_name(first.dtype)})
    (tmp / "manifest.json.tmp").write_text(json.dumps(manifest))
    final = directory / f"step_{step:010d}"
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp / "manifest.json.tmp", tmp / "manifest.json")
    os.replace(tmp, final)          # manifest-last + atomic rename
    _retain(directory, keep)
    return final


def _retain(directory: Path, keep: int):
    ckpts = sorted(d for d in directory.iterdir()
                   if d.is_dir() and d.name.startswith("step_"))
    for old in ckpts[:-keep]:
        shutil.rmtree(old)


def latest_step(directory) -> int | None:
    directory = Path(directory)
    if not directory.exists():
        return None
    steps = []
    for d in directory.iterdir():
        if d.is_dir() and d.name.startswith("step_") and (d / "manifest.json").exists():
            steps.append(int(d.name.split("_")[1]))
    return max(steps) if steps else None


def load_checkpoint(directory, step: int, like, *, device=None):
    """Restore into the structure of ``like`` (a train state of tensors on
    any device, the ``meta`` device included), each leaf in the manifest's
    dtype, on ``device`` or else on the device of ``like``'s leaf. Returns
    ``(state, step)``."""
    d = Path(directory) / f"step_{step:010d}"
    manifest = json.loads((d / "manifest.json").read_text())
    want = _flatten(like)
    by_path = {e["path"]: e for e in manifest["leaves"]}
    if set(want) != set(by_path):
        missing = set(want) ^ set(by_path)
        raise ValueError(f"checkpoint/state structure mismatch: {sorted(missing)[:5]}")
    got = {}
    for path, leaf in want.items():
        entry = by_path[path]
        arr = np.load(d / entry["file"], mmap_mode="r")
        rows = leaf if isinstance(leaf, list) else None
        first = rows[0] if rows else leaf
        shape = (len(rows), *first.shape) if rows else tuple(first.shape)
        if tuple(arr.shape) != shape:
            raise ValueError(f"checkpoint leaf {path} has shape {tuple(arr.shape)}, the state "
                             f"{shape}")
        dev = device if device is not None else first.device
        if rows:
            got[path] = [_from_numpy(arr[r], entry["dtype"], dev) for r in range(len(rows))]
        else:
            got[path] = _from_numpy(arr, entry["dtype"], dev)
        del arr
    return _rebuild(like, got), manifest["step"]


class CheckpointManager:
    """Save-every-K driver with restore-or-init, used by launch/train.py."""

    def __init__(self, directory, save_every: int = 100, keep: int = 3):
        self.directory = Path(directory)
        self.save_every = save_every
        self.keep = keep

    def restore_or_init(self, init_fn, like, device=None):
        step = latest_step(self.directory)
        if step is None:
            return init_fn(), 0
        state, step = load_checkpoint(self.directory, step, like, device=device)
        return state, step + 1

    def maybe_save(self, step: int, state) -> bool:
        if step % self.save_every:
            return False
        save_checkpoint(self.directory, step, state, keep=self.keep)
        return True
