"""Atomic, resumable checkpoints of the port's train state, in the
reference's on-disk form.

The PyTorch counterpart of ``repro/checkpoint/store.py`` (``save_checkpoint``,
``latest_step``, ``load_checkpoint``, ``AsyncCheckpointWriter``,
``CheckpointManager``), and the two packages read each other's checkpoints:

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

Elasticity: ``load_checkpoint(..., elastic=True)`` loads every pooled leaf
(a list of layer rows, or a stacked tensor on a pool's path) at the row count
the file holds, so a state written under N workers loads into the structure
of an N'-worker state, and ``core.dispatch.reshape_pooled_state`` re-pads it;
every other load checks each leaf's whole shape.
"""
from __future__ import annotations

import json
import os
import queue
import shutil
import threading
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.optim.adam import tree_map

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
    """``like``'s structure (its own key order) holding the leaves of ``got``;
    a list gets as many rows as ``got`` holds for it."""
    if isinstance(like, dict):
        return {k: _rebuild(v, got, f"{prefix}[{k!r}]") for k, v in like.items()}
    if isinstance(like, list):
        def row(node, pre, i):
            if isinstance(node, dict):
                return {k: row(v, f"{pre}[{k!r}]", i) for k, v in node.items()}
            return got[pre][i]

        def first(node, pre):
            if isinstance(node, dict):
                k = next(iter(node))
                return first(node[k], f"{pre}[{k!r}]")
            return pre
        return [row(like[0], prefix, i) for i in range(len(got[first(like[0], prefix)]))]
    return got[prefix]


# the keys of the pools (lists of layer rows) and of their optimizer mirrors;
# the rows a worker count pads them to are the only part of a train state that
# depends on it
POOLED_KEYS = ("layers", "lora", "grad_residual")


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


def load_checkpoint(directory, step: int, like, *, device=None, elastic: bool = False):
    """Restore into the structure of ``like`` (a train state of tensors on
    any device, the ``meta`` device included), each leaf in the manifest's
    dtype, on ``device`` or else on the device of ``like``'s leaf. Returns
    ``(state, step)``.

    Each leaf's shape must be ``like``'s, except that with ``elastic`` a
    pooled leaf (on a ``layers``, ``lora`` or ``grad_residual`` path) loads
    at the row count the file holds, axis 0 of the manifest's shape: a list
    gets that many rows, a stacked tensor that leading dimension."""
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
        if (elastic and shape and arr.ndim == len(shape)
                and any(f"[{k!r}]" in path for k in POOLED_KEYS)):
            shape = (arr.shape[0], *shape[1:])      # the pool's depth as written
        if tuple(arr.shape) != shape:
            raise ValueError(f"checkpoint leaf {path} has shape {tuple(arr.shape)}, the state "
                             f"{shape}")
        dev = device if device is not None else first.device
        if rows:
            got[path] = [_from_numpy(arr[r], entry["dtype"], dev) for r in range(shape[0])]
        else:
            got[path] = _from_numpy(arr, entry["dtype"], dev)
        del arr
    return _rebuild(like, got), manifest["step"]


def _snapshot(leaf: torch.Tensor) -> torch.Tensor:
    """A host copy of ``leaf`` that owns its buffer: a device tensor is copied
    to the host, and a host one cloned (``.cpu()`` would return it as it is,
    and the next step updates it in place)."""
    leaf = leaf.detach()
    return leaf.to("cpu") if leaf.device.type != "cpu" else leaf.clone()


class AsyncCheckpointWriter:
    """Move checkpoint writes off the training critical path.

    ``submit(step, state)`` blocks the caller only for the device -> host
    snapshot, which must be complete before the next step updates the state
    in place (``optim.adam.apply_updates``). Serialization and the atomic
    rename then happen on one background thread, so training overlaps the
    slow disk half of the write.

    Crash safety is inherited: the writer calls the same manifest-last
    :func:`save_checkpoint`, so a crash mid-write leaves at worst an
    invisible ``.tmp-*`` directory and the previous checkpoint stays the
    newest restorable one. Writes run on one thread in submission order, so
    retention never races. A writer-thread exception is re-raised on the next
    ``submit()`` or ``wait()``. ``save_fn`` is injectable for fault-injection
    tests. ``snapshot_s`` sums the caller's blocked seconds and ``write_s``
    the background thread's."""

    def __init__(self, directory, *, keep: int = 3, save_fn=None):
        self.directory = Path(directory)
        self.keep = keep
        self.save_fn = save_fn or save_checkpoint
        self.snapshot_s = 0.0
        self.write_s = 0.0
        self.submitted = 0
        self.completed = 0
        self._queue: queue.Queue = queue.Queue()
        self._error: BaseException | None = None
        self._thread = threading.Thread(target=self._drain, daemon=True)
        self._thread.start()

    def _drain(self):
        while True:
            item = self._queue.get()
            try:
                if item is None:
                    return
                t0 = time.monotonic()
                self.save_fn(self.directory, item[0], item[1], keep=self.keep)
                self.write_s += time.monotonic() - t0
                self.completed += 1
            except BaseException as e:      # re-raised on the next submit or wait
                self._error = e
            finally:
                item = None                 # the snapshot's host memory goes now
                self._queue.task_done()

    def _check_error(self):
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err

    def submit(self, step: int, state) -> float:
        """Snapshot ``state`` to the host and enqueue its write. Returns the
        seconds the caller was blocked (the snapshot: the only part charged
        against goodput)."""
        self._check_error()
        t0 = time.monotonic()
        snapshot = tree_map(_snapshot, state)
        dt = time.monotonic() - t0
        self.snapshot_s += dt
        self.submitted += 1
        self._queue.put((step, snapshot))
        return dt

    def wait(self):
        """Block until every submitted write has landed (or raised)."""
        self._queue.join()
        self._check_error()

    def close(self):
        self._queue.join()
        self._queue.put(None)
        self._thread.join()
        self._check_error()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()


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
