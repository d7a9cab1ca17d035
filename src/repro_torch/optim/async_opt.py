"""Staleness-1 asynchronous optimizer (paper §2.1.2, §3.2, §4.3).

The PyTorch counterpart of ``repro/optim/async_opt.py``:

* ``AsyncOptState``, ``init_async``, ``async_apply`` and ``flush``: the
  single-program form, where the update of the pending gradients (from
  iteration T-1) runs beside iteration T's forward and backward; the params
  that iteration T reads are those produced after iteration T-2's gradients,
  the semantics the event protocol (``core.consistency``) enforces;
* ``split_host_layers`` and ``HostAsyncRoundPipe``: the threaded §4.3
  realisation around the ring's gradient function, with the optimizer copy
  host-resident (``OptConfig(placement="host")``).

Eager PyTorch needs no ``lax.cond``: the branch is a Python ``if``.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, NamedTuple

import torch

from repro_torch.core.consistency import AsyncTrainer
from repro_torch.optim.adam import OptConfig, apply_updates, init_opt_state, tree_leaves, tree_map


class AsyncOptState(NamedTuple):
    opt: Any          # inner optimizer state (master, moments, step)
    pending: Any      # gradients of the previous iteration (or zeros), bf16
    has_pending: bool


def init_async(params, cfg: OptConfig) -> AsyncOptState:
    zeros = tree_map(lambda p: torch.zeros(p.shape, dtype=torch.bfloat16, device=p.device),
                     params)
    return AsyncOptState(init_opt_state(params, cfg), zeros, False)


def _skip(params, state: AsyncOptState):
    dev = state.opt["step"].device
    return params, state.opt, {"grad_norm": torch.zeros((), dtype=torch.float32, device=dev),
                               "step": state.opt["step"]}


def async_apply(params, state: AsyncOptState, new_grads, cfg: OptConfig):
    """Apply the PENDING grads (iteration T-1), stash the new ones.

    Returns (params for iteration T+1, new state, metrics). The returned
    params reflect grads up to T-1, one step stale, per the paper. The inner
    optimizer state is updated in place (``apply_updates``)."""
    if state.has_pending:
        new_params, new_opt, metrics = apply_updates(state.opt, state.pending, cfg,
                                                     param_like=params)
    else:
        new_params, new_opt, metrics = _skip(params, state)
    stash = tree_map(lambda g: g.to(torch.bfloat16), new_grads)
    return new_params, AsyncOptState(new_opt, stash, True), metrics


def flush(params, state: AsyncOptState, cfg: OptConfig):
    """Drain the pending gradients (end of training / checkpoint boundary)."""
    if state.has_pending:
        new_params, new_opt, metrics = apply_updates(state.opt, state.pending, cfg,
                                                     param_like=params)
    else:
        new_params, new_opt, metrics = _skip(params, state)
    zeros = tree_map(torch.zeros_like, state.pending)
    return new_params, AsyncOptState(new_opt, zeros, False), metrics


# ---------------------------------------------------------------------------
# Host-side optimizer worker (the threaded §4.3 realization)
# ---------------------------------------------------------------------------

def split_host_layers(params):
    """Split a RoundPipe params tree into the per-"layer" host units the
    §4.3 event protocol synchronizes on: one unit per row of
    ``params["layers"]`` plus one trailing unit holding every replicated
    leaf (embed / LM head / final norm). Returns ``(units, unsplit)`` where
    ``unsplit(units) -> tree`` rebuilds the tree; gradients (same tree
    structure in the dense regime) split with the same function."""
    n_rows = len(params["layers"])
    keys = list(params)
    units = list(params["layers"]) + [{k: v for k, v in params.items() if k != "layers"}]

    def unsplit(us):
        return {k: list(us[:n_rows]) if k == "layers" else us[n_rows][k] for k in keys}

    return units, unsplit


def _pinned_like(tree, dtype=None):
    """CPU zeros shaped like ``tree``, pinned when a card is present."""
    pin = torch.cuda.is_available()
    return tree_map(lambda a: torch.zeros(a.shape, dtype=dtype or a.dtype, pin_memory=pin),
                    tree)


def _nbytes(tree) -> int:
    return sum(x.numel() * x.element_size() for x in tree_leaves(tree))


class _HostTrainer(AsyncTrainer):
    """``AsyncTrainer`` whose copies are real transfers between the host and
    the device, each inside its protocol brackets: a layer's weights go up
    from its pinned host master into its device buffer, and its gradients
    come down into a pinned buffer of the iteration's parity, each copy
    asynchronous and finished (its event synchronised) before the event
    that lets the other worker touch the buffer is set. The G-copy takes the
    parity buffer as it is: iteration T+2's download into it waits for the
    G-copy of T+1 (constraint 4), which the sequential optimizer makes only
    after it is done with T. The P-copy writes the optimizer's new weights
    into the pinned master, which constraint (1) keeps from racing the
    upload that reads it."""

    def __init__(self, device_fn, optimizer_fn, host_units, dev_units, grad_bufs, device):
        super().__init__(len(host_units), device_fn, optimizer_fn, host_units)
        self.dev_units, self.grad_bufs, self.device = dev_units, grad_bufs, device
        self.device_s: list[float] = []

    def _settle(self):
        if self.device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            ev.synchronize()

    def _device_iteration(self, iteration: int):
        """Upload, grads, download; ``device_s`` gets the seconds of the three,
        the protocol's waits left out."""
        p = self.protocol
        if self.device.type == "cuda":
            torch.cuda.set_device(self.device)
        busy = 0.0
        for lid in range(self.n_layers):
            p.before_param_upload(lid, iteration)
            t0 = time.perf_counter()
            tree_map(lambda d, h: d.copy_(h, non_blocking=True), self.dev_units[lid],
                     self.master[lid])
            self._settle()
            busy += time.perf_counter() - t0
            p.after_param_upload(lid, iteration)
        t0 = time.perf_counter()
        grads = self.device_fn(self.dev_units, iteration)
        busy += time.perf_counter() - t0
        buf = self.grad_bufs[iteration % 2]
        for lid in range(self.n_layers):
            p.before_grad_download(lid, iteration)
            t0 = time.perf_counter()
            tree_map(lambda h, d: h.copy_(d, non_blocking=True), buf[lid], grads[lid])
            self._settle()
            busy += time.perf_counter() - t0
            self.grad_master[lid] = buf[lid]
            p.after_grad_download(lid, iteration)
        self.device_s.append(busy)

    def _optimizer_iteration(self, iteration: int):
        p = self.protocol
        staged = [None] * self.n_layers
        for lid in range(self.n_layers):
            p.before_g_copy(lid, iteration)
            staged[lid] = self.grad_master[lid]       # G copy (the parity buffer)
            p.after_g_copy(lid, iteration)
        self.opt_copy = list(self.optimizer_fn(self.opt_copy, staged, iteration))
        for lid in range(self.n_layers):
            p.before_p_copy(lid, iteration)
            tree_map(lambda m, o: m.copy_(o), self.master[lid], self.opt_copy[lid])  # P copy
            p.after_p_copy(lid, iteration)


class HostAsyncRoundPipe:
    """Staleness-1 training with a HOST-side optimizer worker around the
    ring's gradient function (paper §4.3's threaded realisation, DESIGN.md
    §6).

    ``grads_fn(params, batch) -> (grads, loss, tokens)`` is
    ``core.dispatch.build_roundpipe_grads_fn``'s function, run on
    ``device``; ``params`` is the model's unpadded params tree (exactly
    ``n_layers`` layer rows, as the ring's grads have). A device thread
    uploads the stale master copy layer by layer into device buffers, runs
    ``grads_fn`` on them and downloads the gradients into pinned host
    buffers; an optimizer thread runs ``optim.adam.apply_updates`` with the
    fp32 master and moments host-resident (``placement="host"``) and writes
    the new weights into the pinned bf16 master copy. The two synchronise
    through ``core.consistency.ConsistencyProtocol``'s per-layer events (one
    protocol layer per layer row and one for the replicated leaves), with no
    global barrier, so the final weights match ``reference_staleness1``.

    After ``train``: ``losses`` (per step), ``device_s`` (the device
    thread's upload + grads + download seconds per step), ``optimizer_s``
    (the CPU optimizer's seconds per step), ``wall_s`` and ``pinned_bytes``
    (host memory pinned for the master copy, the gradient buffers and the
    optimizer state)."""

    def __init__(self, grads_fn, params, cfg: OptConfig, batches, *, device=None):
        device = torch.device(device if device is not None else tree_leaves(params)[0].device)
        if device.type == "cuda" and device.index is None:
            device = torch.device("cuda", torch.cuda.current_device())
        cfg = dataclasses.replace(cfg, placement="host")
        self.losses: list[float] = []
        self.optimizer_s: list[float] = []
        self.wall_s = 0.0
        units, self._unsplit = split_host_layers(params)
        host_units = [tree_map(lambda h, a: h.copy_(a), _pinned_like(u), u) for u in units]
        dev_units = [tree_map(lambda a: torch.empty(a.shape, dtype=a.dtype, device=device), u)
                     for u in units]
        grad_bufs = [[_pinned_like(u, torch.float32) for u in units] for _ in range(2)]
        host_params = self._unsplit(host_units)
        self._opt = init_opt_state(host_params, cfg)
        self.pinned_bytes = (_nbytes(host_units) + _nbytes(grad_bufs) + _nbytes(self._opt)
                             if torch.cuda.is_available() else 0)

        def device_fn(weight_units, t):
            grads, loss, _ = grads_fn(self._unsplit(weight_units), batches[t])
            self.losses.append(float(loss))
            return split_host_layers(grads)[0]

        def optimizer_fn(opt_units, grad_units, t):
            t0 = time.perf_counter()
            new_params, self._opt, _ = apply_updates(self._opt, self._unsplit(grad_units), cfg,
                                                     param_like=host_params)
            self.optimizer_s.append(time.perf_counter() - t0)
            return split_host_layers(new_params)[0]

        self._trainer = _HostTrainer(device_fn, optimizer_fn, host_units, dev_units, grad_bufs,
                                     device)

    @property
    def device_s(self) -> list[float]:
        return self._trainer.device_s

    def train(self, n_steps: int, timeout: float = 600.0):
        """Run ``n_steps`` staleness-1 iterations; returns the final params
        tree on the host (every update applied: the flush)."""
        t0 = time.perf_counter()
        final_units = self._trainer.train(n_steps, timeout=timeout)
        self.wall_s = time.perf_counter() - t0
        return self._unsplit(final_units)

    def hidden_share(self) -> float:
        """The share of the CPU optimizer's seconds hidden under the device
        thread's work: (device + optimizer - wall) / optimizer, in [0, 1]."""
        opt = sum(self.optimizer_s)
        if opt <= 0:
            return 0.0
        return min(1.0, max(0.0, (sum(self.device_s) + opt - self.wall_s) / opt))
