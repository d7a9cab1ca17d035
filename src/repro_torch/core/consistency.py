# Copied from src/repro/core/consistency.py, which imports no JAX;
# tests/test_torch_async.py holds the copy equal to it.
"""Fine-grained event-based parameter-consistency protocol (paper §4.3).

Staleness-1 semantics: GPU iteration ``T+1`` reads the weights produced after
iteration ``T-1`` while the optimizer applies iteration-``T`` gradients in the
background.  Three representations exist (transient device copy, master copy,
optimizer copy); correctness reduces to five ordering constraints which we
enforce with *per-layer* point-to-point events instead of a global barrier
(paper Fig. 8b), so shallow layers of iteration T+1 start while deep layers of
iteration T are still synchronising.

Constraint map (paper §4.3.1), all per layer ``l``:
  (1) P-copy of W^{(T)} into master waits until the device finished UPLOADING
      master for iteration T+1          -> event ("up", l, T+1)
  (2) device upload for iteration T+2 waits until P-copy of W^{(T)} done
                                        -> event ("pcp", l, T)
  (3) G-copy of G_T waits until the device finished DOWNLOADING G_T
                                        -> event ("down", l, T)
  (4) device download of G_{T+1} waits until G-copy of G_T done
                                        -> event ("gcp", l, T)
  (5) copies sit between optimizer steps -> optimizer worker is sequential.

This module is runtime-agnostic: the ``AsyncTrainer`` below drives any pair of
(device_fn, optimizer_fn) callables — numpy for the tests, jitted JAX for
``examples/async_optimizer.py``.  Inside a single XLA program ordering is by
data dependence instead (see ``repro.optim.async_wrapper``), which is the
jit-compatible realization of the same staleness-1 semantics.
"""
from __future__ import annotations

import threading
from collections import defaultdict
from typing import Callable, Sequence


class EventBook:
    """Lazily-created threading events keyed by (kind, layer, iteration)."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._events: dict[tuple, threading.Event] = {}

    def _get(self, key: tuple) -> threading.Event:
        with self._lock:
            ev = self._events.get(key)
            if ev is None:
                ev = self._events[key] = threading.Event()
            return ev

    def set(self, kind: str, layer: int, iteration: int) -> None:
        self._get((kind, layer, iteration)).set()

    def wait(self, kind: str, layer: int, iteration: int, timeout: float = 30.0) -> None:
        if iteration < 0:
            return  # constraints referencing pre-history are vacuous
        if not self._get((kind, layer, iteration)).wait(timeout):
            raise TimeoutError(f"event ({kind}, layer={layer}, it={iteration}) never fired")

    def is_set(self, kind: str, layer: int, iteration: int) -> bool:
        return iteration < 0 or self._get((kind, layer, iteration)).is_set()


class ConsistencyProtocol:
    """The five ordering constraints as wait/signal pairs around the copies."""

    def __init__(self, n_layers: int) -> None:
        self.n_layers = n_layers
        self.book = EventBook()

    # ---- device-worker side ------------------------------------------------
    def before_param_upload(self, layer: int, iteration: int) -> None:
        # (2): upload for iteration T reads weights W^{(T-2)}; wait P-copy T-2.
        self.book.wait("pcp", layer, iteration - 2)

    def after_param_upload(self, layer: int, iteration: int) -> None:
        self.book.set("up", layer, iteration)

    def before_grad_download(self, layer: int, iteration: int) -> None:
        # (4): writing G_T into the master buffer waits G-copy of G_{T-1}.
        self.book.wait("gcp", layer, iteration - 1)

    def after_grad_download(self, layer: int, iteration: int) -> None:
        self.book.set("down", layer, iteration)

    # ---- optimizer-worker side ----------------------------------------------
    def before_g_copy(self, layer: int, iteration: int) -> None:
        # (3): G-copy of G_T waits until the device wrote G_T.
        self.book.wait("down", layer, iteration)

    def after_g_copy(self, layer: int, iteration: int) -> None:
        self.book.set("gcp", layer, iteration)

    def before_p_copy(self, layer: int, iteration: int) -> None:
        # (1): P-copy of W^{(T)} waits until the device read master for T+1.
        self.book.wait("up", layer, iteration + 1)

    def after_p_copy(self, layer: int, iteration: int) -> None:
        self.book.set("pcp", layer, iteration)

    # ---- non-blocking counterparts -------------------------------------------
    # Used by the static program verifier (``verify_async_ticks``): the same
    # five constraints phrased as "may this event happen NOW?" predicates, so
    # a deterministic replay can certify an execution order without threads.
    def may_param_upload(self, layer: int, iteration: int) -> bool:
        """(2): upload for iteration T may start once P-copy T-2 is done."""
        return self.book.is_set("pcp", layer, iteration - 2)

    def may_grad_download(self, layer: int, iteration: int) -> bool:
        """(4): writing G_T may start once G-copy of G_{T-1} is done."""
        return self.book.is_set("gcp", layer, iteration - 1)

    def may_g_copy(self, layer: int, iteration: int) -> bool:
        """(3): G-copy of G_T may start once the device wrote G_T."""
        return self.book.is_set("down", layer, iteration)

    def may_p_copy(self, layer: int, iteration: int, *,
                   double_buffered: bool = False) -> bool:
        """(1): P-copy of W^{(T)} may start once the master reads it would
        overwrite are retired.  Single-buffer form (the paper's): wait for
        iteration T+1's upload.  ``double_buffered``: the writer targets the
        buffer LAST read by iteration T (two master versions live, as in the
        in-program dispatch realization), so only iteration T's upload must
        have finished — one iteration earlier, strictly safe with 2 buffers.
        """
        return self.book.is_set("up", layer,
                                iteration if double_buffered else iteration + 1)


class AsyncTrainer:
    """Reference driver wiring a device worker and an optimizer worker.

    ``device_fn(master_weights, iteration) -> grads`` runs the pipelined
    forward+backward of one iteration given the (stale) master weights.
    ``optimizer_fn(opt_weights, grads, iteration) -> new_opt_weights`` is the
    sequential optimizer step on the full-precision copy.

    Weights/grads are dicts ``layer -> object``; copies are per-layer so the
    protocol's fine granularity is real, not cosmetic.
    """

    def __init__(self, n_layers: int, device_fn: Callable, optimizer_fn: Callable,
                 init_weights: Sequence):
        self.protocol = ConsistencyProtocol(n_layers)
        self.n_layers = n_layers
        self.device_fn = device_fn
        self.optimizer_fn = optimizer_fn
        self.master = list(init_weights)          # low-precision master copy
        self.opt_copy = list(init_weights)        # full-precision optimizer copy
        self.grad_master = [None] * n_layers      # gradient staging buffer
        self.errors: list[BaseException] = []

    # -- device side ----------------------------------------------------------
    def _device_iteration(self, iteration: int):
        p = self.protocol
        weights = []
        for l in range(self.n_layers):
            p.before_param_upload(l, iteration)
            weights.append(self.master[l])        # transient device copy
            p.after_param_upload(l, iteration)
        grads = self.device_fn(weights, iteration)
        for l in range(self.n_layers):
            p.before_grad_download(l, iteration)
            self.grad_master[l] = grads[l]
            p.after_grad_download(l, iteration)

    # -- optimizer side ---------------------------------------------------------
    def _optimizer_iteration(self, iteration: int):
        p = self.protocol
        staged = [None] * self.n_layers
        for l in range(self.n_layers):
            p.before_g_copy(l, iteration)
            staged[l] = self.grad_master[l]       # G copy
            p.after_g_copy(l, iteration)
        self.opt_copy = list(self.optimizer_fn(self.opt_copy, staged, iteration))
        for l in range(self.n_layers):
            p.before_p_copy(l, iteration)
            self.master[l] = self.opt_copy[l]     # P copy (fp32 -> bf16 cast site)
            p.after_p_copy(l, iteration)

    def _guard(self, fn, *args):
        try:
            fn(*args)
        except BaseException as e:  # surface worker failures to the caller
            self.errors.append(e)

    def train(self, n_iterations: int, timeout: float = 60.0) -> list:
        """Run device and optimizer workers concurrently with staleness-1."""
        def device_loop():
            for t in range(n_iterations):
                self._device_iteration(t)
            # retire: no iteration n_iterations will read the master copy, so
            # release the optimizer's pending constraint-(1) waits.
            for l in range(self.n_layers):
                self.protocol.after_param_upload(l, n_iterations)

        def optimizer_loop():
            for t in range(n_iterations):
                self._optimizer_iteration(t)

        threads = [threading.Thread(target=self._guard, args=(device_loop,)),
                   threading.Thread(target=self._guard, args=(optimizer_loop,))]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout)
            if th.is_alive():
                raise TimeoutError("async trainer worker hung")
        if self.errors:
            raise self.errors[0]
        return self.master


def verify_async_ticks(plan, rounds: int = 1, iterations: int = 1,
                       program=None) -> None:
    """Certify that a cross-step tick table satisfies the five §4.3
    constraints, by deterministic replay through a real
    :class:`ConsistencyProtocol`.

    The chained dispatch program (``core/dispatch.py`` async mode,
    DESIGN.md §6) realizes the protocol's events in program order:

    * ``up(l, T)``   — step T's LAST ring injection of layer ``l`` (the final
      read of the staleness-1 master version ``v_{T-1}``);
    * ``down(l, T)`` — step T's last gradient deposit of layer ``l``;
    * ``gcp/pcp(l, T)`` — the in-program optimizer update at step T's
      deposit-complete tick ``D_T = (T+1)·R·S + N - 2`` (grads consumed,
      version ``v_{T+1}`` published).

    Constraints (2), (3), (4) are checked in the paper's literal form;
    (1) in the double-buffered form (two live master versions — see
    :meth:`ConsistencyProtocol.may_p_copy`); (5) is structural (one update
    site per step, replayed strictly in step order).  Raises ``ValueError``
    naming the first violated constraint — e.g. when ``R·S < N - 1`` and
    step T's injection would overtake step T-2's gradient drain.

    ``program`` (a :class:`~repro.core.schedule.TickProgram`) additionally
    cross-checks the generated IR against the replay: every record's
    ``entry``/``inject_step``/``deposit``/``update_step``/``upload``
    annotation must name exactly the event the protocol replay derives at
    that tick — the certification gate a generated schedule passes before
    the dispatch drivers execute it.
    """
    n, s = plan.n_workers, plan.n_slots
    rs = rounds * s
    table = plan.tick_table(rounds, iterations)
    proto = ConsistencyProtocol(plan.n_layers)
    last_update = -1

    def fail(constraint, what, layer, step, tick):
        raise ValueError(
            f"constraint ({constraint}) violated at tick {tick}: {what} of "
            f"layer {layer} step {step} is not yet permitted "
            f"(rounds={rounds}, iterations={iterations}, N={n}, S={s})")

    def drift(tick, field, got, want):
        raise ValueError(
            f"tick program drift at tick {tick}: record.{field} = {got!r} "
            f"but the protocol replay derives {want!r} "
            f"(rounds={rounds}, iterations={iterations}, N={n}, S={s})")

    if program is not None:
        if (program.n_workers, program.n_slots) != (n, s) or \
                (program.rounds, program.iterations) != (rounds, iterations):
            raise ValueError(
                f"tick program shape ({program.n_workers}, {program.n_slots},"
                f" R={program.rounds}, I={program.iterations}) does not match"
                f" plan ({n}, {s}, R={rounds}, I={iterations})")
        if len(program.records) != len(table):
            raise ValueError(
                f"tick program has {len(program.records)} records, the "
                f"stitched table has {len(table)} ticks")

    for t, entry in enumerate(table):
        rec = program.records[t] if program is not None else None
        if rec is not None and rec.entry != entry:
            drift(t, "entry", rec.entry, entry)
        if entry is not None:                      # injection (master upload)
            g_round, slot = entry
            step, r = divmod(g_round, rounds)
            if rec is not None and rec.inject_step != step:
                drift(t, "inject_step", rec.inject_step, step)
            for lid in plan.stages[slot].layers:
                if r == 0 and not proto.may_param_upload(lid, step):
                    fail(2, "param upload", lid, step, t)
                if r == rounds - 1:
                    proto.after_param_upload(lid, step)
        elif rec is not None and rec.inject_step is not None:
            drift(t, "inject_step", rec.inject_step, None)
        if rec is not None:                        # standby upload for t+1
            nxt = table[t + 1] if t + 1 < len(table) else None
            want_up = None if nxt is None else (nxt[1], nxt[0] // rounds)
            if rec.upload != want_up:
                drift(t, "upload", rec.upload, want_up)
        g = t - (n - 1)                            # gradient deposit (exit)
        dep_slot = None
        upd_step = None
        if 0 <= g < iterations * rs:
            step, within = divmod(g, rs)
            r, slot = divmod(within, s)
            if plan.stages[slot].kind != "F":
                dep_slot = slot
                for lid in plan.stages[slot].layers:
                    if r == 0 and not proto.may_grad_download(lid, step):
                        fail(4, "grad download", lid, step, t)
                    if r == rounds - 1:
                        proto.after_grad_download(lid, step)
            if within == rs - 1:                   # D_step: host update site
                upd_step = step
                for lid in range(plan.n_layers):
                    if not proto.may_g_copy(lid, step):
                        fail(3, "G-copy", lid, step, t)
                    proto.after_g_copy(lid, step)
                if step != last_update + 1:        # (5): sequential optimizer
                    raise ValueError(
                        f"constraint (5) violated: update for step {step} "
                        f"after step {last_update}")
                last_update = step
                for lid in range(plan.n_layers):
                    if not proto.may_p_copy(lid, step, double_buffered=True):
                        fail(1, "P-copy", lid, step, t)
                    proto.after_p_copy(lid, step)
        if rec is not None:
            if rec.deposit != dep_slot:
                drift(t, "deposit", rec.deposit, dep_slot)
            if rec.update_step != upd_step:
                drift(t, "update_step", rec.update_step, upd_step)
    if last_update != iterations - 1:
        raise ValueError(f"only {last_update + 1} of {iterations} optimizer "
                         f"updates were reached by the tick table")


def reference_staleness1(n_layers: int, device_fn: Callable, optimizer_fn: Callable,
                         init_weights: Sequence, n_iterations: int) -> list:
    """Serial oracle with identical staleness-1 semantics: iteration T reads
    the weights produced after iteration T-2's gradients were applied."""
    versions = [list(init_weights)]  # versions[v] = weights after applying grads 0..v-1
    opt = list(init_weights)
    for t in range(n_iterations):
        read = versions[max(0, t - 1)]
        grads = device_fn(list(read), t)
        opt = list(optimizer_fn(opt, grads, t))
        versions.append(list(opt))
    return versions[-1]
