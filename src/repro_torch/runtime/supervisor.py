"""Goodput supervisor: elastic re-planning, straggler rotation, async ckpts.

The PyTorch counterpart of ``repro/runtime/supervisor.py``, which imports no
JAX and is copied here: the same state machine, events and ledger. The
reference's ``jax_block`` becomes ``device_block``, and a restore loads onto
the runtime's ``device`` where the reference re-places onto ``shardings``;
with ``adapt_state`` the newest checkpoint loads to the CPU at the pool depth
it was written with (``load_checkpoint(..., elastic=True)``) and
``adapt_state`` re-pads it and places it on the runtime's device.

One driver loop around the compiled step, folding the three fault-tolerance
mechanisms the repo already carries into a single state machine:

    RUN ──slow worker──▶ MITIGATE (re-score rotations, rebuild with g0)──▶ RUN
     │──hung step──────▶ RESTORE (newest ckpt, same topology)────────────▶ RUN
     │──dead worker────▶ REPLAN (plan_from_config for N-1, R = rounds_for)
     │                     │── R*S < N-1 under async ──▶ SYNC FALLBACK
     │                     ▼
     │                   RESTORE (elastic: re-pad pool, new mesh)────────▶ RUN
     └──step == n_steps─▶ DONE

* **detect** — every step runs under the :class:`HeartbeatMonitor`
  watchdog (hangs RAISE :class:`StepHungError` into the loop); per-worker
  step times (when the runtime exposes them) feed the
  :class:`StragglerPolicy`; a dead worker surfaces as :class:`WorkerFault`.
* **mitigate structurally** — a straggler is not restarted: RoundPipe
  stages are data + slot index, so the supervisor re-scores the schedule
  rotations under the measured slowdown (``search_schedule`` with
  ``device_scale``) and rebuilds the step with the winning ``g0``, which
  advances the injection point past the slow device.  A dead worker
  triggers a full re-plan for the surviving N-1 (``replan_for_survivors``:
  fresh ``auto_partition``, ``R = plan.rounds_for(M')``), refusing LOUDLY
  when ``R*S < N-1`` makes the staleness-1 async protocol infeasible and
  falling back to the sync step; training resumes from the newest
  checkpoint through the elastic restore path onto the smaller mesh.
* **checkpoint off the critical path** — the
  :class:`~repro_torch.checkpoint.store.AsyncCheckpointWriter` charges the
  caller only the device→host snapshot; serialization and the atomic
  rename happen on a background thread.
* **account** — the :class:`GoodputMeter` splits wall time into
  ``productive`` / ``ckpt`` / ``replan`` / ``replay``; goodput is
  productive seconds over total.  :func:`analytic_goodput` is the closed
  form of the same ledger.

The supervisor drives an abstract **runtime** produced by a caller-supplied
factory, so the unit tests run it against a mock step in milliseconds while
``launch/train.py`` hands it the real RoundPipe train step::

    runtime = factory(n_workers=N, g0=g0, use_async=bool, replan=rr_or_None)

A runtime must provide ``step_fn(state, batch)``, ``batch_for(step)``
(deterministic — the (seed, step)-pure data contract is what makes replay
exact), ``init_state()`` and ``like`` (restore structure); it may provide
``device`` (where a restore without ``adapt_state`` loads),
``adapt_state(host_state) -> state`` (the elastic restore hook — see
``core.dispatch.reshape_pooled_state``), ``worker_times(metrics)
-> list | None`` (per-worker step seconds for straggler attribution) and
``rescore(scales) -> g0`` (schedule-search-backed rotation choice).
"""
from __future__ import annotations

import dataclasses
import statistics
import time
import warnings
from typing import Any, Callable, Optional

from .fault_tolerance import (HeartbeatMonitor, StepHungError,
                              StragglerPolicy, device_block)


class WorkerFault(RuntimeError):
    """A worker died mid-step.  ``worker`` is the physical index on the
    CURRENT mesh; the supervisor answers with an elastic re-plan to N-1."""

    def __init__(self, worker: int, msg: str = ""):
        super().__init__(msg or f"worker {worker} died")
        self.worker = worker


@dataclasses.dataclass
class SupervisorEvent:
    """One state-machine transition, in occurrence order."""
    step: int
    kind: str        # straggler | rotate | hang | worker_dead | replan |
                     # sync_fallback | restore
    detail: dict = dataclasses.field(default_factory=dict)


class GoodputMeter:
    """Wall-time ledger.  ``productive`` = steps that advanced training
    past its previous high-water mark; everything else is overhead:
    ``ckpt`` (caller-side checkpoint cost), ``replan`` (schedule rebuild +
    restore), ``replay`` (re-running steps lost since the last
    checkpoint).  goodput = productive / total."""

    CATEGORIES = ("productive", "ckpt", "replan", "replay")

    def __init__(self):
        self.seconds = {c: 0.0 for c in self.CATEGORIES}

    def add(self, category: str, dt: float):
        self.seconds[category] += dt

    @property
    def total(self) -> float:
        return sum(self.seconds.values())

    @property
    def goodput(self) -> float:
        total = self.total
        return self.seconds["productive"] / total if total > 0 else 1.0

    def report(self) -> dict:
        return {"goodput": self.goodput, "wall_s": self.total,
                **{f"{c}_s": v for c, v in self.seconds.items()}}


def checkpoint_cost_model(state_bytes: float, *, host_bw: float,
                          disk_bw: float) -> tuple[float, float]:
    """Per-checkpoint caller-side cost in seconds: ``(sync_s, async_s)``.

    Both paths pay the device→host snapshot (``state_bytes / host_bw`` —
    mandatory, and required before the next step donates the buffers).
    The sync path additionally blocks on serialization + disk
    (``state_bytes / disk_bw``); the async writer moves exactly that term
    onto a background thread, so ``async_s < sync_s`` whenever
    ``state_bytes > 0`` — the strict goodput win is by construction.
    """
    snapshot = state_bytes / host_bw
    return snapshot + state_bytes / disk_bw, snapshot


def analytic_goodput(step_s: float, *, mtbf_steps: float, ckpt_every: int,
                     ckpt_cost_s: float, replan_s: float = 0.0,
                     replay: bool = True) -> float:
    """Closed-form goodput over one mean-time-between-failures period.

    With MTBF ``M`` steps of ``T`` seconds, checkpointing every ``K``
    steps at caller-side cost ``C``, re-plan + restore cost ``R`` per
    failure, and an expected ``K/2`` lost steps replayed after each
    failure::

        goodput = M*T / (M*T + (M/K)*C + R + (K/2)*T)

    This is the same ledger :class:`GoodputMeter` measures, in
    expectation.
    """
    if step_s <= 0 or mtbf_steps <= 0 or ckpt_every <= 0:
        raise ValueError("step_s, mtbf_steps, ckpt_every must be positive")
    productive = mtbf_steps * step_s
    overhead = (mtbf_steps / ckpt_every) * ckpt_cost_s + replan_s
    if replay:
        overhead += (ckpt_every / 2.0) * step_s
    return productive / (productive + overhead)


class Supervisor:
    """The goodput state machine (module docstring has the diagram).

    ``factory(n_workers=, g0=, use_async=, replan=)`` builds a runtime;
    ``replan`` is the :class:`~repro_torch.core.plan.ReplanResult` after a
    worker death (None on first build / rotation rebuilds).
    ``replan_fn(n_surviving)`` supplies that result — in production a
    closure over ``replan_for_survivors(cfg, ...)``; tests inject fakes.
    ``save_every`` is in supervisor steps, i.e. optimizer-boundary
    (``D_T``) ticks — one driver step is one committed update (or
    ``steps_per_call`` of them under the async program), so snapshots
    always land on update boundaries.
    """

    def __init__(self, factory: Callable[..., Any], ckpt_dir, *,
                 n_workers: int,
                 replan_fn: Optional[Callable[[int], Any]] = None,
                 straggler: Optional[StragglerPolicy] = None,
                 save_every: int = 10, keep: int = 3,
                 async_ckpt: bool = True, use_async: bool = False,
                 step_timeout_s: float = 3600.0, max_restarts: int = 3,
                 clock: Callable[[], float] = time.monotonic):
        self.factory = factory
        self.ckpt_dir = ckpt_dir
        self.n_workers = n_workers
        self.replan_fn = replan_fn
        self.policy = straggler or StragglerPolicy()
        self.save_every = save_every
        self.keep = keep
        self.async_ckpt = async_ckpt
        self.use_async = use_async
        self.step_timeout_s = step_timeout_s
        self.max_restarts = max_restarts
        self.clock = clock
        self.g0 = 0
        self.meter = GoodputMeter()
        self.events: list[SupervisorEvent] = []
        self.restarts = 0
        self._writer = None
        # the background writer's totals once it closes: {"snapshot_s",
        # "write_s", "written"} (empty under synchronous checkpoints)
        self.ckpt_io: dict = {}
        self._slow_worker: Optional[int] = None
        self._slow_streak = 0
        self._slow_ratio = 1.0

    # ------------------------------------------------------------- events
    def _event(self, step: int, kind: str, **detail):
        self.events.append(SupervisorEvent(step, kind, detail))

    def events_of(self, kind: str) -> list[SupervisorEvent]:
        return [e for e in self.events if e.kind == kind]

    # ------------------------------------------------------ build/restore
    def _build(self, replan=None):
        return self.factory(n_workers=self.n_workers, g0=self.g0,
                            use_async=self.use_async, replan=replan)

    def _restore_or_init(self, runtime):
        """Newest checkpoint through the (possibly elastic) restore path;
        fresh init when none exists.  Returns ``(state, next_step)``."""
        from repro_torch.checkpoint.store import latest_step, load_checkpoint

        if self._writer is not None:
            self._writer.wait()      # in-flight snapshots must land first
        step = latest_step(self.ckpt_dir)
        if step is None:
            return runtime.init_state(), 0
        adapt = getattr(runtime, "adapt_state", None)
        if adapt is not None:        # elastic: the depth as written, on the host
            state, saved = load_checkpoint(self.ckpt_dir, step, runtime.like,
                                           device="cpu", elastic=True)
            state = adapt(state)
        else:
            state, saved = load_checkpoint(
                self.ckpt_dir, step, runtime.like,
                device=getattr(runtime, "device", None))
        return state, saved + 1

    def _bump_restarts(self):
        self.restarts += 1
        if self.restarts > self.max_restarts:
            raise RuntimeError(
                f"exceeded max_restarts={self.max_restarts}")

    def _restart(self, step: int, runtime):
        """Hang: restore newest checkpoint, same topology."""
        self._bump_restarts()
        t0 = self.clock()
        state, nxt = self._restore_or_init(runtime)
        self.meter.add("replan", self.clock() - t0)
        self._event(step, "restore", resumed_at=nxt, n_workers=self.n_workers)
        return runtime, state, nxt

    def _replan_restore(self, step: int, dead: int):
        """Dead worker: elastic re-plan for the survivors, then restore."""
        self._bump_restarts()
        t0 = self.clock()
        survivors = self.n_workers - 1
        if survivors < 1:
            raise RuntimeError("no surviving workers to re-plan onto")
        rr = self.replan_fn(survivors) if self.replan_fn else None
        if rr is not None:
            self._event(step, "replan", n_workers=survivors,
                        rounds=rr.rounds, n_microbatches=rr.n_microbatches,
                        async_ok=rr.async_ok)
            if self.use_async and not rr.async_ok:
                # refuse loudly: the async protocol needs R*S >= N-1
                warnings.warn(
                    f"async infeasible after re-plan to N={survivors}: "
                    f"{rr.async_refusal} — falling back to the sync step",
                    RuntimeWarning, stacklevel=2)
                self._event(step, "sync_fallback", reason=rr.async_refusal)
                self.use_async = False
        self.n_workers = survivors
        self.g0 = 0              # rotations don't survive a topology change
        self._slow_worker, self._slow_streak = None, 0
        runtime = self._build(replan=rr)
        state, nxt = self._restore_or_init(runtime)
        self.meter.add("replan", self.clock() - t0)
        self._event(step, "restore", resumed_at=nxt, n_workers=survivors)
        return runtime, state, nxt

    # --------------------------------------------------------- stragglers
    def _observe_timings(self, step: int, runtime, metrics):
        wt = getattr(runtime, "worker_times", None)
        times = wt(metrics) if wt is not None else None
        if not times:
            return
        med = statistics.median(times)
        worst = max(range(len(times)), key=times.__getitem__)
        if med > 0 and times[worst] > self.policy.factor * med:
            if worst == self._slow_worker:
                self._slow_streak += 1
            else:
                self._slow_worker, self._slow_streak = worst, 1
            self._slow_ratio = times[worst] / med
            self._event(step, "straggler", worker=worst,
                        ratio=self._slow_ratio)
        else:
            self._slow_worker, self._slow_streak = None, 0

    def _maybe_rotate(self, step: int, runtime):
        """Straggler persisted: advance the rotation past the slow device."""
        if self._slow_worker is None \
                or self._slow_streak < self.policy.min_samples:
            return runtime
        slow, ratio = self._slow_worker, self._slow_ratio
        self._slow_worker, self._slow_streak = None, 0   # re-arm detection
        scales = [1.0] * self.n_workers
        scales[slow] = ratio
        rescore = getattr(runtime, "rescore", None)
        g0 = rescore(scales) if rescore is not None \
            else (slow + 1) % self.n_workers
        if g0 == self.g0:
            return runtime
        t0 = self.clock()
        self.g0 = g0
        runtime = self._build()
        self.meter.add("replan", self.clock() - t0)
        self._event(step, "rotate", g0=g0, worker=slow, ratio=ratio)
        return runtime

    # -------------------------------------------------------- checkpoints
    def _checkpoint(self, step: int, state):
        t0 = self.clock()
        if self.async_ckpt:
            if self._writer is None:
                from repro_torch.checkpoint.store import \
                    AsyncCheckpointWriter
                self._writer = AsyncCheckpointWriter(self.ckpt_dir,
                                                     keep=self.keep)
            self._writer.submit(step, state)
        else:
            from repro_torch.checkpoint.store import save_checkpoint
            save_checkpoint(self.ckpt_dir, step, state, keep=self.keep)
        self.meter.add("ckpt", self.clock() - t0)

    # --------------------------------------------------------------- run
    def run(self, n_steps: int):
        """Drive training to ``n_steps`` committed steps.  Returns
        ``(state, step)``; ``self.meter.report()`` has the goodput ledger
        and ``self.events`` the transition log."""
        runtime = self._build()
        state, step = self._restore_or_init(runtime)
        reached = step           # high-water mark: below it we're replaying
        try:
            while step < n_steps:
                t0 = self.clock()
                try:
                    with HeartbeatMonitor(self.step_timeout_s) as hb:
                        batch = runtime.batch_for(step)
                        state, metrics = runtime.step_fn(state, batch)
                        device_block(metrics)
                        hb.beat()
                except WorkerFault as e:
                    self._event(step, "worker_dead", worker=e.worker,
                                error=str(e))
                    runtime, state, step = self._replan_restore(
                        step, e.worker)
                    continue
                except StepHungError as e:
                    self._event(step, "hang", error=str(e))
                    runtime, state, step = self._restart(step, runtime)
                    continue
                dt = self.clock() - t0
                self.meter.add("productive" if step >= reached else "replay",
                               dt)
                reached = max(reached, step + 1)
                self._observe_timings(step, runtime, metrics)
                runtime = self._maybe_rotate(step, runtime)
                if (step + 1) % self.save_every == 0 \
                        or step + 1 == n_steps:
                    self._checkpoint(step, state)
                step += 1
        finally:
            if self._writer is not None:
                w, self._writer = self._writer, None
                w.close()
                self.ckpt_io = {"snapshot_s": w.snapshot_s,
                                "write_s": w.write_s, "written": w.completed}
        return state, step
