# Copied from src/repro/core/schedule.py; tests/test_torch_plan.py holds the copy
# equal to it.
"""Pipeline schedule generators.

A *schedule* is a list of :class:`StageTask` — the unit the simulator and the
SPMD dispatch runtime both consume.  RoundPipe's schedule (paper §3.2) is the
product of this module; the classic schedules (GPipe, 1F1B, interleaved 1F1B,
looped BFS) are generated here too so the bubble-ratio study (paper Fig. 15)
compares all of them under one cost model.

Conventions
-----------
* ``kind`` is one of ``'F'`` (forward), ``'B'`` (backward-with-recompute) or
  ``'FB'`` (RoundPipe's fused first-backward stage, paper §3.2: the forward of
  the last ``B1`` layers doubles as their recompute).
* A task's ``key`` is globally unique; ``deps`` reference other keys.
* Within one device, tasks execute in list order (dispatch order).  The
  simulator never reorders.
"""
from __future__ import annotations

import dataclasses
from typing import Iterable, Sequence

Key = tuple  # (iteration, kind, stage, microbatch)


@dataclasses.dataclass(frozen=True)
class StageTask:
    key: Key
    device: int
    kind: str                 # 'F' | 'B' | 'FB'
    stage: int                # slot index within the concatenated F..B sequence
    microbatch: int
    duration: float
    deps: tuple = ()
    iteration: int = 0


@dataclasses.dataclass(frozen=True)
class Schedule:
    name: str
    n_devices: int
    tasks: tuple   # tuple[StageTask] in global dispatch order

    def device_tasks(self, d: int) -> list[StageTask]:
        return [t for t in self.tasks if t.device == d]

    @property
    def total_work(self) -> float:
        return sum(t.duration for t in self.tasks)


def _chain(items: Iterable[StageTask]) -> tuple:
    return tuple(items)


# ---------------------------------------------------------------------------
# RoundPipe (paper §3.2)
# ---------------------------------------------------------------------------

def roundpipe_schedule(
    n_devices: int,
    n_microbatches: int,
    fwd_costs: Sequence[float],
    bwd_costs: Sequence[float],
    *,
    round_size: int | None = None,
    g0: int = 0,
    iterations: int = 1,
    name: str = "roundpipe",
) -> Schedule:
    """Generate the RoundPipe round-robin dispatch schedule.

    ``fwd_costs``  — per-slot cost of the ``S_f`` forward stages.
    ``bwd_costs``  — per-slot cost of the ``S_b`` backward stages; slot 0 is
                     the fused ``FB`` stage (its forward doubles as recompute).
    ``round_size`` — micro-batches per round, ``M_R >= N`` (paper).  Defaults
                     to ``N``.
    ``g0``         — starting device of the first round; successive rounds
                     advance ``g0 <- (g0 + S) mod N`` (zero-drain chaining),
                     and with ``iterations > 1`` the chain continues across
                     iteration boundaries (asynchronous-optimizer mode).
    """
    n = n_devices
    mr = round_size or n
    if mr < n:
        raise ValueError(
            f"round_size {mr} must be >= n_devices {n}: every round must "
            f"feed at least one micro-batch to each device — raise "
            f"round_size to a multiple of {n}, or drop devices")
    if n_microbatches % mr:
        raise ValueError(
            f"n_microbatches {n_microbatches} not divisible by round_size "
            f"{mr}: the dispatcher stitches whole rounds — choose "
            f"M = R*{mr} (e.g. {n_microbatches - n_microbatches % mr or mr} "
            f"or {(n_microbatches // mr + 1) * mr}), or pick a round_size "
            f"that divides {n_microbatches}")
    sf, sb = len(fwd_costs), len(bwd_costs)
    s = sf + sb
    tasks: list[StageTask] = []
    cursor = g0
    for it in range(iterations):
        for r in range(n_microbatches // mr):
            mbs = range(r * mr, (r + 1) * mr)
            for slot in range(s):
                dev = (cursor + slot) % n
                for m in mbs:
                    if slot < sf:
                        kind, dur = "F", fwd_costs[slot]
                        deps = () if slot == 0 else ((it, "F", slot - 1, m),)
                    else:
                        j = slot - sf
                        kind = "FB" if j == 0 else "B"
                        dur = bwd_costs[j]
                        if j == 0:
                            deps = ((it, "F", sf - 1, m),) if sf else ()
                        else:
                            prev_kind = "FB" if j == 1 else "B"
                            deps = ((it, prev_kind, sf + j - 1, m),)
                    tasks.append(StageTask((it, kind, slot, m), dev, kind, slot, m, dur, deps, it))
            cursor = (cursor + s) % n
    return Schedule(name, n, _chain(tasks))


# ---------------------------------------------------------------------------
# Classic schedules (baselines for Fig. 15)
# ---------------------------------------------------------------------------

def gpipe_schedule(
    n_devices: int,
    n_microbatches: int,
    fwd_costs: Sequence[float],
    bwd_costs: Sequence[float],
    *,
    iterations: int = 1,
    name: str = "gpipe",
) -> Schedule:
    """GPipe: one stage per device, all forwards then all backwards."""
    n, m = n_devices, n_microbatches
    assert len(fwd_costs) == len(bwd_costs) == n
    tasks = []
    for it in range(iterations):
        for s in range(n):
            for mb in range(m):
                deps = []
                if s:
                    deps.append((it, "F", s - 1, mb))
                if it:  # weights updated at iteration boundary: global flush
                    deps.append((it - 1, "B", 0, m - 1))
                tasks.append(StageTask((it, "F", s, mb), s, "F", s, mb, fwd_costs[s], tuple(deps), it))
        for s in reversed(range(n)):
            for mb in range(m):
                deps = ((it, "B", s + 1, mb),) if s < n - 1 else ((it, "F", n - 1, mb),)
                tasks.append(StageTask((it, "B", s, mb), s, "B", s, mb, bwd_costs[s], deps, it))
    return Schedule(name, n, _chain(tasks))


def one_f_one_b_schedule(
    n_devices: int,
    n_microbatches: int,
    fwd_costs: Sequence[float],
    bwd_costs: Sequence[float],
    *,
    iterations: int = 1,
    name: str = "1f1b",
) -> Schedule:
    """PipeDream-flush / 1F1B: warmup of (N - rank) forwards, then alternate."""
    n, m = n_devices, n_microbatches
    assert len(fwd_costs) == len(bwd_costs) == n
    tasks = []
    for it in range(iterations):
        dep_flush = [(it - 1, "B", 0, m - 1)] if it else []
        for d in range(n):
            warmup = min(n - d, m)
            order: list[tuple[str, int]] = [("F", mb) for mb in range(warmup)]
            nf, nb = warmup, 0
            while nb < m:
                order.append(("B", nb)); nb += 1
                if nf < m:
                    order.append(("F", nf)); nf += 1
            for kind, mb in order:
                if kind == "F":
                    deps = [(it, "F", d - 1, mb)] if d else list(dep_flush)
                    tasks.append(StageTask((it, "F", d, mb), d, "F", d, mb, fwd_costs[d], tuple(deps), it))
                else:
                    deps = [(it, "B", d + 1, mb)] if d < n - 1 else [(it, "F", n - 1, mb)]
                    tasks.append(StageTask((it, "B", d, mb), d, "B", d, mb, bwd_costs[d], tuple(deps), it))
    return Schedule(name, n, _chain(tasks))


def looped_bfs_schedule(
    n_devices: int,
    n_microbatches: int,
    fwd_costs: Sequence[float],
    bwd_costs: Sequence[float],
    *,
    iterations: int = 1,
    name: str = "looped_bfs",
) -> Schedule:
    """Looped BFS (Lamy-Poirier): S = v*N stages, stage s on device s % N.

    Breadth-first: every micro-batch clears stage s before stage s+1 starts
    dispatching, forwards 0..S-1 then backwards S-1..0.
    """
    n, m = n_devices, n_microbatches
    s_total = len(fwd_costs)
    assert s_total % n == 0 and len(bwd_costs) == s_total
    tasks = []
    for it in range(iterations):
        dep_flush = [(it - 1, "B", 0, m - 1)] if it else []
        for s in range(s_total):
            for mb in range(m):
                deps = [(it, "F", s - 1, mb)] if s else list(dep_flush)
                tasks.append(StageTask((it, "F", s, mb), s % n, "F", s, mb, fwd_costs[s], tuple(deps), it))
        for s in reversed(range(s_total)):
            for mb in range(m):
                deps = ((it, "B", s + 1, mb),) if s < s_total - 1 else ((it, "F", s_total - 1, mb),)
                tasks.append(StageTask((it, "B", s, mb), s % n, "B", s, mb, bwd_costs[s], deps, it))
    return Schedule(name, n, _chain(tasks))


def interleaved_1f1b_schedule(
    n_devices: int,
    n_microbatches: int,
    fwd_costs: Sequence[float],
    bwd_costs: Sequence[float],
    *,
    iterations: int = 1,
    name: str = "interleaved_1f1b",
) -> Schedule:
    """Megatron interleaved 1F1B with v = S/N chunks per device.

    Stage s lives on device s % N (chunk s // N).  Ordering per device follows
    the Megatron virtual-pipeline rule: warmup = (N - rank - 1)*2 + (v-1)*N
    forward slots, chunk index cycles every N micro-batch slots.
    """
    n, m = n_devices, n_microbatches
    s_total = len(fwd_costs)
    assert s_total % n == 0 and len(bwd_costs) == s_total
    v = s_total // n
    if m % n:
        raise ValueError("interleaved 1F1B requires microbatches % devices == 0")
    tasks = []

    def fwd_slot(d: int, k: int) -> tuple[int, int]:
        """k-th forward unit on device d -> (stage, microbatch)."""
        grp, pos = divmod(k, n * v)          # group of n*v slots covers n mbs thru v chunks
        chunk, idx = divmod(pos, n)
        return chunk * n + d, grp * n + idx

    def bwd_slot(d: int, k: int) -> tuple[int, int]:
        grp, pos = divmod(k, n * v)
        chunk, idx = divmod(pos, n)
        return (v - 1 - chunk) * n + d, grp * n + idx

    total_units = m * v
    for it in range(iterations):
        dep_flush = [(it - 1, "B", 0, m - 1)] if it else []
        for d in range(n):
            warmup = min((n - d - 1) * 2 + (v - 1) * n, total_units)
            order: list[tuple[str, int]] = [("F", k) for k in range(warmup)]
            nf, nb = warmup, 0
            while nb < total_units:
                if nf < total_units:
                    order.append(("F", nf)); nf += 1
                order.append(("B", nb)); nb += 1
            for kind, k in order:
                if kind == "F":
                    s, mb = fwd_slot(d, k)
                    deps = [(it, "F", s - 1, mb)] if s else list(dep_flush)
                    tasks.append(StageTask((it, "F", s, mb), d, "F", s, mb, fwd_costs[s], tuple(deps), it))
                else:
                    s, mb = bwd_slot(d, k)
                    deps = ((it, "B", s + 1, mb),) if s < s_total - 1 else ((it, "F", s_total - 1, mb),)
                    tasks.append(StageTask((it, "B", s, mb), d, "B", s, mb, bwd_costs[s], deps, it))
    return Schedule(name, n, _chain(tasks))


# ---------------------------------------------------------------------------
# Schedule sanity checks (used by tests and the dispatch runtime)
# ---------------------------------------------------------------------------

def dispatch_slot_order(schedule: Schedule, round_size: int,
                        *, rounds_per_iteration: int | None = None) -> list:
    """The deduped ``(round, slot)`` sequence a roundpipe schedule
    dispatches, in task order — the bridge for asserting that the schedule
    generator, the simulator and the dispatch runtime all follow the SAME
    round-stitched order (``ExecutionPlan.tick_table``'s live entries).

    ``rounds_per_iteration`` handles cross-step schedules
    (``roundpipe_schedule(iterations > 1)``, whose micro-batch numbering
    restarts every iteration): the round index becomes GLOBAL —
    ``iteration * rounds_per_iteration + microbatch // round_size`` —
    matching ``tick_table(rounds, iterations)``'s global round field."""
    out: list = []
    for t in schedule.tasks:
        r = t.microbatch // round_size
        if rounds_per_iteration is not None:
            r += t.iteration * rounds_per_iteration
        entry = (r, t.stage)
        if not out or out[-1] != entry:
            out.append(entry)
    return out


def validate(schedule: Schedule) -> None:
    """Raise if the schedule is malformed (dangling dep, dup key, bad device)."""
    keys = set()
    for t in schedule.tasks:
        if t.key in keys:
            raise ValueError(f"duplicate task {t.key}")
        keys.add(t.key)
        if not (0 <= t.device < schedule.n_devices):
            raise ValueError(f"task {t.key} on bad device {t.device}")
    for t in schedule.tasks:
        for d in t.deps:
            if d not in keys:
                raise ValueError(f"task {t.key} depends on missing {d}")


# ---------------------------------------------------------------------------
# Schedule IR: the per-tick program both dispatch drivers execute
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TickRecord:
    """One tick of a generated ring program (DESIGN.md §8).

    Every field is STATIC — the drivers in ``core/dispatch.py`` unroll the
    record sequence at trace time, emitting ops only for the actions a tick
    actually performs:

    * ``entry``       — ``(global_round, slot)`` injected at worker 0 this
                        tick, or ``None`` during the trailing drain.
    * ``inject_step`` — which optimizer step the injection belongs to
                        (``global_round // R``); selects the staleness-1
                        version the async driver's gather reads (§4.3
                        constraint 2).  ``None`` on drain ticks.
    * ``upload``      — ``(slot, step)`` whose standby fill streams across
                        this tick's compute windows (the double-buffered
                        prefetch for tick ``t+1``), or ``None`` when no
                        injection follows.
    * ``deposit``     — slot index whose fully ring-reduced gradient wave
                        exits at worker ``N-1`` this tick (``None`` for
                        forward slots and ticks with nothing exiting).
    * ``update_step`` — ``k`` when this tick is step ``k``'s
                        deposit-complete tick ``D_k`` (the in-program
                        optimizer update + accumulator snapshot/reset +
                        version publish, §4.3 constraints 3/4/5);
                        ``None`` otherwise.
    """
    t: int
    entry: tuple | None
    inject_step: int | None
    upload: tuple | None
    deposit: int | None
    update_step: int | None


@dataclasses.dataclass(frozen=True)
class TickProgram:
    """A generated ring program: the schedule-as-data artifact.

    ``records[t]`` drives tick ``t`` of both dispatch drivers;
    ``entries`` reproduces the legacy ``ExecutionPlan.tick_table`` tuple
    exactly (asserted in ``tests/test_schedule_ir.py``).  The program
    serializes losslessly to JSON so dryrun plan records can carry it.

    ``g0`` rotates the ring's physical endpoints (paper slot->worker map
    ``(g0 + i) mod N``): injection enters at physical worker ``g0`` and the
    reduced wave exits at physical ``(g0 + N - 1) mod N``.  The records are
    written in LOGICAL coordinates (entry at logical 0, deposit at logical
    N-1) and are therefore g0-invariant — the drivers realize the rotation
    through :class:`repro.core.ring.RingMachine`'s permutation endpoints,
    so the straggler-rotation mitigation is a recompile, not a new IR.
    """
    n_workers: int
    n_slots: int
    rounds: int
    iterations: int
    records: tuple   # tuple[TickRecord]
    g0: int = 0

    @property
    def entries(self) -> tuple:
        return tuple(r.entry for r in self.records)

    @property
    def live(self) -> int:
        return self.iterations * self.rounds * self.n_slots

    def to_json(self) -> dict:
        return {
            "n_workers": self.n_workers,
            "n_slots": self.n_slots,
            "rounds": self.rounds,
            "iterations": self.iterations,
            "g0": self.g0,
            "records": [
                [r.t,
                 list(r.entry) if r.entry is not None else None,
                 r.inject_step,
                 list(r.upload) if r.upload is not None else None,
                 r.deposit,
                 r.update_step]
                for r in self.records],
        }

    @classmethod
    def from_json(cls, obj: dict) -> "TickProgram":
        records = tuple(
            TickRecord(t,
                       tuple(entry) if entry is not None else None,
                       inject_step,
                       tuple(upload) if upload is not None else None,
                       deposit, update_step)
            for t, entry, inject_step, upload, deposit, update_step
            in obj["records"])
        return cls(int(obj["n_workers"]), int(obj["n_slots"]),
                   int(obj["rounds"]), int(obj["iterations"]), records,
                   int(obj.get("g0", 0)))


def theoretical_bubble_roundpipe(n: int, m: int, s: int) -> float:
    """Paper §3.3: N(N-1) / (M*S + N(N-1)) under uniform stage time."""
    return n * (n - 1) / (m * s + n * (n - 1))


def theoretical_bubble_crossstep(n: int, rounds: int, s: int,
                                 iterations: int) -> float:
    """DESIGN.md §6: with the staleness-1 optimizer chaining I steps
    back-to-back the single fill/drain amortizes over every step —
    (N-1) / (I*R*S + N-1) under uniform slot time, -> 0 as I*R grows."""
    return (n - 1) / (iterations * rounds * s + n - 1)
