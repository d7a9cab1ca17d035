# Copied from src/repro/core/simulator.py; tests/test_torch_plan.py holds the
# copy equal to it, apart from search_schedule, which raises until the async
# certificate (core/consistency.py) is ported.
"""Event-driven pipeline simulator (reproduces paper Fig. 15).

Executes a :class:`~repro.core.schedule.Schedule` respecting (a) data
dependencies between tasks and (b) per-device dispatch order, and reports
makespan, per-device busy time and bubble ratio.  The same engine measures
steady-state bubbles for the asynchronous-optimizer mode by windowing on
iteration boundaries (paper §5.6.1 simulates 16 micro-batches on 8 GPUs).

``simulate_plan`` is the plan-level entry point: it consumes the same
:class:`~repro.core.plan.ExecutionPlan` object the SPMD dispatch runtime
executes, so simulated and executed schedules are one and the same object
(see DESIGN.md §1).

Two-resource model (paper §4.2, Fig. 6 vs Fig. 7)
-------------------------------------------------
Passing ``bandwidth`` models each device as TWO lanes: a compute lane (the
classic list schedule) and a transfer lane that must move a slot's weight
bytes to the device before the slot's first micro-batch may start there.

* ``transfer_mode="block"`` — the transfer starts only when the compute
  lane demands the slot (head-of-line burst, Fig. 6): compute stalls for
  the whole block upload.
* ``transfer_mode="prefetch"`` — the transfer may start as soon as the
  lane is free AND the device has begun the *previous* slot (the
  double-buffer window the PrefetchProgram uploads into, Fig. 7): the
  upload hides inside the preceding compute window and only residual
  bytes (window overload) stall the compute lane.

The bubble gap between the two modes on the same plan is exactly the
paper's blocking-vs-hidden comparison.

Download lane (§4.3 consistency traffic)
----------------------------------------
``download_bytes[slot]`` models the return direction: when a backward/FB
slot's visit finishes on a device, its gradient bytes (full weights for
dense fine-tuning, adapter factors for a frozen-base LoRA plan — see
``ExecutionPlan.stage_download_bytes``) must cross the same link before
the lane can serve the *next* visit's upload.  Busy time is accounted per
direction (``SimResult.transfer_busy`` for uploads, ``download_busy`` for
downloads) so the two lanes report separately, but they contend for one
half-duplex link: large downloads back the lane up and stall subsequent
uploads — which is precisely the traffic a LoRA plan removes.
"""
from __future__ import annotations

import dataclasses
from collections import defaultdict

from .schedule import Schedule, StageTask


@dataclasses.dataclass
class SimResult:
    makespan: float
    busy: list[float]                  # per-device busy time
    finish: dict                       # task key -> finish time
    start: dict                        # task key -> start time
    n_devices: int
    dev_of: dict = dataclasses.field(default_factory=dict)  # task key -> device
    transfer_busy: list = dataclasses.field(default_factory=list)  # upload lane
    transfer_stall: list = dataclasses.field(default_factory=list)
    download_busy: list = dataclasses.field(default_factory=list)  # grad lane

    @property
    def bubble_ratio(self) -> float:
        total = self.n_devices * self.makespan
        return 0.0 if total == 0 else 1.0 - sum(self.busy) / total

    @property
    def stall_total(self) -> float:
        """Compute time lost waiting on the transfer lane (two-resource runs)."""
        return sum(self.transfer_stall)

    @property
    def upload_busy(self) -> list:
        """Per-device host->GPU (weight upload) lane busy time — an explicit
        alias of ``transfer_busy`` now that the link carries two directions."""
        return self.transfer_busy

    @property
    def upload_total(self) -> float:
        return sum(self.transfer_busy)

    @property
    def download_total(self) -> float:
        """GPU->host gradient/optimizer traffic time — the direction a
        frozen-base (LoRA) plan shrinks to adapter size."""
        return sum(self.download_busy)

    def window_bubble(self, keys: set) -> float:
        """Bubble ratio restricted to the time window spanned by ``keys``.

        Used for steady-state measurement: pass the keys of one middle
        iteration; the window is [min start, max finish] of those tasks and
        busy time counts *any* task overlapping the window (clipped).
        """
        t0 = min(self.start[k] for k in keys)
        t1 = max(self.finish[k] for k in keys)
        span = t1 - t0
        if span <= 0:
            return 0.0
        busy = [0.0] * self.n_devices
        for k, s in self.start.items():
            f = self.finish[k]
            lo, hi = max(s, t0), min(f, t1)
            if hi > lo:
                busy[self.dev_of[k]] += hi - lo
        return 1.0 - sum(busy) / (self.n_devices * span)


def _list_schedule(schedule: Schedule, stage_bytes=None, *,
                   bandwidth: float = 0.0,
                   transfer_mode: str = "prefetch",
                   download_bytes=None,
                   standby_cache: bool = False,
                   device_scale=None) -> SimResult:
    """List-schedule the tasks: fixed per-device order, dep-gated start times.

    With ``stage_bytes`` and ``bandwidth``, the first task of every
    contiguous same-stage run on a device additionally waits on that
    device's transfer lane (see module docstring).  A contiguous run is one
    slot visit — in RoundPipe each slot visits a device once per round, so
    each visit re-streams the slot's weights.  ``standby_cache=True``
    models a device that pins each slot's weights after the first visit:
    repeat visits of a stage already seen on that device charge zero upload
    bytes (the memory-for-bandwidth trade a multi-round step can make when
    the standby buffers fit residency).  ``device_scale[d]`` multiplies
    every compute duration on device ``d`` — the straggler model the
    goodput supervisor scores ``g0`` rotations against (a 5x-slowed worker
    is ``scale=5.0`` on that device, 1.0 elsewhere).

    ``download_bytes[slot]`` adds the return direction on the same link:
    a slot visit's gradient bytes occupy the lane after the visit produces
    them.  In block mode the pending download is settled before the next
    visit's upload (everything queues at the boundary); in prefetch mode
    the next upload streams during the finishing visit's compute window —
    before its gradients exist — so the upload keeps lane priority and the
    download fills in behind it.  Downloads are never cached: gradients
    are fresh every visit.
    """
    per_dev: dict[int, list[StageTask]] = defaultdict(list)
    for t in schedule.tasks:
        per_dev[t.device].append(t)
    ptr = {d: 0 for d in per_dev}
    dev_free = {d: 0.0 for d in per_dev}
    lane_free = {d: 0.0 for d in per_dev}
    group_open = {d: 0.0 for d in per_dev}   # start of the previous slot visit
    transfer_busy = [0.0] * schedule.n_devices
    transfer_stall = [0.0] * schedule.n_devices
    download_busy = [0.0] * schedule.n_devices
    resident: dict[int, set] = defaultdict(set)   # device -> cached stages
    finish: dict = {}
    start: dict = {}
    dev_of: dict = {}

    def settle_download(d, stage):
        """Queue ``stage``'s gradient deposit on device ``d``'s lane; the
        bytes become available when the visit's last task finished
        (``dev_free[d]`` at call time)."""
        if download_bytes is None or bandwidth <= 0:
            return
        dur = download_bytes[stage] / bandwidth
        if dur <= 0:
            return
        dl0 = max(lane_free[d], dev_free[d])
        lane_free[d] = dl0 + dur
        download_busy[d] += dur

    remaining = len(schedule.tasks)
    while remaining:
        progressed = False
        for d, tasks in per_dev.items():
            # advance this device as far as possible
            while ptr[d] < len(tasks):
                t = tasks[ptr[d]]
                if any(dep not in finish for dep in t.deps):
                    break
                begin = max(dev_free[d], max((finish[dep] for dep in t.deps), default=0.0))
                new_group = ptr[d] == 0 or tasks[ptr[d] - 1].stage != t.stage
                if new_group and ptr[d] > 0 and transfer_mode == "block":
                    settle_download(d, tasks[ptr[d] - 1].stage)
                cached = standby_cache and t.stage in resident[d]
                if stage_bytes is not None and bandwidth > 0 and new_group \
                        and not cached:
                    dur = stage_bytes[t.stage] / bandwidth
                    if transfer_mode == "block":
                        # head-of-line: lane starts only on compute demand
                        xfer0 = max(begin, lane_free[d])
                    else:
                        # hidden: lane may stream during the previous slot's
                        # compute window (double-buffered standby upload)
                        xfer0 = max(group_open[d], lane_free[d])
                    lane_free[d] = xfer0 + dur
                    transfer_busy[d] += dur
                    stalled = max(0.0, lane_free[d] - begin)
                    transfer_stall[d] += stalled
                    begin += stalled
                if new_group and ptr[d] > 0 and transfer_mode != "block":
                    settle_download(d, tasks[ptr[d] - 1].stage)
                if new_group:
                    group_open[d] = begin
                    resident[d].add(t.stage)
                start[t.key] = begin
                scale = device_scale[d] if device_scale is not None else 1.0
                finish[t.key] = begin + t.duration * scale
                dev_of[t.key] = d
                dev_free[d] = finish[t.key]
                ptr[d] += 1
                remaining -= 1
                progressed = True
        if not progressed:
            stuck = [tasks[ptr[d]].key for d, tasks in per_dev.items() if ptr[d] < len(tasks)]
            raise RuntimeError(f"schedule deadlock; blocked heads: {stuck[:4]}")
    for d, tasks in per_dev.items():          # trailing deposit of the last visit
        if tasks:
            settle_download(d, tasks[-1].stage)
    makespan = max(finish.values(), default=0.0)
    busy = [0.0] * schedule.n_devices
    for t in schedule.tasks:
        busy[t.device] += t.duration * (
            device_scale[t.device] if device_scale is not None else 1.0)
    return SimResult(makespan, busy, finish, start, schedule.n_devices,
                     dev_of, transfer_busy, transfer_stall, download_busy)


def simulate(schedule: Schedule, *, device_scale=None) -> SimResult:
    """Compute-lane-only simulation (transfers assumed free)."""
    return _list_schedule(schedule, device_scale=device_scale)


def simulate_transfers(schedule: Schedule, stage_bytes, *, bandwidth: float,
                       transfer_mode: str = "prefetch",
                       download_bytes=None,
                       standby_cache: bool = False,
                       device_scale=None) -> SimResult:
    """Two-resource simulation: ``stage_bytes[slot]`` weight bytes must cross
    a per-device link of ``bandwidth`` bytes/time-unit before each slot visit
    (see module docstring for the block/prefetch lane policies).
    ``download_bytes[slot]`` (optional) charges each visit's gradient
    deposit on the same lane after the visit completes.  ``standby_cache``
    waives the upload charge on repeat visits of a stage already streamed
    to that device (weights pinned across rounds)."""
    if transfer_mode not in ("block", "prefetch"):
        raise ValueError(f"unknown transfer_mode {transfer_mode!r}")
    if bandwidth <= 0:
        raise ValueError("bandwidth must be positive")
    return _list_schedule(schedule, stage_bytes, bandwidth=bandwidth,
                          transfer_mode=transfer_mode,
                          download_bytes=download_bytes,
                          standby_cache=standby_cache,
                          device_scale=device_scale)


def simulate_plan(plan, n_microbatches: int | None = None, *,
                  round_size: int | None = None,
                  iterations: int = 1,
                  bandwidth: float | None = None,
                  transfer_mode: str = "prefetch",
                  standby_cache: bool = False,
                  g0: int = 0,
                  device_scale=None) -> SimResult:
    """Validate and simulate an :class:`~repro.core.plan.ExecutionPlan`.

    The schedule is generated from the *same* compiled plan the dispatch
    runtime executes, in the same round-stitched order
    (``plan.tick_table``): ``n_microbatches = R * plan.n_workers`` with
    ``round_size=plan.n_workers`` times the ``R``-round steady-state step
    the runtime runs under ``StepConfig.n_microbatches`` (one resident
    micro-batch group per worker per round, fill/drain paid once per
    step); the ``R = 1`` default is the legacy one-round step.

    ``iterations > 1`` is the cross-step asynchronous-optimizer mode
    (paper §4.3, DESIGN.md §6): optimizer steps chain back-to-back with no
    inter-iteration dependency — the order ``plan.tick_table(R, I)``
    stitches and the chained program of
    ``dispatch.build_roundpipe_async_train_step`` executes under
    staleness-1 parameter reads — so the reported ``bubble_ratio`` is the
    executed cross-step bubble with ONE fill/drain amortized over all
    ``I`` steps ((N-1)/(I*R*S + N-1) under uniform slot costs), strictly
    below the per-step synchronous bubble.

    ``bandwidth`` (bytes per cost-model time-unit) switches on the
    two-resource model: each slot's ``plan.stage_bytes`` is charged against
    the device's transfer lane, either head-of-line (``transfer_mode=
    "block"``) or hidden in the preceding compute window (``"prefetch"``),
    and each backward slot's ``plan.stage_download_bytes`` fills the return
    direction of the lane after the visit — adapter-sized under a
    frozen-base LoRA plan, weight-sized under full fine-tuning.

    ``standby_cache=True`` charges each slot's upload only on its FIRST
    visit to a device: a multi-round (or multi-iteration) step that can
    afford to pin the standby blocks stops re-streaming them, trading
    device memory for the up lane.  Downloads still post every visit.

    ``g0`` rotates the injection start device (paper slot->worker map
    ``(g0 + i) mod N``) — a schedule-family knob scored by
    :func:`search_schedule` and realized by the SPMD runtime through the
    ring's rotated permutation endpoints (``RingMachine(g0=...)``), so a
    scored rotation is directly executable.

    ``device_scale[d]`` multiplies every compute duration on device ``d``
    (straggler model): the goodput supervisor re-scores the rotation family
    under the observed slowdown to pick the ``g0`` that hides the slow
    worker best.
    """
    from .schedule import validate

    plan.validate()
    sched = plan.schedule(n_microbatches or plan.n_workers,
                          round_size=round_size, iterations=iterations,
                          g0=g0)
    validate(sched)
    if bandwidth is None:
        return simulate(sched, device_scale=device_scale)
    return simulate_transfers(sched, plan.stage_bytes, bandwidth=bandwidth,
                              transfer_mode=transfer_mode,
                              download_bytes=plan.stage_download_bytes,
                              standby_cache=standby_cache,
                              device_scale=device_scale)


def steady_state_bubble(schedule: Schedule, iteration: int = 1) -> float:
    """Bubble ratio of one middle iteration (asynchronous-optimizer metric)."""
    res = simulate(schedule)
    keys = {t.key for t in schedule.tasks if t.iteration == iteration}
    if not keys:
        raise ValueError(f"no tasks in iteration {iteration}")
    return res.window_bubble(keys)


# ---------------------------------------------------------------------------
# Schedule search (tick programs as generated artifacts, DESIGN.md §8)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ScheduleChoice:
    """One point in the schedule family: the knobs ``simulate_plan`` scores.

    ``g0`` rotates the injection start device — realized by the runtime
    through :class:`repro.core.ring.RingMachine`'s rotated permutation
    endpoints, so every rotation member is executable; ``transfer_mode``
    picks the upload-lane policy (``"prefetch"`` = the chunked
    double-buffered standby uploader, ``"block"`` = whole-block
    head-of-line gather — the runtime's ``StepConfig.prefetch`` toggle);
    ``standby_cache`` pins slot weights across repeat visits
    (memory-for-bandwidth, not yet executed by the SPMD runtime — still
    the only non-executable knob).
    """
    name: str
    g0: int = 0
    transfer_mode: str = "prefetch"
    standby_cache: bool = False

    @property
    def executable(self) -> bool:
        return not self.standby_cache


@dataclasses.dataclass
class SearchResult:
    """Outcome of :func:`search_schedule`.

    ``choice``/``bubble`` are the winning *executable* candidate and its
    simulated bubble; ``hand_bubble`` is candidate 0 (the hand-written
    ``tick_table`` configuration), so ``bubble <= hand_bubble`` holds by
    construction.  ``program`` is the certified
    :class:`~repro.core.schedule.TickProgram` the winner executes;
    ``scored`` keeps every ``(choice, bubble)`` pair — including
    non-executable family members — for reporting.
    """
    choice: ScheduleChoice
    bubble: float
    hand_bubble: float
    program: object
    scored: list


def search_schedule(plan, n_microbatches: int | None = None, *,
                    round_size: int | None = None, iterations: int = 1,
                    bandwidth: float | None = None,
                    transfer_mode: str = "prefetch",
                    candidates: list | None = None,
                    certify: bool = True,
                    device_scale=None) -> SearchResult:
    """Search the schedule family over the existing knobs (injection
    rotation ``g0``, upload-lane policy, standby residency), scored by
    ``simulate_plan``'s two-resource cost when ``bandwidth`` is given
    (compute-lane-only otherwise).

    The hand-written configuration — ``g0 = 0`` with the caller's
    ``transfer_mode`` — is always candidate 0 and is displaced only by a
    *strictly* lower simulated bubble, so the searched schedule is never
    worse than the hand-written ``tick_table``.  Non-executable family
    members are scored for reporting but never win; the returned winner's
    tick program is generated by ``plan.tick_program`` (stamped with the
    winner's ``g0`` — the ring realizes the rotation at trace time) and
    (with ``certify=True``) certified against the five §4.3 constraints by
    ``verify_async_ticks(..., program=...)`` before the runtime sees it.

    ``device_scale`` threads the straggler model into every candidate's
    score: the goodput supervisor calls this with the observed slowdown
    to pick the rotation that advances injection past the slow device.
    """
    raise NotImplementedError(
        "search_schedule is not ported yet: the port runs the hand schedule "
        "(ROADMAP.md, Queue 1, item 10)")
