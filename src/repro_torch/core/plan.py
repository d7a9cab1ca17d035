# Copied from src/repro/core/plan.py; tests/test_torch_plan.py holds the copy
# equal to it, apart from default_layer_costs, which counts a layer's
# parameters from the port's own init_layer.
"""ExecutionPlan: the single object tying partition -> schedule -> execution.

This module is the junction of the paper's three subsystems:

* the automatic asymmetric partitioner (:mod:`repro.core.partition`,
  paper §4.4) decides *which layers form which stage*;
* the round-robin schedule generator (:mod:`repro.core.schedule`,
  paper §3.2) decides *which worker runs which stage when*;
* the priority-aware transfer planner (:mod:`repro.core.transfer`,
  paper §4.2) decides *in which idle window each weight chunk is prefetched*.

``compile_plan`` fuses the three into one :class:`ExecutionPlan` that BOTH
consumers execute: the event-driven simulator (`core/simulator.simulate_plan`)
and the SPMD dispatch runtime (`core/dispatch.build_roundpipe_train_step`).
Because both read the same compiled object, the simulated schedule and the
executed schedule are provably identical — the property the paper's headline
numbers rest on.

Slot model
----------
A plan is a sequence of *slots* (``StageSpec``), the unit the weight ring
moves per tick:

    slot 0 .. Sf-1      'F'   plain forward stages (shallow -> deep)
    slot Sf             'FB'  the fused first-backward stage (paper §3.2):
                              forward of the deepest block + LM head + loss
                              AND their backward in one slot
    slot Sf+1 .. S-1    'B'   backward-with-recompute stages (deep -> shallow)

Stages are *uneven*: each slot owns a contiguous, variable-size set of layer
ids.  The optional LM-head pseudo-layer (cost-model id ``n_body_layers``)
always lives in the fused slot — the runtime computes head+loss there with
replicated head weights, so the pseudo-layer never enters the weight ring.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

from .partition import (LayerCost, Partition, auto_partition,
                        quant_upload_bytes)
from .schedule import (Schedule, TickProgram, TickRecord,
                       roundpipe_schedule)
from .transfer import WindowPlan, plan_stage_transfers


def pool_layout(n_layers: int, n_workers: int) -> tuple[int, int]:
    """The layer-pool shard layout: ``(padded_rows, rows_per_worker)``.

    Single source of truth shared by the dispatch runtime (``pool_rows`` /
    ``pad_pool`` / gradient deposit) and ``prefetch_program``'s
    owner/pool_row tables — layer ``l`` lives in row ``l % rows_per_worker``
    of worker ``l // rows_per_worker``'s shard.
    """
    per = -(-n_layers // n_workers)
    return per * n_workers, per


@dataclasses.dataclass(frozen=True)
class ChunkUpload:
    """One static upload: a byte-range of one layer's weights, streamed in
    idle window ``window`` of the tick preceding ``slot``'s injection, into
    ring-buffer row ``row`` of the standby block.

    ``layer``/``row``/``owner``/``pool_row`` are -1 for the replicated
    LM-head pseudo-layer: its bytes occupy a window in the transfer budget
    (the simulator charges them) but the TPU runtime never moves it — head
    weights are replicated, not ring-resident.
    """
    slot: int            # destination ring slot
    window: int          # idle window (0..n_windows-1) carrying the chunk
    name: str            # chunk name ("layer3#1", "lm_head", ...)
    layer: int           # global layer id (-1: replicated head)
    row: int             # row within the slot's ring block (-1: head)
    owner: int           # pool shard (worker) owning the layer (-1: head)
    pool_row: int        # row within the owner's local pool shard (-1: head)
    lo: int              # chunk byte range within the parent tensor
    hi: int
    parent_bytes: int    # parent tensor's total planned bytes

    @property
    def bytes(self) -> int:
        return self.hi - self.lo


@dataclasses.dataclass(frozen=True)
class PrefetchProgram:
    """Compiled per-tick upload tables for the double-buffered weight
    uploader (paper §4.2): slot ``s``'s table streams into the standby
    buffer during tick ``s - 1`` (slot 0 during the fill prologue), so the
    block lands row-by-row across the preceding slot's compute windows
    instead of as one head-of-line burst.

    ``uploads[s]`` is window-major: all of window 0's chunks, then window
    1's, ... — the order the runtime issues the copies and the order the
    simulator charges them against link bandwidth.

    Tables are per-SLOT, not per-tick: a multi-round step (see
    ``ExecutionPlan.tick_table``) replays table ``t % S`` at tick ``t``,
    so the same compiled chunk order serves every round without
    recompilation (the weights a slot streams are round-invariant).
    """
    n_workers: int
    n_windows: int
    window_capacity_bytes: int | None
    window_plans: tuple         # per-slot WindowPlan (the LPT packings)
    uploads: tuple              # per-slot tuple[ChunkUpload], window-major

    @property
    def n_slots(self) -> int:
        return len(self.uploads)

    @property
    def max_window_load(self) -> int:
        return max((wp.max_load for wp in self.window_plans), default=0)

    @property
    def total_bytes(self) -> int:
        return sum(wp.total for wp in self.window_plans)

    def validate(self, plan: "ExecutionPlan") -> None:
        """Raise ValueError unless every ring row of every slot is covered
        exactly (contiguous, gap-free byte ranges per parent tensor)."""
        if self.n_slots != plan.n_slots:
            raise ValueError(
                f"{self.n_slots} upload tables for {plan.n_slots} slots")
        for stage, table in zip(plan.stages, self.uploads):
            spans: dict[int, list] = {l: [] for l in stage.layers}
            for cu in table:
                if cu.slot != stage.slot:
                    raise ValueError(f"upload {cu.name} routed to slot "
                                     f"{cu.slot}, table is slot {stage.slot}")
                if cu.layer < 0:
                    if not stage.includes_head:
                        raise ValueError(f"head chunk in headless slot {stage.slot}")
                    continue
                if cu.layer not in spans:
                    raise ValueError(
                        f"upload {cu.name} targets layer {cu.layer}, not in "
                        f"slot {stage.slot}'s block {stage.layers}")
                spans[cu.layer].append((cu.lo, cu.hi))
            for l, ranges in spans.items():
                ranges.sort()
                want = int(plan.layer_costs[l].upload_stream_bytes)
                pos = 0
                for lo, hi in ranges:
                    if lo != pos:
                        raise ValueError(
                            f"slot {stage.slot} layer {l}: gap at byte {pos}")
                    pos = hi
                if pos != want:
                    raise ValueError(
                        f"slot {stage.slot} layer {l}: covered {pos}B of {want}B")


@dataclasses.dataclass(frozen=True)
class StageSpec:
    """One ring slot: a contiguous block of body layers (possibly empty for a
    head-only fused slot) executed as a unit by whichever worker holds it."""
    slot: int              # position in the unified F..FB..B slot sequence
    kind: str              # 'F' | 'FB' | 'B'
    layers: tuple          # body layer ids, ascending & contiguous; may be ()
    cost: float            # schedule-time duration of this slot
    includes_head: bool = False

    @property
    def start(self) -> int:
        return self.layers[0] if self.layers else 0

    @property
    def size(self) -> int:
        return len(self.layers)


@dataclasses.dataclass(frozen=True)
class ExecutionPlan:
    """Compiled partition + schedule + prefetch order (see module docstring)."""
    n_workers: int
    n_layers: int          # body (ring-resident) layers
    partition: Partition   # the auto_partition output this plan was built from
    stages: tuple          # tuple[StageSpec] in slot order
    layer_costs: tuple     # tuple[LayerCost]; body layers + optional head
    has_head_stage: bool   # cost model included an LM-head pseudo-layer

    # ---- derived views -----------------------------------------------------
    @property
    def n_fwd(self) -> int:
        return sum(1 for s in self.stages if s.kind == "F")

    @property
    def n_slots(self) -> int:
        return len(self.stages)

    @property
    def fused(self) -> StageSpec:
        return self.stages[self.n_fwd]

    @property
    def max_block(self) -> int:
        """Ring buffer depth: the largest body-layer block of any slot."""
        return max(1, max(s.size for s in self.stages))

    @property
    def fwd_costs(self) -> tuple:
        return tuple(s.cost for s in self.stages if s.kind == "F")

    @property
    def bwd_costs(self) -> tuple:
        return tuple(s.cost for s in self.stages if s.kind != "F")

    @property
    def stage_bytes(self) -> tuple:
        """Per-slot weight UPLOAD bytes (body layers + head when fused
        carries it) — what the two-resource simulator charges against the
        host->GPU direction of the link.  Frozen-base (LoRA) plans upload
        the same dense blocks; only downloads shrink.  Quantized-pool plans
        (``LayerCost.upload_bytes`` set) charge the code+scale payload the
        uploader actually streams instead of the dense block."""
        out = []
        for s in self.stages:
            b = sum(int(self.layer_costs[l].upload_stream_bytes)
                    for l in s.layers)
            if s.includes_head:
                b += int(self.layer_costs[-1].upload_stream_bytes)
            out.append(b)
        return tuple(out)

    @property
    def stage_download_bytes(self) -> tuple:
        """Per-slot gradient/optimizer DOWNLOAD bytes (§4.3 consistency
        traffic): each backward/FB slot ships its layers'
        ``LayerCost.download_bytes`` (= ``trainable_bytes`` when set, else
        the full weight bytes) back to the host after its visit; forward
        slots deposit nothing.  This is the lane a frozen-base LoRA plan
        shrinks by orders of magnitude."""
        out = []
        for s in self.stages:
            if s.kind == "F":
                out.append(0)
                continue
            b = sum(int(self.layer_costs[l].download_bytes) for l in s.layers)
            if s.includes_head:
                b += int(self.layer_costs[-1].download_bytes)
            out.append(b)
        return tuple(out)

    # ---- the two consumers -------------------------------------------------
    def rounds_for(self, n_microbatches: int) -> int:
        """Number of back-to-back rounds ``R = M / N`` a step with
        ``n_microbatches`` micro-batches executes (paper §3.2 steady state:
        each round feeds one resident micro-batch group per worker)."""
        if n_microbatches < self.n_workers:
            raise ValueError(
                f"n_microbatches {n_microbatches} < n_workers "
                f"{self.n_workers}: each round needs one resident "
                f"micro-batch group per worker — raise the micro-batch "
                f"count to a multiple of {self.n_workers}")
        if n_microbatches % self.n_workers:
            raise ValueError(
                f"n_microbatches {n_microbatches} is not a multiple of "
                f"n_workers {self.n_workers}: the runtime executes whole "
                f"rounds of {self.n_workers} resident groups — choose "
                f"M = R*{self.n_workers}")
        return n_microbatches // self.n_workers

    def tick_table(self, rounds: int = 1, iterations: int = 1) -> tuple:
        """The round-stitched injection order BOTH consumers follow.

        Entry ``t`` (one per ring tick, ``I*R*S + N - 1`` total) is the
        ``(round, slot)`` injected at worker 0 at tick ``t`` — consecutive
        rounds stitch back-to-back (``t -> divmod(t, S)``), so the
        ``N - 1``-tick drain (the trailing ``None`` entries) is paid once
        per table rather than once per round.  The dispatch runtime
        iterates exactly this table, reusing slot ``t % S``'s compiled
        :class:`ChunkUpload` tables every round; the round-robin schedule
        generator dispatches slots in the same stitched order (asserted in
        ``tests/test_multiround_plan.py``).

        ``iterations > 1`` is the cross-step asynchronous-optimizer regime
        (paper §4.3, DESIGN.md §6): optimizer steps chain back-to-back
        exactly like rounds, so the ``round`` field is a GLOBAL round index
        ``0 .. I*R-1`` (step ``T`` owns rounds ``T*R .. (T+1)*R - 1``) and
        the single fill/drain is amortized over all ``I`` steps — valid
        only under staleness-1 parameter reads, which is what
        ``repro.core.consistency.verify_async_ticks`` certifies.
        """
        return self.tick_program(rounds, iterations).entries

    def tick_program(self, rounds: int = 1, iterations: int = 1, *,
                     g0: int = 0) -> TickProgram:
        """Generate the per-tick schedule IR both dispatch drivers execute
        (DESIGN.md §8): ``tick_table``'s injection order annotated with the
        standby-upload, gradient-deposit and optimizer-update actions of
        every tick, so the drivers contain no scheduling arithmetic of
        their own.  ``repro.core.consistency.verify_async_ticks(...,
        program=...)`` certifies a program's annotations against the §4.3
        event-protocol replay before the async builder compiles it.
        ``g0`` stamps the injection-rotation the runtime realizes through
        the ring's permutation endpoints; the records themselves are
        logical-coordinate and g0-invariant."""
        if rounds < 1:
            raise ValueError(f"rounds must be >= 1, got {rounds}")
        if iterations < 1:
            raise ValueError(f"iterations must be >= 1, got {iterations}")
        if not 0 <= g0 < self.n_workers:
            raise ValueError(f"g0 must be in [0, {self.n_workers}), got {g0}")
        s = self.n_slots
        n = self.n_workers
        rs = rounds * s
        live = iterations * rs
        records = []
        for t in range(live + n - 1):
            entry = divmod(t, s) if t < live else None
            inject_step = entry[0] // rounds if entry is not None else None
            if t + 1 < live:
                nr, nslot = divmod(t + 1, s)
                upload = (nslot, nr // rounds)
            else:
                upload = None
            g = t - (n - 1)                # global stitched slot exiting now
            deposit = None
            update_step = None
            if 0 <= g < live:
                if self.stages[g % s].kind != "F":
                    deposit = g % s
                if (g + 1) % rs == 0:      # step g//rs fully drained: D_k
                    update_step = g // rs
            records.append(TickRecord(t, entry, inject_step, upload,
                                      deposit, update_step))
        return TickProgram(n, s, rounds, iterations, tuple(records), g0)

    def validate_async(self, rounds: int = 1) -> None:
        """Raise unless cross-step chaining (``tick_table(iterations > 1)``)
        is feasible at ``rounds`` rounds per step: step ``T``'s first
        injection (tick ``T*R*S``) must come strictly after step ``T-2``'s
        gradients finish draining (tick ``(T-1)*R*S + N - 2``), i.e.
        ``R*S >= N - 1`` — otherwise even a staleness-1 read would consume
        parameters whose update is still waiting on in-flight gradients."""
        rs = rounds * self.n_slots
        if rs < self.n_workers - 1:
            raise ValueError(
                f"cross-step chaining infeasible: {rounds} round(s) x "
                f"{self.n_slots} slots = {rs} live ticks per step, but the "
                f"drain is {self.n_workers - 1} ticks — step T's injection "
                f"would overtake step T-2's gradient drain.  Raise rounds "
                f"to >= {-(-(self.n_workers - 1) // self.n_slots)}")

    def schedule(self, n_microbatches: int, *, round_size: int | None = None,
                 iterations: int = 1, g0: int = 0) -> Schedule:
        """The round-robin dispatch schedule for this plan (paper §3.2).

        The simulator executes exactly this; the dispatch runtime realizes
        ``round_size == n_workers`` with ``M / N`` rounds stitched
        back-to-back per training step (``tick_table``) — one resident
        micro-batch group per worker per round, gradients accumulated
        across rounds.
        """
        return roundpipe_schedule(
            self.n_workers, n_microbatches, list(self.fwd_costs),
            list(self.bwd_costs), round_size=round_size, g0=g0,
            iterations=iterations)

    def prefetch(self, n_windows: int | None = None,
                 *, window_capacity_bytes: int | None = None,
                 chunk_limit: int | None = None,
                 include_downloads: bool = False) -> tuple:
        """Per-slot transfer plans (paper §4.2): each slot's weight bytes
        LPT-packed into its idle windows — the prefetch order a
        double-buffered weight uploader follows, and what the simulator
        checks to confirm parameter traffic hides inside activation
        windows.  ``prefetch_program`` compiles these into the static
        upload tables the dispatch runtime executes.

        ``include_downloads`` additionally packs each backward slot's
        gradient-deposit bytes (``LayerCost.download_bytes``) into the same
        window budget — the half-duplex feasibility view used by the
        transfer-overlap study; leave False when compiling upload tables."""
        m = n_windows or self.n_workers
        plans = []
        for stage in self.stages:
            names = {f"layer{l}": int(self.layer_costs[l].upload_stream_bytes)
                     for l in stage.layers}
            down = None
            if include_downloads and stage.kind != "F":
                down = {f"layer{l}": int(self.layer_costs[l].download_bytes)
                        for l in stage.layers}
            if stage.includes_head:
                names["lm_head"] = int(self.layer_costs[-1].upload_stream_bytes)
                if down is not None:
                    down["lm_head"] = int(self.layer_costs[-1].download_bytes)
            plans.append(plan_stage_transfers(
                names, m, download_bytes=down,
                window_capacity_bytes=window_capacity_bytes,
                chunk_limit=chunk_limit))
        return tuple(plans)

    def prefetch_program(self, n_windows: int | None = None,
                         *, window_capacity_bytes: int | None = None,
                         chunk_limit: int | None = None) -> PrefetchProgram:
        """Compile the prefetch order into per-tick static upload tables
        (see :class:`PrefetchProgram`): each WindowPlan chunk becomes a
        :class:`ChunkUpload` naming its pool owner, standby ring row and
        byte-range — everything the chunked double-buffered uploader in
        ``core/dispatch.py`` needs, resolved at trace time."""
        window_plans = self.prefetch(n_windows,
                                     window_capacity_bytes=window_capacity_bytes,
                                     chunk_limit=chunk_limit)
        _, per = pool_layout(self.n_layers, self.n_workers)
        uploads = []
        for stage, wp in zip(self.stages, window_plans):
            row_of = {f"layer{l}": (k, l) for k, l in enumerate(stage.layers)}
            table = []
            for w, window in enumerate(wp.windows):
                for c in window:
                    if c.lane != "up":        # downloads are never ring uploads
                        continue
                    parent = c.chunk_of or c.name
                    if parent in row_of:
                        row, layer = row_of[parent]
                        owner, pool_row = divmod(layer, per)
                        pbytes = int(self.layer_costs[layer].upload_stream_bytes)
                    else:                     # replicated LM head: budget only
                        row = layer = owner = pool_row = -1
                        pbytes = int(self.layer_costs[-1].upload_stream_bytes)
                    table.append(ChunkUpload(
                        slot=stage.slot, window=w, name=c.name, layer=layer,
                        row=row, owner=owner, pool_row=pool_row,
                        lo=c.offset, hi=c.offset + c.bytes,
                        parent_bytes=pbytes))
            uploads.append(tuple(table))
        program = PrefetchProgram(
            n_workers=self.n_workers, n_windows=n_windows or self.n_workers,
            window_capacity_bytes=window_capacity_bytes,
            window_plans=window_plans, uploads=tuple(uploads))
        program.validate(self)
        return program

    # ---- validation --------------------------------------------------------
    def validate(self) -> None:
        """Raise ValueError unless the plan is a sound execution order."""
        sf = self.n_fwd
        if not self.stages:
            raise ValueError("empty plan")
        for i, s in enumerate(self.stages):
            if s.slot != i:
                raise ValueError(f"slot index mismatch at {i}: {s.slot}")
            if not s.layers and s.kind != "FB":
                # only the fused slot may be body-empty (head-only); an empty
                # F/B slot would run with start==0 at runtime and corrupt the
                # embedding-gradient deposit
                raise ValueError(f"empty {s.kind} slot {i}")
            if s.layers and list(s.layers) != list(
                    range(s.layers[0], s.layers[-1] + 1)):
                raise ValueError(f"slot {i} layers not contiguous: {s.layers}")
        kinds = [s.kind for s in self.stages]
        if kinds != ["F"] * sf + ["FB"] + ["B"] * (self.n_slots - sf - 1):
            raise ValueError(f"bad slot kind sequence: {kinds}")
        fused = self.stages[sf]
        fwd_layers = [l for s in self.stages[:sf] for l in s.layers]
        fwd_covered = self.n_layers - fused.size
        if fwd_layers != list(range(fwd_covered)):
            raise ValueError(
                f"forward slots cover {fwd_layers}, want 0..{fwd_covered - 1}")
        if fused.layers and fused.layers[-1] != self.n_layers - 1:
            raise ValueError("fused slot must contain the deepest body layer")
        bwd = self.stages[sf:]
        bwd_layers = [l for s in bwd for l in s.layers]
        if sorted(bwd_layers) != list(range(self.n_layers)):
            raise ValueError(
                f"backward slots cover {sorted(bwd_layers)}, "
                f"want 0..{self.n_layers - 1}")
        for a, b in zip(bwd, bwd[1:]):           # deepest-first execution order
            if a.layers and b.layers and b.layers[-1] + 1 != a.layers[0]:
                raise ValueError("backward slots not deepest-first contiguous")
        if self.has_head_stage and not fused.includes_head:
            raise ValueError("head pseudo-layer must live in the fused slot")
        if any(s.includes_head for s in self.stages if s.kind != "FB"):
            raise ValueError("only the fused slot may include the LM head")

    def describe(self) -> str:
        parts = []
        for s in self.stages:
            span = f"{s.layers[0]}..{s.layers[-1]}" if s.layers else "-"
            head = "+head" if s.includes_head else ""
            parts.append(f"{s.kind}[{span}{head}]")
        return (f"ExecutionPlan(N={self.n_workers}, L={self.n_layers}, "
                f"slots={' '.join(parts)}, t_max={self.partition.t_max:.3g})")


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------

def compile_plan(partition: Partition, layer_costs: Sequence[LayerCost],
                 *, n_workers: int,
                 n_body_layers: int | None = None) -> ExecutionPlan:
    """Compile a :class:`Partition` into an executable/simulatable plan.

    ``n_body_layers`` — number of real model layers.  When it equals
    ``len(layer_costs) - 1`` the final cost-model entry is the LM-head
    pseudo-layer (paper Fig. 1's "layer 13"), which must land in the fused
    backward stage; it is recorded as ``includes_head`` rather than as a ring
    layer.  ``None`` means every cost entry is a body layer.
    """
    layer_costs = tuple(layer_costs)
    l_total = len(layer_costs)
    if n_body_layers is None:
        n_body = l_total
    elif n_body_layers == l_total:
        n_body = l_total
    elif n_body_layers == l_total - 1:
        n_body = n_body_layers
    else:
        raise ValueError(
            f"{l_total} cost layers cannot model {n_body_layers} body layers "
            f"(want L or L+1 with a trailing head pseudo-layer)")
    head_id = l_total - 1 if n_body < l_total else None

    fcosts, bcosts = partition.stage_costs(layer_costs)
    stages: list[StageSpec] = []
    for ids, cost in zip(partition.fwd_stages, fcosts):
        if head_id is not None and head_id in ids:
            raise ValueError("LM-head pseudo-layer in a forward stage")
        stages.append(StageSpec(len(stages), "F", tuple(ids), cost))
    for j, (ids, cost) in enumerate(zip(partition.bwd_stages, bcosts)):
        body = tuple(i for i in ids if i != head_id)
        includes_head = head_id is not None and head_id in ids
        kind = "FB" if j == 0 else "B"
        if includes_head and kind != "FB":
            raise ValueError("LM-head pseudo-layer outside the fused stage")
        stages.append(StageSpec(len(stages), kind, body, cost, includes_head))
    plan = ExecutionPlan(n_workers=n_workers, n_layers=n_body,
                         partition=partition, stages=tuple(stages),
                         layer_costs=layer_costs,
                         has_head_stage=head_id is not None)
    plan.validate()
    return plan


def uniform_partition(n_layers: int, *, fwd_cost: float = 1.0,
                      grad_ratio: float = 2.0) -> Partition:
    """The degenerate 1-layer-per-stage partition (the seed runtime's only
    mode): L-1 forward slots, a 1-layer fused slot, L-1 backward slots."""
    if n_layers < 1:
        raise ValueError("need at least one layer")
    fwd = tuple((i,) for i in range(n_layers - 1))
    bwd = tuple((i,) for i in range(n_layers - 1, -1, -1))
    t_max = fwd_cost * (1.0 + grad_ratio)
    return Partition(fwd_stages=fwd, bwd_stages=bwd, t_max=t_max,
                     objective=float("nan"), n_stages=2 * n_layers - 1)


def default_layer_costs(cfg, *, head_stage: bool = True,
                        grad_ratio: float = 2.0,
                        lora=None,
                        pool_dtype: str = "none") -> list[LayerCost]:
    """Cost model derived from the architecture: per-layer cost proportional
    to its parameter count (flops proxy at fixed batch), head pseudo-layer
    proportional to ``d_model * vocab_size``.  Weight bytes assume bf16.

    ``lora`` (a :class:`repro_torch.models.lora.LoraConfig`) switches on the
    frozen-base split byte accounting: uploads stay dense (the ring still
    carries full blocks) but ``trainable_bytes`` — the gradient-deposit and
    optimizer-copy download traffic — shrinks to the adapter factors, and
    the frozen LM head downloads nothing.

    ``pool_dtype`` (``"int8"`` | ``"int4"``) switches body-layer uploads to
    the quantized code+scale payload (``LayerCost.upload_bytes``); the
    replicated LM head is never ring-streamed, so its budget entry stays at
    the dense bytes either way."""
    from repro_torch.models.transformer import init_layer

    def count(node):    # leaves nest two deep (attn.w_q) or three (rwkv.time.w_r)
        return sum(map(count, node.values())) if isinstance(node, dict) else node.numel()

    # one layer on the meta device: shapes only, nothing allocated
    layer_params = count(init_layer(None, cfg, device="meta"))
    scale = 1.0 / max(layer_params, 1)
    trainable = None
    if lora is not None:
        from repro_torch.models.lora import adapter_params_per_layer
        trainable = 2 * adapter_params_per_layer(cfg, lora)
    upload = quant_upload_bytes(layer_params, pool_dtype)
    out = [LayerCost(1.0, grad_ratio, weight_bytes=2 * layer_params,
                     trainable_bytes=trainable, upload_bytes=upload)
           for _ in range(cfg.n_layers)]
    if head_stage:
        head_params = cfg.d_model * cfg.vocab_size
        c = head_params * scale
        out.append(LayerCost(c, c * grad_ratio, weight_bytes=2 * head_params,
                             trainable_bytes=0 if lora is not None else None))
    return out


def plan_from_config(cfg, n_workers: int, *,
                     n_microbatches: int | None = None,
                     partition: Partition | None = None,
                     head_stage: bool | None = None,
                     mem_cap_bytes: float = float("inf"),
                     lora=None,
                     pool_dtype: str = "none") -> ExecutionPlan:
    """The default plan for ``StepConfig(strategy="roundpipe")``: build the
    architecture's cost model, auto-partition it (paper §4.4) unless an
    explicit :class:`Partition` is given, and compile.

    ``head_stage=None`` (default) models the LM-head pseudo-layer when
    auto-partitioning, and infers its presence from the deepest covered id
    when a hand ``partition`` is supplied; pass an explicit bool to
    override (compile_plan raises if it contradicts the partition).

    ``lora`` threads a :class:`repro.models.lora.LoraConfig` into the cost
    model so ``stage_download_bytes`` (and the two-resource simulation)
    reflect adapter-only gradient traffic; the partition itself is
    unchanged — compute costs and uploads are identical either way.

    ``pool_dtype`` likewise only changes byte accounting
    (``stage_bytes`` / prefetch budgets charge the quantized payload);
    the partition still packs against dense ``weight_bytes`` memory.
    """
    if head_stage is None:
        head_stage = True if partition is None else \
            partition.bwd_stages[0][-1] == cfg.n_layers
    costs = default_layer_costs(cfg, head_stage=head_stage, lora=lora,
                                pool_dtype=pool_dtype)
    if partition is None:
        partition = auto_partition(
            costs, n_devices=n_workers,
            n_microbatches=n_microbatches or n_workers,
            mem_cap_bytes=mem_cap_bytes)
    return compile_plan(partition, costs, n_workers=n_workers,
                        n_body_layers=cfg.n_layers)


@dataclasses.dataclass(frozen=True)
class ReplanResult:
    """Outcome of :func:`replan_for_survivors` — everything the goodput
    supervisor needs to rebuild a step on the smaller mesh.

    ``n_microbatches`` is the adjusted ``M' = R' * N'`` (the requested M
    rounded DOWN to a multiple of the surviving worker count, floor one
    round); ``rounds`` is ``plan.rounds_for(M')``.  ``async_ok`` reports
    whether cross-step chaining stays feasible at the new shape — when
    ``R'*S' < N'-1`` the replan refuses async loudly (``async_refusal``
    carries ``validate_async``'s message) and the caller must fall back to
    the synchronous step (DESIGN.md §9).
    """
    plan: ExecutionPlan
    n_microbatches: int
    rounds: int
    async_ok: bool
    async_refusal: str | None = None


def replan_for_survivors(cfg, n_surviving: int, *,
                         n_microbatches: int | None = None,
                         async_steps: int = 1,
                         lora=None, pool_dtype: str = "none",
                         mem_cap_bytes: float = float("inf")) -> ReplanResult:
    """Re-derive the execution plan after losing workers (paper §3's
    elasticity claim made operational): stages are data + a slot index, not
    device bindings, so a dead worker is a *schedule change* — re-run the
    cost model + auto-partitioner for the surviving ``N'``, re-derive the
    round count, and report whether the async regime survives the shrink.

    The supervisor (``repro.runtime.supervisor``) calls this on a
    dead-worker event, then restores the newest checkpoint through the
    elastic re-shard path onto the ``N'``-worker mesh.
    """
    if n_surviving < 1:
        raise ValueError(
            f"cannot replan for {n_surviving} surviving workers")
    m_req = n_microbatches or n_surviving
    m = max(n_surviving, (m_req // n_surviving) * n_surviving)
    plan = replanned = plan_from_config(
        cfg, n_surviving, n_microbatches=m, lora=lora,
        pool_dtype=pool_dtype, mem_cap_bytes=mem_cap_bytes)
    rounds = replanned.rounds_for(m)
    async_ok, refusal = True, None
    if async_steps > 1:
        try:
            plan.validate_async(rounds)
        except ValueError as e:
            async_ok, refusal = False, str(e)
    return ReplanResult(plan=plan, n_microbatches=m, rounds=rounds,
                        async_ok=async_ok, async_refusal=refusal)
