# Copied from src/repro/core/transfer.py; tests/test_torch_plan.py holds the copy
# equal to it.
"""Priority-aware transfer scheduling engine (paper §4.2).

Activation transfers are critical-path; parameter/gradient transfers are
packed into the M per-micro-batch idle windows between them using
longest-processing-time-first (LPT) bin packing, with oversized tensors split
into chunks first (paper §4.2.2).

On TPU this engine is a *planner*: its output (which weight chunk is fetched
in which tick window) drives the double-buffered weight-prefetch order of the
SPMD dispatch runtime, and the simulator uses it to verify that parameter
traffic fits inside activation-transfer windows (no head-of-line blocking,
paper Fig. 6 vs Fig. 7).
"""
from __future__ import annotations

import dataclasses
import heapq
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class TransferItem:
    name: str
    bytes: int
    chunk_of: str | None = None   # parent tensor if this is a split chunk
    offset: int = 0               # byte offset within the parent tensor
    lane: str = "up"              # "up" (host->GPU weights) | "down" (grads)

    @property
    def end(self) -> int:
        return self.offset + self.bytes


@dataclasses.dataclass
class WindowPlan:
    windows: list[list[TransferItem]]   # per-window chunk assignment
    loads: list[int]                    # per-window byte totals
    chunk_limit: int | None = None      # effective limit the packer settled on

    @property
    def max_load(self) -> int:
        return max(self.loads) if self.loads else 0

    @property
    def total(self) -> int:
        return sum(self.loads)

    def lane_total(self, lane: str) -> int:
        """Bytes assigned to one direction ("up" weight uploads, "down"
        gradient/optimizer downloads) across every window."""
        return sum(c.bytes for w in self.windows for c in w if c.lane == lane)

    @property
    def upload_total(self) -> int:
        return self.lane_total("up")

    @property
    def download_total(self) -> int:
        return self.lane_total("down")


def split_oversized(items: Sequence[TransferItem], chunk_limit: int) -> list[TransferItem]:
    """Split tensors larger than ``chunk_limit`` into near-equal chunks
    (paper: 'In case of very large tensors (e.g., language model head), we
    split them into smaller chunks before scheduling')."""
    if chunk_limit <= 0:
        raise ValueError("chunk_limit must be positive")
    out: list[TransferItem] = []
    for it in items:
        if it.bytes <= chunk_limit:
            out.append(it)
            continue
        n_chunks = -(-it.bytes // chunk_limit)
        base, rem = divmod(it.bytes, n_chunks)
        off = it.offset
        for c in range(n_chunks):
            size = base + (1 if c < rem else 0)
            out.append(TransferItem(f"{it.name}#{c}", size,
                                    it.chunk_of or it.name, off, it.lane))
            off += size
    return out


def lpt_pack(items: Sequence[TransferItem], n_windows: int,
             *, chunk_limit: int | None = None) -> WindowPlan:
    """LPT (Graham 1969): sort descending, assign to least-loaded window.

    Guarantees max_load <= total/n_windows + max_item (and <= 4/3 OPT for the
    makespan objective), which is what bounds head-of-line blocking.
    """
    if n_windows <= 0:
        raise ValueError("need at least one window")
    if chunk_limit is not None:
        items = split_oversized(items, chunk_limit)
    heap = [(0, w) for w in range(n_windows)]   # (load, window)
    heapq.heapify(heap)
    windows: list[list[TransferItem]] = [[] for _ in range(n_windows)]
    loads = [0] * n_windows
    for it in sorted(items, key=lambda x: (-x.bytes, x.name)):
        load, w = heapq.heappop(heap)
        windows[w].append(it)
        loads[w] = load + it.bytes
        heapq.heappush(heap, (loads[w], w))
    return WindowPlan(windows, loads, chunk_limit)


def plan_stage_transfers(
    param_bytes: dict[str, int],
    n_microbatches: int,
    *,
    download_bytes: dict[str, int] | None = None,
    window_capacity_bytes: int | None = None,
    chunk_limit: int | None = None,
    min_chunk_bytes: int | None = None,
) -> WindowPlan:
    """Plan one stage's parameter uploads across its M data-transfer windows.

    ``download_bytes`` optionally adds the stage's return traffic — the
    gradient/optimizer-copy downloads of the §4.3 consistency protocol — as
    ``lane="down"`` items packed into the same window budget (the
    conservative half-duplex model: one link moves both directions inside a
    micro-batch window).  Under full fine-tuning downloads equal uploads and
    can push a stage over capacity; a frozen-base (LoRA) stage downloads
    only adapter bytes, which is why adapter runs stay feasible where
    full-rank overflows (see ``LayerCost.trainable_bytes``).

    If ``window_capacity_bytes`` is given (bytes PCIe/ICI can move during one
    micro-batch compute), the chunk limit is progressively halved (paper
    §4.2.2) until the LPT packing fits under the capacity: LPT only bounds
    ``max_load <= total/M + max_item``, so capacity-sized chunks can still
    overshoot even when finer chunks pack exactly (e.g. two 1.5x-capacity
    tensors into 3 windows).  Only when the limit reaches ``min_chunk_bytes``
    (default capacity/256) without fitting is the workload truly infeasible
    and OverflowError raised — the caller should then grow M or shrink the
    stage (ties into the partitioner's memory/time caps).
    """
    items = [TransferItem(k, v) for k, v in sorted(param_bytes.items())]
    if download_bytes:
        items += [TransferItem(f"down:{k}", v, lane="down")
                  for k, v in sorted(download_bytes.items()) if v > 0]
    if chunk_limit is None and window_capacity_bytes is not None:
        chunk_limit = window_capacity_bytes
    plan = lpt_pack(items, n_microbatches, chunk_limit=chunk_limit)
    if window_capacity_bytes is not None and plan.max_load > window_capacity_bytes:
        floor = min_chunk_bytes or max(1, window_capacity_bytes // 256)
        while (plan.max_load > window_capacity_bytes
               and chunk_limit is not None and chunk_limit > floor):
            chunk_limit = max(floor, chunk_limit // 2)
            plan = lpt_pack(items, n_microbatches, chunk_limit=chunk_limit)
        if plan.max_load > window_capacity_bytes:
            raise OverflowError(
                f"parameter traffic {plan.total}B cannot hide inside "
                f"{n_microbatches} windows of {window_capacity_bytes}B "
                f"(best max window load {plan.max_load}B at "
                f"chunk_limit {chunk_limit})"
            )
    return plan
