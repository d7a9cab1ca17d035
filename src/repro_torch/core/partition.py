# Copied from src/repro/core/partition.py; tests/test_torch_plan.py holds the copy
# equal to it.
"""Automatic asymmetric stage partitioning (paper §4.4).

Given per-layer forward times ``f_l``, gradient times ``g_l`` (backward minus
recompute) and per-layer memory, find forward/backward partitions minimising
``(M*S + N*(N-1)) * t_max`` subject to a per-stage memory cap.

Candidate ``t_max`` values are all contiguous-subsequence sums of forward and
backward stage costs (O(L^2) candidates); each candidate is checked with an
O(L) greedy packer, giving the paper's O(L^3) total.  The greedy fills the
first backward stage (the fused FB stage) as full as possible first — its
forward pass doubles as recompute, so every layer placed there saves one
forward execution (paper §4.4.2).

Cost model
----------
* forward stage cost           = sum f_l
* fused FB stage cost          = sum (f_l + g_l)       (fwd serves as recompute)
* plain backward stage cost    = sum (f_l + g_l)       (recompute + grad)
The fused stage saves time not by being cheaper per-slot but by removing its
layers from the forward partition entirely.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence


@dataclasses.dataclass(frozen=True)
class LayerCost:
    fwd: float            # forward time
    grad: float           # dgrad+wgrad time (backward-with-recompute = fwd+grad)
    weight_bytes: int = 0
    act_bytes: int = 0    # per-micro-batch boundary activation
    # Split byte accounting (frozen-base / LoRA): ``weight_bytes`` is what the
    # host must UPLOAD to run the layer (the full dense block either way);
    # ``trainable_bytes`` is what travels back DOWN per step — the gradient
    # deposit and the §4.3 optimizer-copy traffic.  None = every parameter
    # trains (downloads equal uploads, the full-fine-tune default).
    trainable_bytes: int | None = None
    # Quantized-pool accounting: ``upload_bytes`` is the bytes that actually
    # cross the up lane when the resident pool streams as a code+scale
    # payload (dequantized on-device at promote-standby time).  None = the
    # pool streams in compute precision (upload equals ``weight_bytes``).
    # ``weight_bytes`` keeps the on-device / memory-cap semantics either way.
    upload_bytes: int | None = None

    @property
    def download_bytes(self) -> int:
        """Per-step gradient/optimizer download traffic for this layer."""
        return self.weight_bytes if self.trainable_bytes is None \
            else self.trainable_bytes

    @property
    def upload_stream_bytes(self) -> int:
        """Per-visit weight upload traffic: the quantized payload when the
        pool is quantized, else the dense block."""
        return self.weight_bytes if self.upload_bytes is None \
            else self.upload_bytes


# One fp32 scale per QUANT_BLOCK elements — must match
# ``repro.kernels.dequant.QUANT_BLOCK`` (kept as a literal so the cost-model
# layer stays jax-free).
QUANT_BLOCK = 256
POOL_DTYPE_BITS = {"int8": 8, "int4": 4}


def quant_upload_bytes(n_elems: int, pool_dtype: str) -> int | None:
    """Bytes of the code+scale payload for ``n_elems`` pool elements.

    int8: one code byte per element; int4: two codes per byte; both plus one
    fp32 scale per :data:`QUANT_BLOCK`-element block.  Codes are counted at
    the block-padded length — exactly what the dispatch runtime ships.
    ``pool_dtype`` of ``None``/``"none"`` returns None (dense streaming).
    """
    if pool_dtype in (None, "none"):
        return None
    if pool_dtype not in POOL_DTYPE_BITS:
        raise ValueError(f"unknown pool_dtype {pool_dtype!r}; "
                         f"expected none|{'|'.join(POOL_DTYPE_BITS)}")
    nblocks = -(-n_elems // QUANT_BLOCK)
    code_bytes = nblocks * QUANT_BLOCK * POOL_DTYPE_BITS[pool_dtype] // 8
    return code_bytes + 4 * nblocks


@dataclasses.dataclass(frozen=True)
class Partition:
    fwd_stages: tuple      # tuple[tuple[int]] layer ids per forward stage
    bwd_stages: tuple      # tuple[tuple[int]]; stage 0 is the fused FB stage
    t_max: float
    objective: float
    n_stages: int

    @property
    def fused_layers(self) -> tuple:
        return self.bwd_stages[0]

    def stage_costs(self, layers: Sequence[LayerCost]) -> tuple[list[float], list[float]]:
        f = [sum(layers[i].fwd for i in st) for st in self.fwd_stages]
        b = [sum(layers[i].fwd + layers[i].grad for i in st) for st in self.bwd_stages]
        return f, b


def _greedy_pack(costs: Sequence[float], mems: Sequence[int], t_max: float,
                 mem_cap: float) -> list[tuple[int, int]] | None:
    """Pack items 0..L-1 into minimal contiguous bins with sum cost <= t_max
    and sum mem <= mem_cap.  Returns [(start, end_exclusive)] or None."""
    bins = []
    i, n = 0, len(costs)
    while i < n:
        c = m = 0.0
        j = i
        while j < n and c + costs[j] <= t_max + 1e-12 and m + mems[j] <= mem_cap:
            c += costs[j]
            m += mems[j]
            j += 1
        if j == i:
            return None  # single item violates a cap
        bins.append((i, j))
        i = j
    return bins


def auto_partition(
    layers: Sequence[LayerCost],
    *,
    n_devices: int,
    n_microbatches: int,
    mem_cap_bytes: float = float("inf"),
    microbatch_act_multiplier: int = 1,
) -> Partition:
    """O(L^3) search over candidate t_max values (paper §4.4.2)."""
    n_layers = len(layers)
    if n_layers == 0:
        raise ValueError("no layers")
    f = [l.fwd for l in layers]
    b = [l.fwd + l.grad for l in layers]
    wmem = [l.weight_bytes + microbatch_act_multiplier * l.act_bytes for l in layers]

    # Candidate t_max: every contiguous subsequence sum of f and of b.
    cands: set[float] = set()
    for arr in (f, b):
        for i in range(n_layers):
            acc = 0.0
            for j in range(i, n_layers):
                acc += arr[j]
                cands.add(acc)
    best: Partition | None = None
    nn = n_devices * (n_devices - 1)
    # Any feasible t_max must hold every single backward item — the backward
    # partition covers ALL layers, so t < max(b) can never pack (the old
    # and-guard wrongly kept such t alive when t >= max(f)).  This single
    # test subsumes the forward bound: b = f + grad >= f elementwise, and
    # the forward partition only packs the non-fused prefix anyway.
    max_b = max(b)
    for t in sorted(cands):
        if t < max_b:
            continue
        # Backward partition: pack from the deepest layer down so the FIRST
        # backward stage (fused) is maximal.  Reverse arrays, pack, un-reverse.
        bins_rev = _greedy_pack(b[::-1], wmem[::-1], t, mem_cap_bytes)
        if bins_rev is None:
            continue
        bwd_stages = []
        for s, e in bins_rev:
            ids = tuple(range(n_layers - e, n_layers - s))
            bwd_stages.append(ids)
        fused = bwd_stages[0]
        n_fused = len(fused)
        # Forward partition covers layers [0, L - n_fused)
        fcosts = f[: n_layers - n_fused]
        fmems = wmem[: n_layers - n_fused]
        if fcosts:
            fbins = _greedy_pack(fcosts, fmems, t, mem_cap_bytes)
            if fbins is None:
                continue
            fwd_stages = tuple(tuple(range(s, e)) for s, e in fbins)
        else:
            fwd_stages = ()
        s_total = len(fwd_stages) + len(bwd_stages)
        obj = (n_microbatches * s_total + nn) * t
        if best is None or obj < best.objective - 1e-12:
            best = Partition(fwd_stages, tuple(bwd_stages), t, obj, s_total)
    if best is None:
        raise ValueError("no feasible partition under the memory cap")
    return best


def symmetric_partition(layers: Sequence[LayerCost], n_stages: int,
                        *, by: str = "total") -> list[tuple[int, int]]:
    """Classic symmetric split: contiguous stages minimising the max stage
    cost (what GPipe/1F1B/looped schedules use).  ``by``: 'fwd' | 'total'.
    Returns [(start, end_exclusive)] of length <= n_stages (padded with empty
    stages disallowed — raises if n_stages > n_layers)."""
    if n_stages > len(layers):
        raise ValueError("more stages than layers")
    cost = [(l.fwd if by == "fwd" else l.fwd * 2 + l.grad) for l in layers]
    lo, hi = max(cost), sum(cost)
    best = None
    for _ in range(60):                       # binary search on t_max
        mid = (lo + hi) / 2
        bins = _greedy_pack(cost, [0] * len(cost), mid, float("inf"))
        if bins is not None and len(bins) <= n_stages:
            best, hi = bins, mid
        else:
            lo = mid
    if best is None:
        best = [(i, i + 1) for i in range(len(cost))]
    # split large bins until we have exactly n_stages (cosmetic balance)
    while len(best) < n_stages:
        i = max(range(len(best)), key=lambda j: sum(cost[best[j][0]:best[j][1]])
                if best[j][1] - best[j][0] > 1 else -1)
        s, e = best[i]
        if e - s == 1:
            break
        m = (s + e) // 2
        best[i:i + 1] = [(s, m), (m, e)]
    return best


def uniform_costs_from_config(n_layers: int, *, head_fwd_ratio: float = 0.0,
                              fwd: float = 1.0, grad_ratio: float = 2.0) -> list[LayerCost]:
    """Convenience: L body layers of cost ``fwd`` plus, if ``head_fwd_ratio``,
    a final LM-head pseudo-layer costing ``head_fwd_ratio * fwd``."""
    out = [LayerCost(fwd, fwd * grad_ratio) for _ in range(n_layers)]
    if head_fwd_ratio:
        out.append(LayerCost(fwd * head_fwd_ratio, fwd * head_fwd_ratio * grad_ratio))
    return out
