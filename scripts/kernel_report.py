#!/usr/bin/env python3
"""What the compiler made of the port's CUDA kernels, and flash-decode's
device time over split sizes.

Run from the repository root on a machine with the CUDA toolkit and a card:

    python3 scripts/kernel_report.py [NAME ...] [--dump DIR] [--sweep] [--train] [--scans]
        [--attention] [--serve]

For each library NAME of ``repro_torch.kernels._build.KERNELS`` (default:
``decode_attention flash_attention``) it builds the library afresh, prints
ptxas's register, shared-memory and spill report for each of its kernels and
the counts of the SASS opcodes that say how it moves data and multiplies:
``LDG``/``LDGSTS``/``UTMALDG`` (global loads: plain, ``cp.async``, TMA),
``LDL``/``STL`` (local memory: spills), ``HMMA``/``HGMMA`` (``mma.sync``,
``wgmma``), ``FFMA`` (fp32 multiply-adds), ``SHFL``, ``MUFU`` (exponentials),
``BAR``/``SYNCS`` (barriers), ``STS``/``STG`` (shared and global stores).
``--dump DIR`` writes each library's whole ``cuobjdump -sass`` listing to
``DIR/NAME.sass``. ``--sweep`` times flash-decode's split pass (summed kernel
durations in a ``torch.profiler`` trace) at the decode shapes of qwen3-1.7b
(B=4, 1056 slots, H=16, KH=8, D=128) and hymba-1.5b (B=4, ring of 1024,
H=25, KH=5, D=64) over split sizes of 32-256 slots and over n_valid. ``--train`` times
the two training kernels and their library yardsticks at one ring worker's
training shapes of qwen3-1.7b by device time (a replayed CUDA graph, calls
queued behind a sleep kernel and the summed kernel durations of a
``torch.profiler`` trace): the flash backward
(B=2, S=1024, H=16, KH=8, D=128, causal, bf16) beside SDPA's backward, and
the fused cross-entropy forward (T=2048, D=2048, V=151936, tied head, bf16)
beside ``F.cross_entropy(x @ W^T, reduction="none")``. ``--scans`` times the
two scans the same ways at the prefill and decode shapes of ``chip_smoke.py``:
``rwkv_scan`` at rwkv6-7b's (B=4, S=1024 or 1, H=64, N=64, fp32) and
``ssm_scan`` at hymba-1.5b's (B=4, S=1536 or 1, Di=3200, N=16, bf16 in, fp32
y), and their backwards at the training micro-batches (``rwkv_scan_bwd`` at
B=2, S=1024, H=64, N=64, fp32; ``ssm_scan_bwd`` at B=2, S=1536, Di=3200,
N=16, bf16 in, fp32 dy): run it from a ``git archive`` of another commit
(with this script copied into its ``scripts/``) and from this tree in one
call to compare two commits' scans. ``--sweep`` also times the wide flash backward at gemma-2b's and
nemotron-4-340b's training shapes with a group's query heads split over
each count of items that divides the group.
``--attention`` times the three attention kernels at their Dh <= 128
main-path shapes (qwen3-1.7b's prefill B=4, S=1024, H=16, KH=8, D=128; its
training backward at B=2; its decode over 1056 slots; hymba-1.5b's prefill
with its window and its decode over the ring), the wide forward and
flash-decode at gemma-2b's (H=8, KH=1, D=256) and stablelm-12b's (H=32, KH=8,
D=160) prefill (B=4, S=1024) and serving cache (1056 slots), the wide forward
at gemma-2b's heads over one 4096-token sequence, and the wide
backward at gemma-2b's training shape (B=2, S=1024, H=8, KH=1, D=256) and
nemotron-4-340b's (B=2, S=1024, H=96, KH=8, D=192), bf16, the same ways: run it
from a ``git archive`` of another commit (with this script copied into its
``scripts/``) and from this tree in one call to compare two commits' kernels
on one card; it also prints the wide forward's max abs error against the
plain version on keys that grow along S (row maxima rising tile after tile:
``chip_smoke.py``'s ``wide-rising-256-bf16`` and ``wide-rising-160-bf16``
shapes). ``--sweep`` also times the wide flash-decode's cluster sizes (1-16
blocks) at both serving caches, each beside its error against the plain
version. ``--serve`` runs ``chip_smoke.py``'s ``phase_wide_serve`` (full-width
gemma-2b and stablelm-12b served, batch 4, prompt 1024, 32 tokens) in this
process and prints the device memory held before it, its peak and its warm
prefill and decode times. Other checks against the plain versions are
``chip_smoke.py``'s.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OPS = ("LDG", "LDGSTS", "UTMALDG", "LDS", "LDSM", "STS", "STG", "LDL", "STL", "HMMA", "HGMMA",
       "FFMA", "SHFL", "MUFU", "BAR", "SYNCS")


def report(names, dump):
    from repro_torch.kernels import _build
    for name in names:
        if _build.library_path(name).exists():
            _build.library_path(name).unlink()   # rebuild, so ptxas prints its report
    logs = _build.build(tuple(names))             # all at once; raises with every failure
    for name in names:
        for line in logs.get(name, "").splitlines():
            if any(w in line for w in ("Compiling entry", "registers", "spill", "arning")):
                print(f"  ptxas {name}: {line.strip()}")
        text = _build.sass(name)
        if dump:
            Path(dump).mkdir(parents=True, exist_ok=True)
            (Path(dump) / f"{name}.sass").write_text(text)
        for fn, counts in _build.sass_opcodes(text).items():
            picked = {op: counts.get(op, 0) for op in OPS}
            print(f"  sass {name}: {fn[:90]} total {sum(counts.values())} "
                  + json.dumps(picked))


def sweep_chunks():
    """Flash-decode's device time at the Dh <= 128 decode shapes over split
    sizes and over n_valid (the plan's split size)."""
    import torch
    from chip_smoke import _kernel_ms
    from repro_torch.kernels import decode_attention as mod
    gen = torch.Generator(device="cuda").manual_seed(0)
    plan = mod.decode_plan
    out = {}
    for label, b, s, h, kh, d in (("qwen", 4, 1056, 16, 8, 128), ("hymba", 4, 1024, 25, 5, 64)):
        nv = torch.full((b,), s, dtype=torch.int32, device="cuda")
        sets = [tuple(torch.randn(shape, generator=gen, device="cuda").to(torch.bfloat16)
                      for shape in ((b, h, d), (b, s, kh, d), (b, s, kh, d))) for _ in range(8)]
        for chunk in (32, 64, 128, 192, 256):
            mod.decode_plan = lambda s_, b_, kh_, sms_, c=chunk: (-(-s_ // c), c)
            out[f"{label}_chunk{chunk}"] = _kernel_ms(
                lambda q, k, v: mod.decode_attention(q, k, v, nv), sets, 10)
        mod.decode_plan = plan
        for n in (1, s // 4, s // 2, s):
            nv_n = torch.full((b,), n, dtype=torch.int32, device="cuda")
            out[f"{label}_nvalid{n}"] = _kernel_ms(
                lambda q, k, v: mod.decode_attention(q, k, v, nv_n), sets, 10)
    print("decode chunk sweep " + json.dumps(out))


def _device_times(fn, sets):
    """ms per call of ``fn`` over ``sets``: by events, by a replayed CUDA
    graph, queued behind a sleep kernel and by the trace's per-kernel sums (a
    way that fails is reported as not measured, with its error)."""
    import chip_smoke as cs
    out = {}
    for key, timer, reps in (("events_ms", cs._time_ms, 10), ("graph_ms", cs._graph_ms, 5),
                             ("queued_ms", cs._queued_ms, 10), ("trace_ms", cs._kernel_ms, 5)):
        try:
            out[key] = timer(fn, sets, reps)
        except RuntimeError as e:   # a failed capture or an overlong enqueue
            out[key] = f"not measured: {str(e)[:200]}"
    return out


def train_yardsticks():
    """Device ms per call of the flash backward and the fused cross-entropy
    forward, and of one PyTorch call computing the same function each, at
    one ring worker's training shapes (``chip_smoke.py``'s inputs)."""
    import torch
    import torch.nn.functional as F
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.fused_xent import fused_xent
    gen = torch.Generator(device="cuda").manual_seed(6)
    bf16 = torch.bfloat16
    out = {}
    sets, lib = [], []
    for _ in range(4):
        q, k, v = cs._flash_inputs(2, 1024, 16, 8, 128, 128, bf16, "bshd", gen)
        o, lse = flash_attention(q, k, v, return_lse=True)
        do = cs._rand(o.shape, bf16, gen)
        sets.append((q, k, v, o, lse, do))
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        lib.append((ot, (qt, kt, vt), do.transpose(1, 2).contiguous()))
    sdpa_bwd = lambda ot, leaves, dot: torch.autograd.grad(ot, leaves, dot,  # noqa: E731
                                                           retain_graph=True)
    out["flash_bwd"] = _device_times(flash_attention_bwd, sets)
    out["sdpa_bwd"] = _device_times(sdpa_bwd, lib)
    del sets, lib
    x, w, labels = cs._xent_inputs(2048, 2048, 151936, bf16, "tied", 4, gen)
    sets = [(x, w, labels)]
    xent = lambda a, b, c: fused_xent(a, b, c)   # noqa: E731
    lib_xent = lambda a, b, c: F.cross_entropy(a @ b, c, reduction="none")   # noqa: E731
    for name, fn in (("fused_xent", xent), ("cross_entropy", lib_xent)):
        out[name] = _device_times(fn, sets)
    print("train yardsticks " + json.dumps(out))


def scan_times():
    """Device ms per call of the two scans at the main path's prefill and
    decode shapes, and of their backwards at the training micro-batches
    (``chip_smoke.SCAN_BWD_TRAIN``, as ``phase_scan_bwd_timings`` calls them:
    rwkv6-7b fp32 with dS_T absent, hymba-1.5b bf16 with an fp32 dy)
    (``chip_smoke.py``'s inputs, cold sets)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.rwkv_scan import rwkv_scan, rwkv_scan_bwd
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd
    gen = torch.Generator(device="cuda").manual_seed(14)
    out = {}
    with torch.no_grad():
        for kind, s in (("prefill", cs.RWKV_PROMPT), ("decode", 1)):
            sets = [cs._rwkv_inputs(cs.BATCH, s, 64, 64, torch.float32, "model", "random",
                                    "dense", gen) for _ in range(4)]
            out[f"rwkv_scan_{kind}"] = _device_times(rwkv_scan, sets)
        for kind, s in (("prefill", cs.HYBRID_PROMPT), ("decode", 1)):
            sets = [cs._ssm_inputs(cs.BATCH, s, 3200, 16, torch.bfloat16, "random", "dense",
                                   gen) for _ in range(4)]
            out[f"ssm_scan_{kind}"] = _device_times(
                lambda *a: ssm_scan(*a, out_dtype=torch.float32), sets)
    b, s, h, n = cs.SCAN_BWD_TRAIN["rwkv"]
    sets = [(*args, dy, None) for args, dy, _ in
            (cs._rwkv_bwd_inputs(b, s, h, n, torch.float32, "model", "zeros", "dense", gen)
             for _ in range(3))]
    out["rwkv_scan_bwd_train"] = _device_times(rwkv_scan_bwd, sets)
    del sets
    b, s, di, n = cs.SCAN_BWD_TRAIN["ssm"]
    sets = [(*args, dy, None) for args, dy, _ in
            (cs._ssm_bwd_inputs(b, s, di, n, torch.bfloat16, "zeros", "random", "dense", gen)
             for _ in range(3))]
    out["ssm_scan_bwd_train"] = _device_times(ssm_scan_bwd, sets)
    print("scan times " + json.dumps(out))


# the wide instances of the flash backward: d_head 256 at gemma-2b's training
# shape (one ring worker, MQA) and 192 at nemotron-4-340b's (group 12)
WIDE_BWD_SHAPES = (("gemma", 2, 1024, 8, 1, 256), ("nemotron", 2, 1024, 96, 8, 192))


def _bwd_sets(b, s, h, kh, d, gen, n=4):
    """``n`` cold input sets of the flash backward, bf16 (``chip_smoke.py``'s
    inputs and the forward's own output and log-sum-exp)."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels.flash_attention import flash_attention
    sets = []
    for _ in range(n):
        q, k, v = cs._flash_inputs(b, s, h, kh, d, d, torch.bfloat16, "bshd", gen)
        o, lse = flash_attention(q, k, v, return_lse=True)
        sets.append((q, k, v, o, lse, cs._rand(o.shape, torch.bfloat16, gen)))
    return sets


def sweep_bwd_splits():
    """The wide flash backward's device time at ``WIDE_BWD_SHAPES`` over the
    number of items a group's query heads are split into (gemma-2b's group
    of 8 into 1, 2, 4 and 8; nemotron-4-340b's of 12 into 1, 2, 3, 4, 6 and
    12; ``bwd_plan``'s choice printed beside), by a replayed CUDA graph and
    by the trace's per-kernel sums."""
    import chip_smoke as cs
    import torch
    from repro_torch.kernels import flash_attention as mod
    gen = torch.Generator(device="cuda").manual_seed(7)
    plan = mod.bwd_plan
    out = {}
    for label, b, s, h, kh, d in WIDE_BWD_SHAPES:
        sets = _bwd_sets(b, s, h, kh, d, gen)
        group = h // kh
        out[f"{label}_plan"] = plan(b, s, h, kh, d, d, mod._sm_count(0))._asdict()
        for splits in (n for n in range(1, group + 1) if group % n == 0):
            mod.bwd_plan = lambda *a, n=splits: mod.BwdPlan(64, n, group // n)
            out[f"{label}_splits{splits}"] = {
                "graph_ms": cs._graph_ms(mod.flash_attention_bwd, sets, 5),
                "trace_ms": cs._kernel_ms(mod.flash_attention_bwd, sets, 5)}
        mod.bwd_plan = plan
        del sets
    print("flash backward split sweep " + json.dumps(out))


# the wide forward and flash-decode: gemma-2b's (d_head 256, MQA) and
# stablelm-12b's (d_head 160, padded to 192) prefill and serving cache; and
# gemma-2b's heads over one 4096-token sequence (four times the operations of
# B=4, S=1024 over as many query tiles, each four times as long: what a call
# costs beyond its tiles' work shows as the difference)
WIDE_FWD_SHAPES = (("gemma", 4, 1024, 8, 1, 256), ("stablelm", 4, 1024, 32, 8, 160))
WIDE_LONG_SHAPE = ("gemma_s4096", 1, 4096, 8, 1, 256)
WIDE_CACHE = 1056
# keys 1x to 4x as long along S, causal (chip_smoke.py's "rising" cases)
WIDE_RISING_SHAPES = (("gemma_rising", 2, 1024, 8, 1, 256),
                      ("stablelm_rising", 1, 1024, 32, 8, 160))


def _wide_decode_sets(b, s, h, kh, d, gen, n=8):
    import torch
    import chip_smoke as cs
    return [cs._decode_inputs(b, s, h, kh, d, d, torch.bfloat16, "dense", gen) for _ in range(n)]


def sweep_wide():
    """The wide flash-decode's device time (a replayed CUDA graph) and error
    against the plain version over cluster sizes at the serving caches of
    ``WIDE_FWD_SHAPES``."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import decode_attention as dmod
    from repro_torch.kernels import flash_attention as mod
    from repro_torch.kernels import ref
    gen = torch.Generator(device="cuda").manual_seed(8)
    out = {}
    plan = dmod.decode_wide_plan
    for label, b, _, h, kh, d in WIDE_FWD_SHAPES:
        dp = mod.padded_head_dim(d, d)
        nv = torch.full((b,), WIDE_CACHE, dtype=torch.int32, device="cuda")
        sets = _wide_decode_sets(b, WIDE_CACHE, h, kh, d, gen)
        want = ref.decode_attention_ref(*sets[0], nv).float()
        kern = lambda q, k, v, n=nv: dmod.decode_attention(q, k, v, n)   # noqa: E731
        out[f"decode_{label}_plan"] = plan(WIDE_CACHE, b, kh, dp, dmod._sm_count(0))._asdict()
        for c in (1, 2, 4, 8, 16):
            chunk = dmod._groups16(-(-WIDE_CACHE // c))
            rows, stages = dmod.wide_ring(dp)
            forced = (dmod.WidePlan(c, chunk, chunk, 1) if chunk <= dmod.WIDE_ROUND_MAX else
                      dmod.WidePlan(c, chunk, rows, min(-(-chunk // rows), stages)))
            dmod.decode_wide_plan = lambda *a, f=forced: f
            try:
                got = kern(*sets[0]).float()
                out[f"decode_{label}_cluster{c}"] = {
                    "plan": forced._asdict(), "graph_ms": cs._graph_ms(kern, sets, 20),
                    "max_abs_err": (got - want).abs().max().item()}
            except RuntimeError as e:   # a cluster the card cannot place
                out[f"decode_{label}_cluster{c}"] = f"not measured: {str(e)[:200]}"
            dmod.decode_wide_plan = plan
        del sets
    print("wide sweep " + json.dumps(out))


def attention_times():
    """Device ms per call of the flash forward, the flash backward and
    flash-decode at the Dh <= 128 shapes of the main path, of the wide
    forward and flash-decode (``WIDE_FWD_SHAPES``) and of the wide backward
    instances (``WIDE_BWD_SHAPES``) (``chip_smoke.py``'s inputs, cold
    sets); then the wide forward's max abs error against the plain version
    at ``WIDE_RISING_SHAPES``."""
    import torch
    import chip_smoke as cs
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    gen = torch.Generator(device="cuda").manual_seed(3)
    bf16 = torch.bfloat16
    out = {}
    for label, b, s, h, kh, d, window in (("qwen", 4, 1024, 16, 8, 128, None),
                                          ("hymba", 4, 1536, 25, 5, 64, 1024)):
        sets = [cs._flash_inputs(b, s, h, kh, d, d, bf16, "bshd", gen) for _ in range(4)]
        out[f"flash_{label}"] = _device_times(
            lambda q, k, v, w=window: flash_attention(q, k, v, causal=True, sliding_window=w),
            sets)
    sets = []
    for _ in range(4):
        q, k, v = cs._flash_inputs(2, 1024, 16, 8, 128, 128, bf16, "bshd", gen)
        o, lse = flash_attention(q, k, v, return_lse=True)
        sets.append((q, k, v, o, lse, cs._rand(o.shape, bf16, gen)))
    out["flash_bwd_qwen"] = _device_times(flash_attention_bwd, sets)
    del sets
    for label, b, s, h, kh, d in WIDE_BWD_SHAPES:
        out[f"flash_bwd_{label}"] = _device_times(flash_attention_bwd,
                                                  _bwd_sets(b, s, h, kh, d, gen))
    for label, b, s, h, kh, d in WIDE_FWD_SHAPES + (WIDE_LONG_SHAPE,):
        sets = [cs._flash_inputs(b, s, h, kh, d, d, bf16, "bshd", gen) for _ in range(4)]
        out[f"flash_{label}"] = _device_times(
            lambda q, k, v: flash_attention(q, k, v, causal=True), sets)
        if label == WIDE_LONG_SHAPE[0]:
            continue
        nv = torch.full((b,), WIDE_CACHE, dtype=torch.int32, device="cuda")
        out[f"decode_{label}"] = _device_times(
            lambda q, k, v, n=nv: decode_attention(q, k, v, n),
            _wide_decode_sets(b, WIDE_CACHE, h, kh, d, gen))
    for label, b, s, h, kh, d in (("qwen", 4, 1056, 16, 8, 128), ("hymba", 4, 1024, 25, 5, 64)):
        nv = torch.full((b,), s, dtype=torch.int32, device="cuda")
        sets = [cs._decode_inputs(b, s, h, kh, d, d, bf16, "dense", gen) for _ in range(8)]
        out[f"decode_{label}"] = _device_times(
            lambda q, k, v, n=nv: decode_attention(q, k, v, n), sets)
    print("attention times " + json.dumps(out))
    gen = torch.Generator(device="cuda").manual_seed(23)
    errs = {}
    for label, b, s, h, kh, d in WIDE_RISING_SHAPES:
        q, k, v = cs._flash_inputs(b, s, h, kh, d, d, bf16, "bshd", gen)
        ramp = 1 + 3 * torch.arange(s, device="cuda", dtype=torch.float32) / s
        k = (k.float() * ramp[None, :, None, None]).to(bf16)
        got = flash_attention(q, k, v, causal=True).float()
        want = ref.flash_attention_ref(q, k, v, causal=True).float()
        errs[f"flash_{label}"] = (got - want).abs().max().item()
    print("wide forward max abs err on rising keys " + json.dumps(errs))


def serve_report():
    """``chip_smoke.phase_wide_serve`` for each wide serving arch, alone in
    this process: the device memory held before it, its peak and its warm
    times."""
    import torch
    import chip_smoke as cs
    out = {}
    for arch in cs.WIDE_SERVE_ARCHS:
        torch.cuda.empty_cache()
        before = torch.cuda.memory_allocated() / 1e9
        run = cs.phase_wide_serve(arch)
        out[arch] = {"held_before_gb": before, "peak_memory_gb": run["peak_memory_gb"],
                     "warm": run["warm"]}
    print("serve report " + json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=["decode_attention", "flash_attention"])
    ap.add_argument("--dump", default=None)
    ap.add_argument("--sweep", action="store_true")
    ap.add_argument("--train", action="store_true")
    ap.add_argument("--scans", action="store_true")
    ap.add_argument("--attention", action="store_true")
    ap.add_argument("--serve", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    report(args.names, args.dump)
    if args.sweep or args.train or args.scans or args.attention or args.serve:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
    if args.sweep:
        sweep_chunks()
        sweep_bwd_splits()
        sweep_wide()
    if args.train:
        train_yardsticks()
    if args.scans:
        scan_times()
    if args.attention:
        attention_times()
    if args.serve:
        serve_report()
    return 0


if __name__ == "__main__":
    sys.exit(main())
