#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero at once:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every kernel from ``src/repro_torch/kernels/csrc`` (nine
     libraries: flash attention forward and backward, flash-decode, fused
     LM-head cross-entropy, dequant-on-upload, the RWKV6 scan and the Mamba
     selective scan, each scan's backward); print ptxas's register and spill report and each
     library's SASS opcode counts (``cuobjdump -sass``) and the flash
     backward's and the cross-entropy's spills, and fail unless the flash
     forward, the flash backward and the fused cross-entropy issue wgmma
     (HGMMA) and TMA loads (UTMALDG), and flash-decode, ``rwkv_scan`` and
     ``ssm_scan`` 16-byte asynchronous copies (LDGSTS) with no spills;
  3. hold each kernel against its plain PyTorch version on the card: the
     serving kernels at the serving shapes of qwen3-1.7b and hymba-1.5b
     (flash at group 5, d_head 64, window 1024; flash-decode over its full
     and a partly filled ring of 1024 slots) and over an edge sweep (for
     flash-decode also the edges of its splits: S one past a whole number of
     splits, n_valid on a split edge and one past it, 0 and past S, at
     groups 4, 5 and 16), and at head dims above 128 in fp32 and bf16
     (gemma-2b's 256 under MQA, stablelm-12b's 160, nemotron-4-340b's 192
     with a group of 12, MLA's Dh 192 with Dv 128; ragged S, a window,
     strided and padded layouts; the flash backward too, also where its
     plan splits a group's query heads over blocks, unevenly and under a
     window, and where it keeps groups of 12 and 4 whole, after a line of
     its plans), at the
     tolerances of ``tests/test_kernels.py`` (fp32 2e-5, bf16 2e-2); the
     training kernels at the training shapes and over an edge sweep, the
     flash backward against ``ref.flash_attention_bwd_ref`` and against
     autograd of ``ref.flash_attention_ref``, the cross-entropy forward
     against ``ref.fused_xent_ref`` and the entry's gradients against its
     autograd (forwards fp32 2e-5 / bf16 2e-2, backwards fp32 1e-4 / bf16
     2e-2 on the relative norm); ``dequant_rows`` bit-exact (atol 0) against
     ``ref.dequant_rows_ref`` for int8 and int4 codes, fp32 and bf16 output,
     at the training shape (the largest slot's rows of a 50,335,744-element
     layer row), one row of one block, ragged row and block counts, all-zero
     blocks, every code value and the codes of random weights;
     ``rwkv_scan`` and ``ssm_scan`` against ``ref.rwkv_scan_ref`` and
     ``ref.ssm_scan_ref`` (y and the final state; fp32 1e-4 and bf16 2e-2,
     relative plus the same share of the largest value) at the prefill and
     decode shapes of rwkv6-7b and hymba-1.5b and over a ragged sweep (head
     and state sizes 7 to 64, sequences off the chunk sizes, d_inner 3200
     and small ragged ones, the model's decays and sigmoid ones, random
     initial states, misaligned inputs) and the edges of the kernels'
     tiling (N in {1, 4, 17, 33, 64} at S = 1, a chunk - 1, a chunk + 1 and
     two chunks + 7, in fp32 and bf16; a single (batch, head) pair; d_inner
     1, 31, 3201 and 32); ``rwkv_scan_bwd`` and ``ssm_scan_bwd`` against
     their plain backwards (``ref.*_bwd_ref``) and against autograd of the
     plain forwards, every gradient on the relative norm (fp32 1e-4, bf16
     2e-2), at the training micro-batches of rwkv6-7b (B=2, S=1024, H=64,
     N=64; fp32 and bf16) and hymba-1.5b (B=2, S=1536, Di=3200, N=16; bf16
     with fp32 dy, and fp32) and over the forwards' edge sweep at the
     backward's chunk of 32 (N in {1, 4, 17, 33, 64} at S = 1, 31, 33, 71;
     d_inner 1, 31, 3201, 32; decays near 0 and 1; random initial states and
     state gradients; misaligned inputs; one (batch, head));
  4. serve full-width qwen3-1.7b (bf16, random weights from a seeded
     ``torch.Generator`` on the card; batch 4, prompt 1024, 32 greedy tokens)
     through ``repro_torch.launch.serve.main`` with the kernels' launch counts
     set to 0 just before and read just after; check the counts, that the
     logits are finite, and that a decode step's logits match a prefill of the
     same prefix one token longer (bf16 and, at two layers, fp32);
  5. time the serving steps, and the serving kernels beside their plain
     versions, their bounds and ``scaled_dot_product_attention`` (a
     yardstick only: the port never calls it), by CUDA events over
     back-to-back calls and by device time (a replayed CUDA graph of the
     calls; for flash-decode and SDPA also each kernel's summed duration in a
     profiler trace); then serve full-width
     rwkv6-7b (prompt 1024) and hymba-1.5b (prompt 1536, past its window of
     1024) the same way, batch 4 and 32 greedy tokens, each with the counts
     set to 0 just before and read just after (rwkv6-7b: 1056 ``rwkv_scan``
     launches and no attention; hymba-1.5b: 32 flash, 1024 flash-decode and
     1056 ``ssm_scan``), finite logits, decode against a one-longer prefill
     (bf16 on the relative norm at a fixed bar, 3e-2 rwkv6-7b and 6e-2
     hymba-1.5b, which a lost recurrent state must exceed; fp32 1e-4 at full
     width and 2 layers, across hymba's ring wrap, which each faulted
     control must break: the state lost, the state rounded through bf16,
     hymba's ring out of phase), prefill and decode times, peak memory and a
     traced decode step; each scan's time at its prefill and decode shapes
     beside its bound and its plain version, by events and, at prefill, by
     device time (a replayed CUDA graph); and flash and flash-decode at
     hymba's shapes beside theirs. Between the two: train the recurrent
     families through the launcher (``--mesh 1x4 --partition auto --batch
     8``): hymba-1.5b at full depth (32 layers, ``--seq 1536``) and rwkv6-7b
     at 8 of its 32 layers (``--seq 1024``), the counts of every training
     kernel (both scans' forward and backward, flash for hymba, the
     cross-entropy) set to 0 just before and held against the plan just
     after, finite losses, then 3 steps of a fresh state on a repeated batch
     (falling losses, a traced step), and each family's fp32 ring against
     its single program at 4 (hymba) and 2 (rwkv) layers (loss rtol 1e-4,
     worst relative 5e-3); and after the scans' rows, each backward at its
     training micro-batch by events and graph replay beside its bound and
     its plain backward;
  6. train full-width qwen3-1.7b through ``repro_torch.launch.train`` (bf16
     weights, fp32 master, ``--mesh 1x4 --partition auto --batch 8 --seq
     1024 --steps 3``) with the counts set to 0 just before and read just
     after; check the counts against the plan, that every loss is finite,
     that the loss falls over 3 steps on one repeated batch (a fresh state,
     learning rate 1e-5), and that the
     ring's grads (kernels) match the single program's (plain versions) at
     full width, 2 layers, fp32 (loss rtol 1e-4, worst relative 5e-3) and
     bf16 (loss and every leaf within 2e-2 on the relative norm);
  7. time the training step (host clock, peak memory, a ``torch.profiler``
     trace with the device time of each slot kind and of each training
     kernel), and the training kernels beside their plain versions, their
     bounds and a library yardstick (SDPA's backward; ``F.cross_entropy(x @
     W^T)``), by events and by device time (a replayed CUDA graph of the
     calls, and calls queued behind a sleep kernel, which times SDPA's
     backward, a call no graph can capture);
  8. at full width and 8 layers: the standby prefetch with every row split
     into chunks gives grads bit-identical to whole-block injection (dense and
     int8 pool, 2 rounds), and one round through the prefetch path is
     bit-identical to the one-round whole-block path; then train full width
     through the launcher with ``--microbatches 8`` (2 rounds, prefetch on):
     dense, ``--pool-dtype int8 --grad-compress int8`` and ``--pool-dtype int4
     --grad-compress int8``, each with the counts set to 0 just before and read
     just after and checked against the plan (dequant: one launch per promote
     of a slot with layers), finite losses, step ms, peak memory, a traced
     step and the quantize pass's device time; then the dequant kernel's time
     at the training shape beside its bound and its plain version;
  9. fine-tune frozen-base LoRA adapters (rank 8) at full width through the
     launcher: ``--lora-rank 8`` (one round) and ``--lora-rank 8
     --microbatches 8 --pool-dtype int4 --grad-compress int8``, each with the
     counts set to 0 just before and read just after and checked against the
     plan, finite losses, the base (layers, embedding, final norm)
     bit-identical to its seeded initial weights after the steps, every
     adapter B moved, step ms, peak memory and a traced step (printed beside
     the dense one-round step's); then the LoRA ring against the single
     program on the merged weights at full width, 2 layers, adapters away
     from B = 0 (fp32: loss rtol 1e-4, worst relative 5e-3; bf16: loss and
     the whole adapter gradient within 2e-2 on the relative norm, and each
     leaf no farther from the fp32 single program than 1.25x the bf16 single
     program is);
 10. the chained staleness-1 optimizer, the host-resident optimizer and
     checkpoint restarts, at full width: the launcher with ``--async-opt
     --async-steps 4 --steps 4`` (one chain) at 28 layers, dense and
     ``--lora-rank 8``,
     and ``--async-steps 2 --steps 4 --microbatches 8 --pool-dtype int8
     --grad-compress int8``, each with the counts set to 0 just before and
     read just after and checked against the plan, the quantize passes
     counted, falling finite losses, step ms, peak memory and a traced
     chained call (device time per slot kind, in the ``D_k`` updates and
     outside any range; its I*R*S + N - 1 ticks), beside the synchronous
     step's trace of phase 7; the chained ring against the serial
     ``reference_staleness1`` oracle on the single program (kernels) at 2
     layers, fp32 (loss rtol 1e-4, worst relative weight error 5e-3,
     separation from staleness-0) and bf16 (2e-2 on the relative norm, and
     no farther from fp32 than 1.25x the bf16 oracle); ``HostAsyncRoundPipe``
     at 2 layers, 2 steps, with the optimizer on the CPU (peak device memory, pinned
     host bytes, step, device and optimizer seconds, the optimizer's hidden
     share),
     within 5e-3 of the serial oracle and bit-identical to it at 2 layers on
     32-token sequences of tokens that occur once; and, at 2 layers on such
     sequences, runs resumed from ``--ckpt-dir`` bit-identical to
     uninterrupted ones (synchronous and chained), an off-boundary
     checkpoint refused under ``--async-opt``, and the checkpoint's bytes and
     save and load seconds;
 11. the goodput supervisor (``runtime.Supervisor``) at full width, 7
     layers: the reference's chaos scenario (``run_chaos``; fp32, 12 x
     1024 tokens a step, asynchronous checkpoints after steps 3 and 7):
     worker 2 reports 5x-slow steps from step 2, so the ring rotates to g0 =
     3, and worker 1 dies at step 5, so the ring is re-planned for 3 workers
     and resumes from the step-3 checkpoint re-padded to 9 pool rows; the
     counts set to 0 just before and read just after, held against each
     ring's plan; the events, the replayed step-4 loss (rtol 1e-4), the
     goodput ledger and the final weights against an uninterrupted 4-worker
     run (5e-3 worst relative); the launcher with ``--elastic --ckpt-dir``,
     without and with ``--async-ckpt`` (bf16, 1 step and its checkpoint),
     launches against the plan and both ledgers (checkpoint seconds the
     step paid, the writer's snapshot and background-write seconds); and a
     one-round step at 28 layers traced at g0 = 0 and g0 = 1 in turns, with
     the plan's launches at both;
 12. the dense configs with head dims above 128, at full width: serve
     gemma-2b (18 layers, d_head 256, MQA) and stablelm-12b (40 layers,
     d_head 160) as qwen3-1.7b is served (launches, finite logits, decode
     against prefill in bf16 and at 2 layers in fp32; warm prefill and
     decode steps, peak memory); train gemma-2b one round through the
     launcher (launches against the plan, finite losses, peak memory) and 3
     steps of a fresh state on a repeated batch (falling losses, a traced
     step by slot kind); gemma-2b's ring against its single program at 2
     layers, fp32 (loss rtol 1e-4, worst relative 5e-3); and the d_head-256
     kernels at gemma-2b's shapes beside their bounds, their plain versions
     and SDPA (rows ``<kernel>@gemma-2b`` of the ``kernels`` line, launches
     of the gemma-2b runs);
 13. the embeds front end and the MoE family, at full width: serve
     internvl2-76b at 8 of its 80 layers from ``BATCH`` x ``PROMPT`` random
     bf16 embeds through ``serve.main`` (launches, finite logits, every
     decode step against a teacher-forced prefill over the prompt's embeds
     and the generated tokens' embedding rows, bf16 2e-2 on the relative
     norm, and at 2 layers in fp32 with a first step from (B,1,D) embeds,
     elementwise 1e-4; warm prefill and decode, peak memory); train
     hubert-xlarge at full depth (48 layers, bidirectional heads of 80, a
     504-unit head) through ``dispatch.build_roundpipe_train_step`` on bf16
     embeds batches (the launcher refuses a front-end arch): 3 steps with
     launches against the plan, a fresh state on a repeated batch with a
     traced step (falling losses), the fp32 ring against the single program
     at 4 layers with the embedding's gradient zero in both; serve
     gpt-oss-20b at full depth (launches, finite logits, warm timings, a
     traced prefill and decode step; decode against a teacher-forced
     prefill at 2 layers with the capacity factor E/k, where no assignment
     drops: bf16 2e-2, fp32 1e-4); LoRA-train gpt-oss-20b at 8 layers over
     its attention through the launcher (launches against the plan, the
     base bit-identical, every B moved, falling losses on a repeated batch
     with a traced step that reads the untied head's dense copy), and its
     fp32 LoRA ring against the merged single program at 2 layers and the
     capacity factor E/k; then the instances these paths run first beside
     their bounds, their plain versions and a PyTorch call (rows
     ``<kernel>@<arch>``: the bidirectional 80-dim forward and backward and
     the 504-unit xent at hubert-xlarge's training shapes, flash-decode at
     internvl2-76b's and gpt-oss-20b's group-8 caches); the kernel cases
     of phase 3 hold these shapes too (hubert's also at S = 777);
 14. print the card's line, the ``kernels`` JSON line, then the result line.
It exits non-zero without a result when no card is present.
"""
from __future__ import annotations

import bisect
import concurrent.futures
import contextlib
import dataclasses
import gc
import json
import math
import re
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "qwen3-1.7b"
WIDE_ARCH = "gemma-2b"                       # d_head 256: the wide kernels on the main path
WIDE_SERVE_ARCHS = ("gemma-2b", "stablelm-12b")   # d_head 256 and 160
WIDE_CASE_ARCHS = ("gemma-2b", "stablelm-12b", "nemotron-4-340b")   # 256, 160, 192
VISION_ARCH = "internvl2-76b"                # the embeds front end, served: group 8, D 128
AUDIO_ARCH = "hubert-xlarge"                 # the embeds front end, trained: bidirectional, D 80
MOE_ARCH = "gpt-oss-20b"                     # the MoE family: group 8, D 64, 32 experts top-4
FAMILY_ARCHS = (VISION_ARCH, AUDIO_ARCH, MOE_ARCH)
DEVICE = "cuda"
BATCH, PROMPT, GEN = 4, 1024, 32
TRAIN_WORKERS, TRAIN_BATCH, TRAIN_SEQ, TRAIN_STEPS = 4, 8, 1024, 3
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
BWD_TOL_F32 = dict(rtol=1e-4, atol=1e-4)   # tests/test_kernels.py:133-134
BWD_REL_BF16 = 2e-2                         # relative norm, as the serving bf16 checks
# H100 SXM peaks (NVIDIA data sheet, dense, at the 700 W limit).
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}


def _cast(tree, dtype):
    """A copy of a parameter tree (dicts and lists of tensors) in ``dtype``."""
    if isinstance(tree, dict):
        return {k: _cast(v, dtype) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_cast(v, dtype) for v in tree]
    return tree.to(dtype)


def check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(msg)


def dtype_name(dtype) -> str:
    return str(dtype).removeprefix("torch.")


# ---------------------------------------------------------------------------
# Phase 1 and 2
# ---------------------------------------------------------------------------

def phase_device():
    import torch
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    print(smi)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"device {torch.cuda.get_device_name(0)} count {torch.cuda.device_count()}")
    return smi


SASS_OPS = ("HGMMA", "HMMA", "UTMALDG", "LDGSTS", "LDG", "LDL", "STL", "SHFL", "MUFU")


def phase_build():
    """Build every library; print ptxas's reports and, per library, the counts
    of the SASS opcodes that show how it loads and multiplies, and the flash
    backward's and the cross-entropy's spills. Fails unless the flash forward,
    the flash backward and the fused cross-entropy issue wgmma (HGMMA) and
    TMA loads (UTMALDG), and flash-decode and the two scans 16-byte
    asynchronous copies (LDGSTS or UTMALDG) with no local-memory spills, and
    unless every kernel of the scans' backwards keeps within 128 registers a
    thread with no spills."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")
    summary = {}
    with concurrent.futures.ThreadPoolExecutor(len(_build.KERNELS)) as pool:   # cuobjdump at once
        listings = dict(zip(_build.KERNELS, pool.map(_build.sass, _build.KERNELS)))
    for name in _build.KERNELS:
        per_fn = _build.sass_opcodes(listings[name])
        summary[name] = {op: sum(c.get(op, 0) for c in per_fn.values()) for op in SASS_OPS}
        spills = re.findall(r"(\d+) bytes spill stores", logs.get(name, ""))
        if spills:   # ptxas reports only on a fresh build
            summary[name]["ptxas_spill_store_bytes"] = sum(int(x) for x in spills)
    print("sass " + json.dumps(summary))
    for name in ("flash_attention", "flash_attention_bwd", "decode_attention", "fused_xent"):
        for fn, report in _ptxas_by_function(logs.get(name, "")).items():
            print(f"  {name} {fn}: {report}")
        print(f"  {name}: SASS LDL {summary[name]['LDL']} STL {summary[name]['STL']}")
    # the wide forward's consumers hold 240 registers: none may spill
    check(summary["flash_attention"].get("ptxas_spill_store_bytes", 0) == 0,
          f"flash_attention: ptxas spills: {summary['flash_attention']}")
    for name in ("flash_attention", "flash_attention_bwd", "fused_xent"):
        fa = summary[name]
        check(fa["HGMMA"] > 0 and fa["UTMALDG"] > 0,
              f"{name}: no wgmma or no TMA load in its SASS: {fa}")
    for name in ("decode_attention", "rwkv_scan", "ssm_scan"):
        de = summary[name]
        check(de["LDGSTS"] + de["UTMALDG"] > 0 and de["LDL"] + de["STL"] == 0,
              f"{name}: no 16-byte asynchronous copy, or spills: {de}")
    # the scans' backwards: every instance within 128 registers and no spills
    for name in ("rwkv_scan_bwd", "ssm_scan_bwd"):
        reports = _ptxas_by_function(logs.get(name, ""))
        for fn, report in reports.items():
            print(f"  {name} {fn}: {report}")
        regs = [int(x) for r in reports.values() for x in re.findall(r"Used (\d+) registers", r)]
        spill = [int(x) for r in reports.values() for x in re.findall(r"(\d+) bytes spill", r)]
        check(max(regs, default=0) <= 128 and not any(spill)
              and summary[name]["LDL"] + summary[name]["STL"] == 0,
              f"{name}: above 128 registers or spills: {max(regs, default=0)} registers, "
              f"spill bytes {spill}, SASS {summary[name]}")
    return summary


def _ptxas_by_function(log: str) -> dict[str, str]:
    """ptxas's registers and spill bytes per kernel of a build log, keyed by
    the kernel's name (the mangled name's identifier and template argument)."""
    out, fn = {}, None
    for line in log.splitlines():
        if "Compiling entry function" in line:
            mangled = line.split("'")[1]
            fn = mangled[:60]
            for m in re.finditer(r"\d+", mangled):   # <length><identifier> pieces
                for i in range(len(m.group())):        # the length may follow hex digits
                    name = mangled[m.end():m.end() + int(m.group()[i:])]
                    if name.endswith("_kernel"):
                        tail = re.match(r"I\w*?E", mangled[m.end() + len(name):])
                        fn = name + (tail.group() if tail else "")
        elif fn and ("spill" in line or "registers" in line):
            out[fn] = (out.get(fn, "") + " " + line.split(":", 1)[-1].strip()).strip()
    return out


# ---------------------------------------------------------------------------
# Phase 3: kernels against their plain versions
# ---------------------------------------------------------------------------

def _rand(shape, dtype, gen):
    import torch
    return torch.randn(shape, generator=gen, device=DEVICE, dtype=torch.float32).to(dtype)


def _compare(name, got, want, dtype) -> float:
    import torch
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    tol = TOL[dtype_name(dtype)]
    ok = torch.allclose(got.float(), want.float(), **tol)
    check(ok, f"{name}: max abs err {err:.3e} outside {tol}")
    return err


def flash_cases():
    """(label, B, Sq, H, KH, Dh, Dv, causal, window, dtype, layout)."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    hy = _hybrid_attn()
    cases = [("serving", BATCH, PROMPT, 16, 8, 128, 128, True, None, bf16, "bshd"),
             ("serving-f32", BATCH, PROMPT, 16, 8, 128, 128, True, None, f32, "bshd"),
             # hymba-1.5b's prefill: a GQA group of 5, d_head 64, its window cutting
             ("hymba", BATCH, HYBRID_PROMPT, hy["h"], hy["kh"], hy["d"], hy["d"], True,
              hy["window"], bf16, "bshd"),
             ("hymba-f32", BATCH, HYBRID_PROMPT, hy["h"], hy["kh"], hy["d"], hy["d"], True,
              hy["window"], f32, "bshd")]
    for dtype in (f32, bf16):       # the sweep of tests/test_kernels.py
        for s, h, kh, d in [(128, 4, 4, 32), (256, 8, 2, 16), (192, 4, 1, 64),
                            (128, 2, 2, 48)]:
            cases.append((f"sweep-s{s}-h{h}-kh{kh}-d{d}-{dtype_name(dtype)}", 2, s, h, kh, d,
                          d, True, None, dtype, "bshd"))
    for w in (32, 100, 1000):
        cases.append((f"window-{w}", 1, 256, 4, 2, 32, 32, True, w, f32, "bshd"))
    cases += [("bidirectional", 2, 128, 4, 4, 32, 32, False, None, f32, "bshd"),
              ("dv-ne-dh", 1, 128, 4, 4, 40, 32, True, None, f32, "bshd"),
              ("ragged-mqa", 2, 77, 8, 1, 64, 64, True, None, f32, "bshd"),
              ("ragged-serving", 2, 1000, 16, 8, 128, 128, True, None, bf16, "bshd"),
              ("strided-bhsd", 2, 200, 8, 2, 128, 128, True, 64, bf16, "bhsd"),
              ("window-bf16", 1, 300, 4, 2, 64, 64, True, 100, bf16, "bshd"),
              ("bidirectional-bf16", 2, 130, 4, 4, 32, 32, False, None, bf16, "bshd"),
              ("unaligned-bf16", 2, 100, 4, 2, 36, 20, True, None, bf16, "bshd")]
    return cases + wide_flash_cases() + family_flash_cases()


def family_flash_cases():
    """The shapes the front-end and MoE paths give the forward, in bf16 and
    fp32: hubert-xlarge's training shape (one ring worker's B at S 1024, 16
    heads of 80, bidirectional: the padded-128 instance with ``causal=0``),
    also at a ragged S of 777; internvl2-76b's prefill (64 query heads over 8
    kv heads of 128) and gpt-oss-20b's (64 over 8 of 64)."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    a = _attn(AUDIO_ARCH)
    bw = TRAIN_BATCH // TRAIN_WORKERS
    cases = []
    for dtype in (bf16, f32):
        n = dtype_name(dtype)
        cases += [(f"{AUDIO_ARCH}-{n}", bw, TRAIN_SEQ, a["h"], a["kh"], a["d"], a["d"], False,
                   None, dtype, "bshd"),
                  (f"{AUDIO_ARCH}-s777-{n}", bw, 777, a["h"], a["kh"], a["d"], a["d"], False,
                   None, dtype, "bshd")]
        for arch in (VISION_ARCH, MOE_ARCH):
            g = _attn(arch)
            cases.append((f"{arch}-{n}", BATCH, PROMPT, g["h"], g["kh"], g["d"], g["d"], True,
                          None, dtype, "bshd"))
    return cases


def wide_flash_cases():
    """Head dims above 128, in fp32 and bf16: gemma-2b's prefill (D 256, MQA),
    stablelm-12b's (D 160), nemotron-4-340b's (D 192, group 12) at a small B
    and S, MLA's prefill head (Dh 192, Dv 128), ragged S, a window, strided
    (B,H,S,D) storage and bf16 heads TMA cannot read (padded by the wrapper).
    In bf16 also the wide instances' edges: S = 1, 79, 81, 113 and 777 (off
    the 64-row kv tiles and the 128-row query tiles; 777: many kv tiles with
    both ends ragged), windows that cut a tile, keys that grow along S so
    that row maxima rise tile after tile (the rescale the kernel skips where
    no maximum rose), and Dv 132 read in place (an output TMA cannot
    describe: stores from registers)."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    cases = []
    for arch in WIDE_CASE_ARCHS:
        a = _attn(arch)
        b, s = (BATCH, PROMPT) if a["h"] <= 32 else (1, 256)
        for dtype in (bf16, f32):
            cases.append((f"{arch}-{dtype_name(dtype)}", b, s, a["h"], a["kh"], a["d"], a["d"],
                          True, None, dtype, "bshd"))
    for dtype in (bf16, f32):
        n = dtype_name(dtype)
        cases += [(f"mla-192-128-{n}", 2, 300, 16, 16, 192, 128, True, None, dtype, "bshd"),
                  (f"wide-ragged-{n}", 2, 777, 8, 1, 256, 256, True, None, dtype, "bshd"),
                  (f"wide-window-{n}", 1, 500, 8, 2, 160, 160, True, 100, dtype, "bshd"),
                  (f"wide-bidirectional-{n}", 2, 130, 4, 4, 192, 192, False, None, dtype, "bshd"),
                  (f"wide-strided-bhsd-{n}", 2, 200, 8, 2, 256, 256, True, 64, dtype, "bhsd")]
    cases.append(("wide-unaligned-bf16", 2, 100, 4, 2, 196, 132, True, None, bf16, "bshd"))
    cases += [("wide-s1-bf16", 2, 1, 8, 1, 256, 256, True, None, bf16, "bshd"),
              ("wide-s79-bf16", 2, 79, 8, 1, 256, 256, True, None, bf16, "bshd"),
              ("wide-s81-bf16", 2, 81, 8, 1, 256, 256, True, None, bf16, "bshd"),
              ("wide-s113-192-bf16", 2, 113, 8, 2, 192, 192, True, None, bf16, "bshd"),
              ("wide-s777-bf16", 2, 777, 8, 1, 256, 256, True, None, bf16, "bshd"),
              ("wide-window-256-bf16", 2, 600, 8, 1, 256, 256, True, 100, bf16, "bshd"),
              ("wide-window-192-bf16", 1, 700, 8, 2, 192, 192, True, 150, bf16, "bshd"),
              ("wide-rising-256-bf16", 2, 1024, 8, 1, 256, 256, True, None, bf16, "rising"),
              ("wide-rising-160-bf16", 1, 1024, 32, 8, 160, 160, True, None, bf16, "rising"),
              ("wide-vsliced-bf16", 2, 200, 8, 2, 256, 132, True, None, bf16, "vsliced")]
    return cases


def _attn(arch):
    """An arch's attention shapes: heads, kv heads and d_head."""
    from repro_torch.models.config import get_config
    cfg = get_config(arch)
    return {"h": cfg.n_heads, "kh": cfg.n_kv_heads, "d": cfg.d_head}


def _hybrid_attn():
    """hymba-1.5b's attention shapes: heads, kv heads, d_head and window."""
    from repro_torch.models.config import get_config
    return {**_attn(HYBRID_ARCH), "window": get_config(HYBRID_ARCH).sliding_window}


def _flash_inputs(b, s, h, kh, dh, dv, dtype, layout, gen):
    import torch
    q = _rand((b, s, h, dh), dtype, gen)
    k = _rand((b, s, kh, dh), dtype, gen)
    v = _rand((b, s, kh, dv), dtype, gen)
    if layout == "bhsd":   # same values, stored head-major: strided (B,S,H,D) views
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    if layout == "rising":   # keys 1x to 4x as long along S: row maxima keep rising
        ramp = 1 + 3 * torch.arange(s, device=DEVICE, dtype=torch.float32) / s
        k = (k.float() * ramp[None, :, None, None]).to(dtype)
    if layout == "vsliced":  # v a view into rows 4 wider: Dv read where it lies
        v = _rand((b, s, kh, dv + 4), dtype, gen)[..., :dv]
    return q, k, v


def decode_cases():
    """(label, B, S, H, KH, Dh, Dv, n_valid, dtype, layout)."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    s_srv = PROMPT + GEN
    hy = _hybrid_attn()
    w, h, kh, d = hy["window"], hy["h"], hy["kh"], hy["d"]
    cases = [("serving", BATCH, s_srv, 16, 8, 128, 128, [s_srv, s_srv - 31, 1, 517][:BATCH], bf16,
              "dense"),
             ("serving-f32", BATCH, s_srv, 16, 8, 128, 128, [s_srv, 700, 1, 2][:BATCH], f32,
              "dense"),
             # hymba-1.5b's decode over its full ring of `window` slots, group 5
             ("hymba", BATCH, w, h, kh, d, d, w, bf16, "dense"),
             ("hymba-partial", BATCH, w, h, kh, d, d, [w, w - 31, 1, 517][:BATCH], bf16, "dense"),
             ("hymba-f32", BATCH, w, h, kh, d, d, [w, 700, 1, 2][:BATCH], f32, "dense")]
    for dtype in (f32, bf16):       # the sweep of tests/test_kernels.py
        for s, h, kh, d in [(512, 8, 2, 32), (1024, 4, 4, 64), (384, 8, 1, 16)]:
            cases.append((f"sweep-s{s}-h{h}-kh{kh}-d{d}-{dtype_name(dtype)}", 2, s, h, kh, d,
                          d, [s, s // 3], dtype, "dense"))
    cases += [("single-valid", 1, 256, 4, 2, 32, 32, 1, f32, "dense"),
              ("dv-ne-dh", 2, 300, 8, 2, 40, 32, [300, 7], f32, "dense"),
              ("g16", 2, 300, 16, 1, 128, 128, [299, 150], f32, "dense"),
              ("none-and-over", 2, 64, 4, 2, 32, 32, [0, 1000], f32, "dense"),
              ("strided", 2, 200, 16, 8, 128, 128, [200, 33], bf16, "sliced")]
    # caches the 16-byte copies cannot read (bf16 rows of 72 and 40 bytes, a
    # base 4 bytes off): the wrapper's padded copies
    cases += [(f"unaligned-{dtype_name(dtype)}", 2, 300, 8, 2, 36, 20, [300, 7], dtype,
               "misaligned") for dtype in (f32, bf16)]
    cases += wide_decode_cases()
    # the group-8 serving caches of internvl2-76b (D 128) and gpt-oss-20b (D 64)
    for arch in (VISION_ARCH, MOE_ARCH):
        g = _attn(arch)
        for dtype in (bf16, f32):
            cases.append((f"{arch}-{dtype_name(dtype)}", BATCH, s_srv, g["h"], g["kh"], g["d"],
                          g["d"], [s_srv, s_srv - 31, 1, 517][:BATCH], dtype, "dense"))
    # the split pass's edges, on the plan the wrapper makes for these shapes:
    # S one past a whole number of splits; n_valid on a split edge and one
    # past it (later splits empty), 0 (uniform over all S) and past S
    for dtype in (f32, bf16):
        for b, h, kh, d, dv in [(4, 8, 2, 64, 64), (4, 25, 5, 64, 64), (2, 16, 1, 128, 96)]:
            chunk = _decode_chunk(321, b, kh)
            s = 5 * chunk + 1
            check(_decode_chunk(s, b, kh) == chunk, f"split edges: the plan moved at S={s}")
            nv = [2 * chunk, 2 * chunk + 1, 0, s + 100][:b]
            cases.append((f"split-edges-b{b}-h{h}-kh{kh}-d{d}-dv{dv}-{dtype_name(dtype)}", b, s,
                          h, kh, d, dv, nv, dtype, "dense"))
    return cases


def wide_decode_cases():
    """Head dims above 128, in fp32 and bf16: gemma-2b's decode (D 256, MQA,
    a group of 8), stablelm-12b's (D 160), nemotron-4-340b's (D 192, a group
    of 12), MLA's head (Dh 192, Dv 128), the split edges at D 256 and the
    strided and misaligned caches. In bf16 also the wide kernel's plan
    (``decode_wide_plan``) at its edges: a cache that ends one slot into its
    cluster's last split, n_valid on a split edge and one past it, 0 and past
    S; S = 1; B x KH far above the SM count (256 one-block clusters); caches
    long enough for the ring of rounds at 256 and 192 dims."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    s_srv = PROMPT + GEN
    cases = []
    for arch in WIDE_CASE_ARCHS:
        a = _attn(arch)
        for dtype in (bf16, f32):
            cases.append((f"{arch}-{dtype_name(dtype)}", BATCH, s_srv, a["h"], a["kh"], a["d"],
                          a["d"], [s_srv, s_srv - 31, 1, 517][:BATCH], dtype, "dense"))
    for dtype in (bf16, f32):
        n = dtype_name(dtype)
        chunk = _decode_chunk(321, 4, 1)
        s = 5 * chunk + 1
        cases += [(f"mla-192-128-{n}", 2, 300, 16, 16, 192, 128, [300, 7], dtype, "dense"),
                  (f"wide-split-edges-{n}", 4, s, 8, 1, 256, 256,
                   [2 * chunk, 2 * chunk + 1, 0, s + 100], dtype, "dense"),
                  (f"wide-strided-{n}", 2, 200, 16, 8, 160, 160, [200, 33], dtype, "sliced"),
                  (f"wide-misaligned-{n}", 2, 300, 8, 2, 196, 132, [300, 7], dtype,
                   "misaligned")]
    bf16 = torch.bfloat16
    cluster, chunk = _decode_wide_plan(s_srv, 4, 1, 256)[:2]
    s = (cluster - 1) * chunk + 1
    check(_decode_wide_plan(s, 4, 1, 256)[:2] == (cluster, chunk),
          f"wide split edges: the plan moved at S={s}")
    cases += [("wide-cluster-edge-bf16", 4, s, 8, 1, 256, 256,
               [s, 2 * chunk, 2 * chunk + 1, 0], bf16, "dense"),
              ("wide-cluster-past-bf16", 4, s, 8, 1, 256, 256, [s + 100, s - 1, 1, 17], bf16,
               "dense"),
              ("wide-s1-bf16", 2, 1, 8, 1, 256, 256, [1, 0], bf16, "dense"),
              ("wide-many-blocks-bf16", 16, 300, 32, 16, 256, 256,
               [300 - 19 * i for i in range(15)] + [0], bf16, "dense"),
              ("wide-ring-256-bf16", 1, 4096, 8, 1, 256, 256, [4000], bf16, "dense"),
              ("wide-ring-160-bf16", 2, 4096, 16, 2, 160, 160, [4096, 1500], bf16, "dense")]
    return cases


def _decode_wide_plan(s, b, kh, d):
    """The wide flash-decode plan the wrapper makes for a cache of ``s`` slots
    at (B, KH) and padded head dim ``d`` on this card."""
    import torch
    from repro_torch.kernels.decode_attention import decode_wide_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return decode_wide_plan(s, b, kh, d, sms)


def _decode_chunk(s, b, kh):
    """The slots per split the flash-decode wrapper plans for a cache of ``s``
    slots at (B, KH) on this card."""
    import torch
    from repro_torch.kernels.decode_attention import decode_plan
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return decode_plan(s, b, kh, sms)[1]


def _decode_inputs(b, s, h, kh, dh, dv, dtype, layout, gen):
    if layout == "sliced":  # views into wider tensors: non-packed strides
        q = _rand((b, h, 2 * dh), dtype, gen)[..., :dh]
        k = _rand((b, s, kh, 2 * dh), dtype, gen)[..., :dh]
        v = _rand((b, s, kh, 2 * dv), dtype, gen)[..., :dv]
        return q, k, v
    q, k, v = (_rand((b, h, dh), dtype, gen), _rand((b, s, kh, dh), dtype, gen),
               _rand((b, s, kh, dv), dtype, gen))
    if layout == "misaligned":
        k, v = _misaligned(k), _misaligned(v)
    return q, k, v


def phase_kernels():
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    gen = torch.Generator(device=DEVICE).manual_seed(1)
    errs = {}
    for label, b, s, h, kh, dh, dv, causal, window, dtype, layout in flash_cases():
        q, k, v = _flash_inputs(b, s, h, kh, dh, dv, dtype, layout, gen)
        got = flash_attention(q, k, v, causal=causal, sliding_window=window)
        want = ref.flash_attention_ref(q, k, v, causal=causal, sliding_window=window)
        errs[("flash_attention", label)] = _compare(f"flash_attention[{label}]", got, want,
                                                    dtype)
        del q, k, v, got, want
    for label, b, s, h, kh, dh, dv, nv, dtype, layout in decode_cases():
        q, k, v = _decode_inputs(b, s, h, kh, dh, dv, dtype, layout, gen)
        n_valid = nv if isinstance(nv, int) else torch.tensor(nv, dtype=torch.int32,
                                                               device=DEVICE)
        got = decode_attention(q, k, v, n_valid)
        want = ref.decode_attention_ref(q, k, v, n_valid)
        errs[("decode_attention", label)] = _compare(f"decode_attention[{label}]", got, want,
                                                     dtype)
    torch.cuda.empty_cache()
    worst = {}
    for (name, label), e in errs.items():
        worst[name] = max(worst.get(name, 0.0), e)
    print("kernels vs plain: " + ", ".join(
        f"{name} {len([1 for n, _ in errs if n == name])} cases, serving err "
        f"{errs[(name, 'serving')]:.3e}, hymba err {errs[(name, 'hymba')]:.3e}, worst "
        f"{worst[name]:.3e}" for name in worst))
    wide = {c[0] for c in wide_flash_cases() + wide_decode_cases()}
    print("kernels vs plain, head dims above 128: " + json.dumps(
        {f"{name}[{label}]": e for (name, label), e in errs.items() if label in wide}))
    _print_family_errs(errs)
    return _err_summary(errs, "serving", extra=("hymba",), wide=wide)


def _print_family_errs(errs):
    """The max abs errors of the front end's and the MoE family's cases."""
    print("kernels vs plain, front end and MoE shapes: " + json.dumps(
        {f"{name}[{label}]": e for (name, label), e in errs.items()
         if label.startswith(FAMILY_ARCHS)}))


def _err_summary(errs, main, extra=(), wide=()):
    """{name: worst max abs err over every case, "name@main": the error at
    the main path's shape (and "name@label" for each ``extra`` label),
    "name@wide": the worst over the ``wide`` labels (the head dims above 128)
    "name@<arch>": the error at the bf16 case of each of ``WIDE_SERVE_ARCHS``
    and ``FAMILY_ARCHS``, and "name@<arch>:worst" the worst over every case
    of a ``FAMILY_ARCHS`` arch}."""
    out = {}
    for (name, label), e in errs.items():
        out[name] = max(out.get(name, 0.0), e)
        if label == main:
            out[f"{name}@main"] = e
        if label in extra:
            out[f"{name}@{label}"] = e
        if label in wide:
            out[f"{name}@wide"] = max(out.get(f"{name}@wide", 0.0), e)
        for arch in WIDE_SERVE_ARCHS + FAMILY_ARCHS:
            if label == f"{arch}-bfloat16":
                out[f"{name}@{arch}"] = e
        for arch in FAMILY_ARCHS:
            if label.startswith(arch):
                key = f"{name}@{arch}:worst"
                out[key] = max(out.get(key, 0.0), e)
    return out


# ---------------------------------------------------------------------------
# Phase 3, training kernels: the flash backward and the fused cross-entropy
# ---------------------------------------------------------------------------

def _rel(a, b) -> float:
    return ((a.float() - b.float()).norm() / b.float().norm().clamp_min(1e-30)).item()


def _compare_bwd(name, got, want, dtype) -> float:
    """Backward bars: fp32 elementwise 1e-4, bf16 2e-2 on the relative norm.
    Returns the max abs error."""
    import torch
    torch.cuda.synchronize()
    err = (got.float() - want.float()).abs().max().item()
    if dtype == torch.float32:
        ok = torch.allclose(got.float(), want.float(), **BWD_TOL_F32)
        check(ok, f"{name}: max abs err {err:.3e} outside {BWD_TOL_F32}")
    else:
        rel = _rel(got, want)
        check(rel <= BWD_REL_BF16, f"{name}: relative error {rel:.3e} above {BWD_REL_BF16}")
    return err


def flash_bwd_cases():
    """(label, B, S, H, KH, Dh, Dv, causal, window, dtype, layout): the
    training shapes (one worker's group of the ring; hymba-1.5b's windowed
    group of 5 too), the sweep of tests/test_kernels.py, and the edges."""
    import torch
    from repro_torch.models.config import get_config
    cfg = get_config(ARCH)
    f32, bf16 = torch.float32, torch.bfloat16
    bw = TRAIN_BATCH // TRAIN_WORKERS
    shape = (bw, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_head, True, None)
    cases = [("training", *shape, bf16, "bshd"), ("training-f32", *shape, f32, "bshd")]
    for dtype in (f32, bf16):
        for s, h, kh, d in [(128, 4, 4, 32), (256, 8, 2, 16), (192, 4, 1, 64), (128, 2, 2, 48)]:
            cases.append((f"sweep-s{s}-h{h}-kh{kh}-d{d}-{dtype_name(dtype)}", 2, s, h, kh, d,
                          d, True, None, dtype, "bshd"))
    cases += [("window-100", 1, 300, 4, 2, 64, 64, True, 100, f32, "bshd"),
              ("window-bf16", 1, 300, 4, 2, 64, 64, True, 100, bf16, "bshd"),
              ("bidirectional", 2, 130, 4, 4, 32, 32, False, None, f32, "bshd"),
              ("dv-ne-dh", 1, 128, 4, 4, 40, 32, True, None, f32, "bshd"),
              ("ragged-mqa", 2, 77, 8, 1, 64, 64, True, None, f32, "bshd"),
              ("ragged-training", 2, 1000, 16, 8, 128, 128, True, None, bf16, "bshd"),
              ("strided-bhsd", 2, 200, 8, 2, 128, 128, True, 64, bf16, "bhsd"),
              # rows TMA cannot read (72- and 40-byte heads): the wrapper's padded copies
              ("unaligned-bf16", 2, 100, 4, 2, 36, 20, True, None, bf16, "bshd")]
    # the front end's and the MoE family's training shapes: hubert-xlarge's
    # bidirectional 80-dim heads (and a ragged S), gpt-oss-20b's LoRA ring
    a, g = _attn(AUDIO_ARCH), _attn(MOE_ARCH)
    for dtype in (bf16, f32):
        n = dtype_name(dtype)
        cases += [(f"{AUDIO_ARCH}-{n}", bw, TRAIN_SEQ, a["h"], a["kh"], a["d"], a["d"], False,
                   None, dtype, "bshd"),
                  (f"{AUDIO_ARCH}-s777-{n}", bw, 777, a["h"], a["kh"], a["d"], a["d"], False,
                   None, dtype, "bshd")]
    cases.append((f"{MOE_ARCH}-bfloat16", bw, TRAIN_SEQ, g["h"], g["kh"], g["d"], g["d"], True,
                  None, bf16, "bshd"))
    # hymba-1.5b's training shape: group 5, D 64, a window of 1024 inside S 1536
    y = _hybrid_attn()
    for dtype in (bf16, f32):
        cases.append((f"{HYBRID_ARCH}-{dtype_name(dtype)}", bw, HYBRID_PROMPT, y["h"], y["kh"],
                      y["d"], y["d"], True, y["window"], dtype, "bshd"))
    return cases + wide_bwd_cases()


def wide_bwd_cases():
    """Head dims above 128, in fp32 and bf16: gemma-2b's training shape (one
    ring worker's B at S 1024, D 256, MQA), stablelm-12b's (D 160) and
    nemotron-4-340b's (D 192, group 12) at a small B and S, MLA's (Dh 192,
    Dv 128), ragged S, a window, strided storage and padded bf16 heads."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    bw = TRAIN_BATCH // TRAIN_WORKERS
    cases = []
    for arch in WIDE_CASE_ARCHS:
        a = _attn(arch)
        b, s = (bw, TRAIN_SEQ) if arch == WIDE_ARCH else (1, 256)
        for dtype in (bf16, f32):
            cases.append((f"{arch}-{dtype_name(dtype)}", b, s, a["h"], a["kh"], a["d"], a["d"],
                          True, None, dtype, "bshd"))
    for dtype in (bf16, f32):
        n = dtype_name(dtype)
        cases += [(f"mla-192-128-{n}", 1, 300, 8, 8, 192, 128, True, None, dtype, "bshd"),
                  (f"wide-ragged-{n}", 2, 333, 8, 1, 256, 256, True, None, dtype, "bshd"),
                  (f"wide-window-{n}", 1, 300, 4, 2, 160, 160, True, 100, dtype, "bshd"),
                  (f"wide-strided-bhsd-{n}", 2, 200, 8, 2, 256, 256, True, 64, dtype, "bhsd")]
    cases.append(("wide-unaligned-bf16", 2, 100, 4, 2, 196, 132, True, None, bf16, "bshd"))
    return cases + wide_split_cases()


def wide_split_cases():
    """bf16 cases of the head-split plan (``bwd_plan``) at D 256 under MQA
    and at D 192 and 160 where it keeps whole groups: a group of 7 that the
    plan cuts into items of 2, 2, 2 and 1 heads, gemma-2b's group cut under a
    window, and nemotron-4-340b's group of 12 and stablelm-12b's of 4 at one
    ring worker's training shape (enough items, so dK and dV go out
    directly)."""
    import torch
    bf16 = torch.bfloat16
    bw = TRAIN_BATCH // TRAIN_WORKERS
    return [("split-group-7-bf16", 3, TRAIN_SEQ, 7, 1, 256, 256, True, None, bf16, "bshd"),
            ("split-window-bf16", bw, TRAIN_SEQ, 8, 1, 256, 256, True, 300, bf16, "bshd"),
            ("unsplit-group-12-bf16", bw, TRAIN_SEQ, 96, 8, 192, 192, True, None, bf16, "bshd"),
            ("unsplit-group-4-bf16", bw, TRAIN_SEQ, 32, 8, 160, 160, True, None, bf16, "bshd")]


def check_bwd_plans():
    """Prints the backward's plan at gemma-2b's training shape and at the
    split cases, and fails unless each case takes the branch it is there
    for: split, with a ragged last item where it says so, or whole groups."""
    from repro_torch.kernels import flash_attention
    bwd_plan = flash_attention.bwd_plan
    sms = flash_attention._sm_count(0)
    a = _attn(WIDE_ARCH)
    bw = TRAIN_BATCH // TRAIN_WORKERS
    plans = {f"{WIDE_ARCH}-training": bwd_plan(bw, TRAIN_SEQ, a["h"], a["kh"], a["d"], a["d"],
                                               sms)}
    for label, b, s, h, kh, dh, dv, *_ in wide_split_cases():
        plans[label] = plan = bwd_plan(b, s, h, kh, dh, dv, sms)
        group = h // kh
        if label.startswith("split"):
            check(plan.splits > 1, f"flash_attention_bwd[{label}]: plan {plan} does not split")
        else:
            check(plan.splits == 1, f"flash_attention_bwd[{label}]: plan {plan} splits")
        if label == "split-group-7-bf16":
            check(group % plan.heads != 0, f"flash_attention_bwd[{label}]: plan {plan} divides")
    print(f"flash_attention_bwd plans on {sms} SMs: " + json.dumps(
        {k: {"block_kv": p.block_kv, "splits": p.splits, "heads": p.heads}
         for k, p in plans.items()}))


def xent_cases():
    """(label, T, D, V, dtype, layout, ignored share): the training shapes
    with the tied (V,D) head, the sweep of tests/test_kernels.py with a
    dense (D,V) head, ragged T and V, and the untied heads of the front end,
    the MoE family and the recurrent families."""
    import torch
    from repro_torch.models.config import get_config
    cfg = get_config(ARCH)
    f32, bf16 = torch.float32, torch.bfloat16
    t = TRAIN_BATCH // TRAIN_WORKERS * TRAIN_SEQ
    cases = [("training", t, cfg.d_model, cfg.vocab_size, bf16, "tied", 4),
             ("training-f32", t, cfg.d_model, cfg.vocab_size, f32, "tied", 4)]
    for dtype in (f32, bf16):
        for tt, d, v in [(128, 32, 512), (256, 16, 1024), (64, 64, 256)]:
            cases.append((f"sweep-t{tt}-d{d}-v{v}", tt, d, v, dtype, "dense", 0))
    cases += [("ragged-v", 100, 64, 1000, f32, "tied", 4),
              ("ragged-tv-bf16", 37, 40, 333, bf16, "tied", 3),
              ("ragged-d-bf16", 70, 100, 4097, bf16, "dense", 5)]
    # hubert-xlarge's untied 504-unit head (two vocabulary tiles, the second
    # 248 columns into its 256) and gpt-oss-20b's untied head
    audio, moe = get_config(AUDIO_ARCH), get_config(MOE_ARCH)
    cases += [(f"{AUDIO_ARCH}-bfloat16", t, audio.d_model, audio.vocab_size, bf16, "dense", 4),
              (f"{AUDIO_ARCH}-float32", t, audio.d_model, audio.vocab_size, f32, "dense", 4),
              (f"{MOE_ARCH}-bfloat16", t, moe.d_model, moe.vocab_size, bf16, "dense", 4)]
    # the recurrent families' untied heads at one ring worker's tokens:
    # hymba-1.5b's 32,001 (a ragged last vocabulary tile), rwkv6-7b's 65,536 x 4096
    bw = TRAIN_BATCH // TRAIN_WORKERS
    for arch, seq in ((HYBRID_ARCH, HYBRID_PROMPT), (RWKV_ARCH, RWKV_PROMPT)):
        c = get_config(arch)
        for dtype in (bf16, f32):
            cases.append((f"{arch}-{dtype_name(dtype)}", bw * seq, c.d_model, c.vocab_size, dtype,
                          "dense", 4))
    return cases


def _xent_inputs(t, d, v, dtype, layout, ignore_every, gen):
    """x (T,D), the head as (D,V) (a view of a (V,D) table when tied), labels."""
    import torch
    x = _rand((t, d), dtype, gen)
    if layout == "tied":
        w = (_rand((v, d), dtype, gen) * 0.05).to(dtype).T
    else:
        w = (_rand((d, v), dtype, gen) * 0.1).to(dtype)
    labels = torch.randint(0, v, (t,), generator=gen, device=DEVICE)
    if ignore_every:
        labels[::ignore_every] = -100
    return x, w, labels


def phase_train_kernels():
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.fused_xent import fused_xent
    gen = torch.Generator(device=DEVICE).manual_seed(4)
    errs, rels = {}, {}
    check_bwd_plans()
    for label, b, s, h, kh, dh, dv, causal, window, dtype, layout in flash_bwd_cases():
        q, k, v = _flash_inputs(b, s, h, kh, dh, dv, dtype, layout, gen)
        kw = dict(causal=causal, sliding_window=window)
        o, lse = flash_attention(q, k, v, return_lse=True, **kw)
        o_ref, lse_ref = ref.flash_attention_ref(q, k, v, return_lse=True, **kw)
        _compare(f"flash_attention[{label}] lse", lse, lse_ref, torch.float32)
        do = _rand(o.shape, dtype, gen)
        got = flash_attention_bwd(q, k, v, o, lse, do, **kw)
        plain = ref.flash_attention_bwd_ref(q, k, v, o, lse, do, **kw)
        leaves = [t.detach().requires_grad_() for t in (q, k, v)]
        auto = torch.autograd.grad(ref.flash_attention_ref(*leaves, **kw), leaves, do)
        err = 0.0
        for name, g, p, a in zip(("dq", "dk", "dv"), got, plain, auto):
            err = max(err, _compare_bwd(f"flash_attention_bwd[{label}] {name} vs plain", g, p,
                                        dtype))
            _compare_bwd(f"flash_attention_bwd[{label}] {name} vs autograd", g, a, dtype)
        if label == "training":
            print("flash_attention_bwd[training] relative error vs plain: " + ", ".join(
                f"{name} {_rel(g, p):.3e}" for name, g, p in zip(("dq", "dk", "dv"), got, plain)))
        errs[("flash_attention_bwd", label)] = err
        rels[label] = max(_rel(g, p) for g, p in zip(got, plain))
        del q, k, v, o, lse, do, got, plain, auto, leaves, o_ref, lse_ref
    for label, t, d, v, dtype, layout, every in xent_cases():
        x, w, labels = _xent_inputs(t, d, v, dtype, layout, every, gen)
        with torch.no_grad():
            loss, lse = fused_xent(x, w, labels)
            loss_ref, lse_ref = ref.fused_xent_ref(x, w, labels, return_lse=True)
        err = _compare(f"fused_xent[{label}] loss", loss, loss_ref, torch.float32)
        _compare(f"fused_xent[{label}] lse", lse, lse_ref, torch.float32)
        check(bool((loss[labels == -100] == 0).all()), f"fused_xent[{label}]: ignored tokens")
        g = _rand((t,), torch.float32, gen)
        xl, wl = x.detach().requires_grad_(), w.detach().requires_grad_()
        got = torch.autograd.grad(ops.fused_xent(xl, wl, labels), (xl, wl), g)
        want = torch.autograd.grad(ref.fused_xent_ref(xl, wl, labels), (xl, wl), g)
        for name, a, b_ in zip(("dx", "dw"), got, want):
            _compare_bwd(f"fused_xent[{label}] {name} vs autograd of the plain version", a, b_,
                         dtype)
        errs[("fused_xent", label)] = err
        del x, w, labels, loss, lse, loss_ref, lse_ref, got, want, xl, wl
    torch.cuda.empty_cache()
    for name in ("flash_attention_bwd", "fused_xent"):
        n = len([1 for k, _ in errs if k == name])
        worst = max(e for (k, _), e in errs.items() if k == name)
        print(f"kernels vs plain: {name} {n} cases, training err "
              f"{errs[(name, 'training')]:.3e}, worst {worst:.3e}")
    wide = {c[0] for c in wide_bwd_cases()}
    print("kernels vs plain, head dims above 128: " + json.dumps(
        {f"{name}[{label}]": e for (name, label), e in errs.items() if label in wide}))
    print("flash_attention_bwd vs plain, head dims above 128, worst relative norm of dq, dk, "
          "dv: " + json.dumps({label: r for label, r in rels.items() if label in wide}))
    _print_family_errs(errs)
    print("flash_attention_bwd vs plain, front end and MoE shapes, worst relative norm of dq, "
          "dk, dv: " + json.dumps({label: r for label, r in rels.items()
                                   if label.startswith(FAMILY_ARCHS)}))
    recurrent = (HYBRID_ARCH, RWKV_ARCH)
    print("kernels vs plain, the recurrent families' training shapes: " + json.dumps(
        {f"{name}[{label}]": e for (name, label), e in errs.items()
         if label.startswith(recurrent)}) + ", flash_attention_bwd worst relative norm: "
          + json.dumps({label: r for label, r in rels.items() if label.startswith(recurrent)}))
    return _err_summary(errs, "training", wide=wide)


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def _serve_launcher(arch):
    """``serve.main`` for ``arch`` (``BATCH`` x ``PROMPT``, ``GEN`` greedy
    tokens), the attention kernels' counts set to 0 just before and read
    just after: flash once a layer, flash-decode once a layer a step; finite
    logits. Returns (served, launches), with the run's peak memory."""
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve
    from repro_torch.models.config import get_config

    cfg = get_config(arch)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    decode_attention.launches = 0
    served = serve.main(["--arch", arch, "--batch", str(BATCH), "--prompt-len", str(PROMPT),
                         "--gen", str(GEN), "--device", DEVICE])
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    served.peak_memory_gb = torch.cuda.max_memory_allocated() / 1e9
    print(f"main path launches ({arch}): {launches}, peak memory "
          f"{served.peak_memory_gb:.2f} GB")
    check(launches == {"flash_attention": cfg.n_layers,
                       "decode_attention": cfg.n_layers * GEN},
          f"{arch}: launches {launches}, not {cfg.n_layers} and {cfg.n_layers * GEN}")
    check(all(bool(torch.isfinite(lg).all()) for lg in served.logits),
          f"{arch}: non-finite logits")
    check(tuple(served.tokens.shape) == (BATCH, GEN), f"tokens {tuple(served.tokens.shape)}")
    return served, launches



def phase_serve(arch=ARCH):
    import torch
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models import transformer as T
    from repro_torch.models.config import get_config
    from repro_torch.optim.adam import tree_leaves

    cfg = get_config(arch)
    served, launches = _serve_launcher(arch)

    # Decode step 1 consumed the first generated token after the prompt; a
    # prefill of prompt + that token must give the same next-token logits.
    # Both are bf16 paths that round at other points (matmuls of other
    # shapes); after 28 layers of random weights they part by up to ~8e-2 in
    # single logits, so the bf16 bar of 2e-2 is taken on the relative norm,
    # between the two and for each against an fp32 prefill of the same
    # weights. The fp32 check below holds decode to prefill elementwise.
    prefix = torch.cat([served.prompts, served.tokens[:, :1]], dim=1)
    got = served.logits[1]
    want, _ = build_prefill_step(cfg, PROMPT + 1)(served.params, {"tokens": prefix})

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    # an fp32 copy of the weights where it fits beside them (not stablelm-12b's 48 GB)
    fp32_bytes = 4 * sum(t.numel() for t in tree_leaves(served.params))
    if fp32_bytes < torch.cuda.mem_get_info()[0] / 2:
        truth, _ = build_prefill_step(cfg, PROMPT + 1)(_cast(served.params, torch.float32),
                                                       {"tokens": prefix})
        print(f"decode vs prefill, bf16, {cfg.n_layers} layers, relative error: decode vs "
              f"fp32 {rel(got, truth):.3e}, prefill vs fp32 {rel(want, truth):.3e}, decode vs "
              f"prefill {rel(got, want):.3e} (max abs {(got - want).abs().max().item():.3e}, "
              f"logits max abs {truth.abs().max().item():.2f}); argmax agrees with fp32: decode "
              f"{(got.argmax(-1) == truth.argmax(-1)).float().mean().item():.2f}, prefill "
              f"{(want.argmax(-1) == truth.argmax(-1)).float().mean().item():.2f}")
        check(rel(got, truth) <= 2e-2 and rel(want, truth) <= 2e-2,
              "bf16 serving logits are off the fp32 prefill of the same prefix")
        del truth
    else:
        print(f"decode vs prefill, bf16, {cfg.n_layers} layers, relative error {rel(got, want):.3e} "
              f"(max abs {(got - want).abs().max().item():.3e}); no fp32 prefill at full depth: "
              f"{fp32_bytes / 1e9:.1f} GB of fp32 weights")
    check(rel(got, want) <= 2e-2, "bf16 decode logits disagree with the prefill of the "
                                  "same prefix")
    served.decode_vs_prefill_rel = rel(got, want)

    # The same check in fp32 at full width and two layers: the bf16 check
    # above is bounded by bf16 rounding, this one by fp32 sum order.
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    gen = torch.Generator(device=DEVICE).manual_seed(2)
    p32 = T.init_params(cfg2, gen, dtype=torch.float32, device=DEVICE)
    toks = torch.randint(0, cfg2.vocab_size, (2, 257), generator=gen, device=DEVICE)
    logits, cache = build_prefill_step(cfg2, 260)(p32, {"tokens": toks[:, :256]})
    step_logits, _ = build_decode_step(cfg2)(p32, cache, toks[:, 256])
    want32, _ = build_prefill_step(cfg2, 257)(p32, {"tokens": toks})
    f32_err = (step_logits - want32).abs().max().item()
    print(f"decode vs prefill, fp32, 2 layers ({arch}): max abs err {f32_err:.3e}")
    check(torch.allclose(step_logits, want32, rtol=1e-4, atol=1e-4),
          "fp32 decode logits disagree with the prefill of the same prefix")
    del p32, cache
    torch.cuda.empty_cache()
    return served, launches


# ---------------------------------------------------------------------------
# Phase 5: timings
# ---------------------------------------------------------------------------

def _time_ms(fn, sets, reps):
    """Mean ms per call over ``reps`` passes through ``sets`` (several input
    sets, together larger than the 50 MB L2, so each call finds its inputs
    cold, as the main path does)."""
    import torch
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        for args in sets:
            fn(*args)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (reps * len(sets))


def _graph_ms(fn, sets, reps, replays=5):
    """Device ms per call: ``reps`` passes through ``sets`` captured in one
    CUDA graph, replayed ``replays`` times between two events. The host's
    launch path is not timed; gaps between the graph's kernels are."""
    import torch
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for args in sets:
            fn(*args)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            for args in sets:
                fn(*args)
    graph.replay()
    torch.cuda.synchronize()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    del graph
    return start.elapsed_time(end) / (replays * reps * len(sets))


def _queued_ms(fn, sets, reps):
    """Device ms per call of ``reps`` passes through ``sets``, for calls a
    CUDA graph cannot capture (SDPA's cuDNN backward): the host enqueues the
    calls behind a ~0.5 s sleep kernel, so they run back to back on the
    device and the events around them time the device alone. Fails if the
    host took longer to enqueue them than the sleep lasted."""
    import torch
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    slept, start, end = (torch.cuda.Event(enable_timing=True) for _ in range(3))
    slept.record()
    torch.cuda._sleep(1_000_000_000)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        for args in sets:
            fn(*args)
    host_ms = (time.perf_counter() - t0) * 1e3
    end.record()
    torch.cuda.synchronize()
    check(host_ms < slept.elapsed_time(start),
          f"_queued_ms: enqueueing took {host_ms:.1f} ms, longer than the sleep")
    return start.elapsed_time(end) / (reps * len(sets))


def _kernel_ms(fn, sets, reps):
    """{kernel name: device ms per call}: the summed duration of each kernel
    in a ``torch.profiler`` trace of ``reps`` passes through ``sets``."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    for args in sets:
        fn(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            for args in sets:
                fn(*args)
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            found = re.search(r"(\w+)(?:<|\()", e.name)
            name = found.group(1) if found else e.name[:40]
            out[name] = out.get(name, 0.0) + e.time_range.elapsed_us() / 1e3 / (reps * len(sets))
    return out


def _warm_serving(cfg, served):
    """The serve run's own times, and warm ones on the host around a
    synchronise: the median of 3 prefills of the prompts, and ``GEN`` greedy
    decode steps (ms per step of ``BATCH`` tokens)."""
    import torch
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    prefill = build_prefill_step(cfg, PROMPT + GEN)
    decode = build_decode_step(cfg)
    batch = {"embeds" if cfg.frontend else "tokens": served.prompts}
    t_pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(served.params, batch)
        torch.cuda.synchronize()
        t_pre.append(time.perf_counter() - t0)
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GEN):
        logits, cache = decode(served.params, cache, tok)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    return {
        "serve_run": {"prefill_ms": served.t_prefill * 1e3,
                      "decode_ms_per_token": served.t_decode * 1e3 / GEN},
        "warm": {"prefill_ms": sorted(t_pre)[1] * 1e3,
                 "prefill_tok_per_s": BATCH * PROMPT / sorted(t_pre)[1],
                 "decode_ms_per_token": t_dec * 1e3 / GEN,
                 "decode_tok_per_s": BATCH * GEN / t_dec},
    }


def _sdpa_gqa():
    import torch
    major, minor = (int(x) for x in torch.__version__.split(".")[:2])
    return (major, minor) >= (2, 5)


def phase_timings(served, errs, launches):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models.config import get_config

    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(3)
    bf16 = torch.bfloat16
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    gqa = _sdpa_gqa()
    out = []

    # flash attention at the prefill shapes
    sets = [_flash_inputs(BATCH, PROMPT, h, kh, d, d, bf16, "bshd", gen) for _ in range(4)]
    ms = _time_ms(lambda q, k, v: flash_attention(q, k, v, causal=True), sets, 10)
    plain_ms = _time_ms(lambda q, k, v: ref.flash_attention_ref(q, k, v, causal=True),
                        sets[:2], 3)
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in s) for s in sets]
    if not gqa:
        lib_sets = [(q, k.repeat_interleave(h // kh, 1), v.repeat_interleave(h // kh, 1))
                    for q, k, v in lib_sets]
    kw = {"enable_gqa": True} if gqa else {}
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True, **kw)  # noqa: E731
    lib_ms = _time_ms(sdpa, lib_sets, 10)
    elem = 2
    nbytes = (2 * BATCH * PROMPT * h * d + 2 * BATCH * PROMPT * kh * d) * elem
    pairs = PROMPT * (PROMPT + 1) // 2
    flops = 2 * BATCH * h * pairs * (d + d)
    row = _row("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
               "src/repro/kernels/flash_attention.py:78", launches, errs, ms, plain_ms,
               lib_ms, nbytes, flops, "bfloat16")
    row.update({"device_ms": _graph_ms(lambda q, k, v: flash_attention(q, k, v, causal=True),
                                       sets, 5),
                "library_device_ms": _graph_ms(sdpa, lib_sets, 5),
                "tflops": flops / (ms * 1e-3) / 1e12})
    out.append(row)
    del sets, lib_sets

    # flash-decode at the last decode step's shapes: the cache is full
    w = PROMPT + GEN
    nv = torch.full((BATCH,), w, dtype=torch.int32, device=DEVICE)
    sets = [_decode_inputs(BATCH, w, h, kh, d, d, bf16, "dense", gen) for _ in range(8)]
    ms = _time_ms(lambda q, k, v: decode_attention(q, k, v, nv), sets, 20)
    plain_ms = _time_ms(lambda q, k, v: ref.decode_attention_ref(q, k, v, nv), sets, 5)
    lib_sets = [(q[:, :, None, :], k.transpose(1, 2).contiguous(), v.transpose(1, 2).contiguous())
                for q, k, v in sets]
    if not gqa:
        lib_sets = [(q, k.repeat_interleave(h // kh, 1), v.repeat_interleave(h // kh, 1))
                    for q, k, v in lib_sets]
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(q, k, v, **kw)  # noqa: E731
    lib_ms = _time_ms(sdpa, lib_sets, 20)
    nbytes = (2 * BATCH * h * d + 2 * BATCH * w * kh * d) * elem + 4 * BATCH
    flops = 2 * BATCH * h * w * (d + d)
    row = _row("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
               "src/repro/kernels/decode_attention.py:55", launches, errs, ms, plain_ms,
               lib_ms, nbytes, flops, "bfloat16")
    kern = lambda q, k, v: decode_attention(q, k, v, nv)   # noqa: E731
    # At ~10 us a call, events over back-to-back calls time the host's launch
    # path; the device time comes from replaying a CUDA graph of the calls.
    row.update({"device_ms": _graph_ms(kern, sets, 20),
                "library_device_ms": _graph_ms(sdpa, lib_sets, 20),
                "device_kernels_ms": _kernel_ms(kern, sets, 10),
                "library_device_kernels_ms": _kernel_ms(sdpa, lib_sets, 10)})
    out.append(row)
    del sets, lib_sets

    # serving steps, warm, timed on the host around a synchronise
    prefill = build_prefill_step(cfg, w)
    decode = build_decode_step(cfg)
    batch = {"tokens": served.prompts}
    timings = _warm_serving(cfg, served)
    # one traced prefill, then four traced decode steps on a fresh cache
    timings["traced_prefill"] = _trace(lambda: prefill(served.params, batch), 1)
    logits, cache = prefill(served.params, batch)
    state = {"tok": logits.argmax(-1), "cache": cache}

    def step():
        lg, state["cache"] = decode(served.params, state["cache"], state["tok"])
        state["tok"] = lg.argmax(-1)

    timings["traced_decode_step"] = _trace(step, 4)
    print("timings " + json.dumps(timings))
    return out


# ---------------------------------------------------------------------------
# Phase 6: the training path
# ---------------------------------------------------------------------------

TRAIN_KERNELS = ("flash_attention", "flash_attention_bwd", "fused_xent")


def _train_counters():
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.fused_xent import fused_xent
    return {"flash_attention": flash_attention, "flash_attention_bwd": flash_attention_bwd,
            "fused_xent": fused_xent}


def _kernel_counters(cfg):
    """The training kernels that ``cfg``'s ring launches, by name: the flash
    forward and backward where its layers attend, a scan's forward and
    backward where they recur, and the cross-entropy."""
    from repro_torch.kernels.rwkv_scan import rwkv_scan, rwkv_scan_bwd
    from repro_torch.kernels.ssm_scan import ssm_scan, ssm_scan_bwd
    out = _train_counters()
    if cfg.block_kind == "rwkv6":
        del out["flash_attention"], out["flash_attention_bwd"]
        out.update(rwkv_scan=rwkv_scan, rwkv_scan_bwd=rwkv_scan_bwd)
    elif cfg.block_kind == "hybrid":
        out.update(ssm_scan=ssm_scan, ssm_scan_bwd=ssm_scan_bwd)
    return out


def _family_launches(cfg, plan, passes):
    """``_ring_launches`` for ``cfg``'s kernels (``_kernel_counters``): a
    scan's forward and backward run as often as the flash forward and
    backward of an attention layer would."""
    base = _ring_launches(plan, passes, False)
    fwd, bwd = base["flash_attention"], base["flash_attention_bwd"]
    out = {"fused_xent": base["fused_xent"]}
    if cfg.block_kind == "rwkv6":
        out.update(rwkv_scan=fwd, rwkv_scan_bwd=bwd)
    else:
        out.update(flash_attention=fwd, flash_attention_bwd=bwd)
    if cfg.block_kind == "hybrid":
        out.update(ssm_scan=fwd, ssm_scan_bwd=bwd)
    return out


def phase_train(arch=ARCH, seq=TRAIN_SEQ):
    import torch
    from repro_torch.launch import train
    from repro_torch.models.config import get_config

    cfg = get_config(arch)
    counters = _kernel_counters(cfg)
    gc.collect()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    argv = ["--arch", arch, "--strategy", "roundpipe", "--mesh", f"1x{TRAIN_WORKERS}",
            "--partition", "auto", "--batch", str(TRAIN_BATCH), "--seq", str(seq),
            "--steps", str(TRAIN_STEPS), "--log-every", "1", "--device", DEVICE]
    out = train.main(argv)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    plan = out["plan"]
    want = _family_launches(cfg, plan, TRAIN_STEPS)
    print(f"train launches ({arch}): {launches} (the plan predicts {want}; L={plan.n_layers}, "
          f"fused body layers f={plan.fused.size}), peak memory {peak / 1e9:.2f} GB")
    check(launches == want, f"training launches {launches} != the plan's {want}")
    check(all(math.isfinite(x) for x in out["losses"]), f"non-finite losses {out['losses']}")
    return out, launches, peak


def phase_repeated_batch(out, arch=ARCH, seq=TRAIN_SEQ):
    """3 steps of a fresh state on one repeated batch: the loss falls. The
    middle step is traced. The learning rate is 1e-5, not the launcher's
    3e-4: Adam's first steps move every weight by about the learning rate
    in the gradient's sign, and at d_model 2048 without warmup 3e-4 changes
    each layer's output by a large fraction of itself, so the loss
    overshoots (10.32 -> 20.20 -> 12.80 measured on this batch)."""
    import torch
    from repro_torch.core.dispatch import build_roundpipe_train_step, init_roundpipe_state
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.config import get_config
    from repro_torch.optim import OptConfig

    del out["state"]
    torch.cuda.empty_cache()
    cfg = get_config(arch)
    step_cfg = StepConfig(strategy="roundpipe", kv_chunk=min(1024, seq),
                          xent_chunk=min(256, seq), partition=out["plan"],
                          opt=OptConfig(lr=1e-5))
    step, _ = build_roundpipe_train_step(cfg, TRAIN_WORKERS, step_cfg, TRAIN_BATCH, seq,
                                         plan=out["plan"])
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    state = {"s": init_roundpipe_state(gen, cfg, step_cfg, n_workers=TRAIN_WORKERS,
                                       device=DEVICE)}
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, seq, TRAIN_BATCH, seed=7))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(0).items()}
    losses, times = [], []

    def one():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        state["s"], m = step(state["s"], batch)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)

    one()
    traced = _trace(one, 1)
    one()
    print(f"repeated batch ({arch}, lr 1e-5): losses {losses}, step s {times}")
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    check(losses[-1] < losses[0], f"loss does not fall on a repeated batch: {losses}")
    del state
    torch.cuda.empty_cache()
    return losses, times, traced


def phase_ring_vs_single():
    """Ring grads (kernels) against the single program's grads (the plain
    versions, called directly) at full width, 2 layers: fp32 (loss rtol 1e-4,
    worst max-abs relative error 5e-3) and bf16, where the kernels' bf16 paths
    run (loss and every leaf's grad within 2e-2 on the relative norm)."""
    out = {"float32": _ring_vs_single("float32"), "bfloat16": _ring_vs_single("bfloat16")}
    f32, b16 = out["float32"], out["bfloat16"]
    check(f32["loss_rel"] <= 1e-4, "ring loss disagrees with the single program (fp32)")
    check(f32["worst_rel"] < 5e-3, "ring grads disagree with the single program (fp32)")
    check(b16["loss_rel"] <= BWD_REL_BF16, "ring loss disagrees with the single program (bf16)")
    check(b16["worst_norm_rel"] <= BWD_REL_BF16,
          "ring grads disagree with the single program (bf16)")
    return out


@contextlib.contextmanager
def _plain_ops():
    """The kernel entries swapped for the plain versions, called directly."""
    from repro_torch.kernels import ops, ref
    kept = {name: getattr(ops, name)
            for name in ("flash_attention", "fused_xent", "rwkv_scan", "ssm_scan")}
    ops.flash_attention = ref.flash_attention_ref
    ops.fused_xent = lambda x, w, lab, ignore_index=-100: ref.fused_xent_ref(
        x, w, lab, ignore_index=ignore_index)
    ops.rwkv_scan = ref.rwkv_scan_ref
    ops.ssm_scan = ref.ssm_scan_ref
    try:
        yield
    finally:
        for name, fn in kept.items():
            setattr(ops, name, fn)


def _leaf_names(tree, prefix=""):
    """Dotted paths of a parameter tree's leaves, in ``tree_leaves`` order."""
    if isinstance(tree, dict):
        return [n for k, v in tree.items() for n in _leaf_names(v, f"{prefix}.{k}")]
    if isinstance(tree, list):
        return [n for i, v in enumerate(tree) for n in _leaf_names(v, f"{prefix}[{i}]")]
    return [prefix.lstrip(".")]


def _ring_vs_single(dtype_label, arch=ARCH, n_layers=2):
    """In bf16 also the ring's grads through the plain versions against the
    same oracle: the floor that the ring's own order of bf16 operations sets,
    printed beside the kernels' error (it gates nothing). A front-end arch
    takes random embeds for tokens; its embedding table's gradient is zero
    in the ring and absent from the single program (``embed_grad_zero``)."""
    import torch
    from repro_torch.core.dispatch import build_roundpipe_grads_fn
    from repro_torch.core.plan import plan_from_config, uniform_partition
    from repro_torch.models import transformer as T
    from repro_torch.models.config import get_config
    from repro_torch.optim.adam import tree_leaves

    dtype = getattr(torch, dtype_label)
    cfg = dataclasses.replace(get_config(arch), n_layers=n_layers)
    # one layer per slot, so the check runs F slots, the fused FB and B slots
    plan = plan_from_config(cfg, TRAIN_WORKERS, partition=uniform_partition(n_layers))
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    params = T.init_params(cfg, gen, dtype=dtype, device=DEVICE)
    if cfg.frontend:
        batch = {"embeds": torch.randn((TRAIN_WORKERS, 256, cfg.d_model), generator=gen,
                                       device=DEVICE).to(dtype)}
    else:
        batch = {"tokens": torch.randint(0, cfg.vocab_size, (TRAIN_WORKERS, 256), generator=gen,
                                         device=DEVICE)}
    labels = torch.randint(0, cfg.vocab_size, (TRAIN_WORKERS, 256), generator=gen, device=DEVICE)
    labels[:, ::5] = -100
    batch["labels"] = labels
    ring_fn = build_roundpipe_grads_fn(cfg, TRAIN_WORKERS, plan)
    counters = _kernel_counters(cfg)
    before = {k: fn.launches for k, fn in counters.items()}
    grads, loss, _ = ring_fn(params, batch)
    ring = {k: fn.launches for k, fn in counters.items()}
    check(all(ring[k] > before[k] for k in counters),
          f"the ring did not run through every training kernel ({dtype_label})")
    floor = None
    with _plain_ops():
        if dtype == torch.bfloat16:
            floor = tree_leaves(ring_fn(params, batch)[0])
        leaves = tree_leaves(params)
        for x in leaves:
            x.requires_grad_()
        want_loss = T.loss_fn(params, batch, cfg, remat=False)
        want = torch.autograd.grad(want_loss, leaves, allow_unused=bool(cfg.frontend))
    check({k: fn.launches for k, fn in counters.items()} == ring,
          "the single-program oracle launched a kernel")
    embed_zero = None
    if cfg.frontend:     # the table is unused: zero in the ring, no gradient in autograd
        unused = [w is None for w in want]
        embed_zero = (not grads["embed"].any().item()
                      and unused == [x is params["embed"] for x in leaves])
        want = [torch.zeros_like(x) if w is None else w for x, w in zip(leaves, want)]
    got = tree_leaves(grads)
    check(len(got) == len(want), "ring grads and single-program grads differ in structure")
    names = _leaf_names(params)
    worst = max(((g.float() - w.float()).abs().max() / (w.float().abs().max() + 1e-6)).item()
                for g, w in zip(got, want))
    norms = sorted(((_rel(g, w), n) for g, w, n in zip(got, want, names)), reverse=True)
    want_loss = want_loss.item()
    rel_loss = abs(float(loss) - want_loss) / abs(want_loss)
    out = {"loss_rel": rel_loss, "worst_rel": worst, "worst_norm_rel": norms[0][0],
           "worst_leaves": {n: e for e, n in norms[:3]}}
    if embed_zero is not None:
        out["embed_grad_zero"] = embed_zero
    if floor is not None:
        out["plain_ring_worst_norm_rel"] = max(_rel(g, w) for g, w in zip(floor, want))
    print(f"ring vs single program ({arch}), {dtype_label}, full width, {n_layers} layers, plan "
          f"{plan.describe()}: loss {float(loss):.6f} vs {want_loss:.6f} (rel {rel_loss:.2e}), "
          f"worst relative grad error {worst:.3e} (max abs), {norms[0][0]:.3e} (norm, "
          f"{norms[0][1]}) over {len(got)} leaves; "
          + json.dumps({k: v for k, v in out.items() if k not in ("loss_rel", "worst_rel")}))
    del params, grads, want, leaves, floor
    torch.cuda.empty_cache()
    return out


# ---------------------------------------------------------------------------
# Phase 7: training timings
# ---------------------------------------------------------------------------

def phase_train_timings(errs, launches):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.fused_xent import fused_xent

    from repro_torch.models.config import get_config
    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(6)
    bf16 = torch.bfloat16
    h, kh, d = cfg.n_heads, cfg.n_kv_heads, cfg.d_head
    bw, s = TRAIN_BATCH // TRAIN_WORKERS, TRAIN_SEQ
    out = []

    # flash backward at one worker's training shapes
    sets = []
    for _ in range(4):
        q, k, v = _flash_inputs(bw, s, h, kh, d, d, bf16, "bshd", gen)
        o, lse = flash_attention(q, k, v, return_lse=True)
        sets.append((q, k, v, o, lse, _rand(o.shape, bf16, gen)))
    ms = _time_ms(flash_attention_bwd, sets, 10)
    plain_ms = _time_ms(ref.flash_attention_bwd_ref, sets[:2], 3)
    gqa = _sdpa_gqa()
    lib = []
    for q, k, v, o, lse, do in sets:
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        if gqa:
            ot = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True, enable_gqa=True)
        else:
            ot = F.scaled_dot_product_attention(qt, kt.repeat_interleave(h // kh, 1),
                                                vt.repeat_interleave(h // kh, 1),
                                                is_causal=True)
        lib.append((ot, (qt, kt, vt), do.transpose(1, 2).contiguous()))
    sdpa_bwd = lambda ot, leaves, dot: torch.autograd.grad(ot, leaves, dot,  # noqa: E731
                                                           retain_graph=True)
    lib_ms = _time_ms(sdpa_bwd, lib, 10)
    elem = 2
    # read q, k, v, o, dO and lse once; write dq, dk and dv once
    nbytes = (4 * bw * s * h * d + 4 * bw * s * kh * d) * elem + bw * h * s * 4
    pairs = s * (s + 1) // 2
    flops = 5 * 2 * bw * h * pairs * d
    row = _row("flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
               "none (the reference differentiates jnp chunked_attention, "
               "src/repro/models/layers.py:76)", launches, errs, ms, plain_ms, lib_ms,
               nbytes, flops, "bfloat16")
    # Device time: the kernel's calls replayed as a CUDA graph; SDPA's backward
    # (cuDNN) cannot be captured, so both are also timed as calls queued
    # behind a sleep kernel, which is the yardstick's device time.
    row.update({"device_ms": _graph_ms(flash_attention_bwd, sets, 5),
                "device_queued_ms": _queued_ms(flash_attention_bwd, sets, 10),
                "library_device_ms": _queued_ms(sdpa_bwd, lib, 10)})
    out.append(row)
    del sets, lib

    # fused cross-entropy forward at one worker's training shapes, tied head
    t, dm, vocab = bw * s, cfg.d_model, cfg.vocab_size
    x, w, labels = _xent_inputs(t, dm, vocab, bf16, "tied", 4, gen)
    sets = [(x, w, labels)]
    ms = _time_ms(lambda a, b, c: fused_xent(a, b, c), sets, 10)
    plain_ms = _time_ms(lambda a, b, c: ref.fused_xent_ref(a, b, c), sets, 3)
    lib_ms = _time_ms(lambda a, b, c: F.cross_entropy(a @ b, c, reduction="none"), sets, 10)
    nbytes = (t * dm + vocab * dm) * elem + t * 4 + 2 * t * 4
    flops = 2 * t * dm * vocab
    row = _row("fused_xent", "src/repro_torch/kernels/csrc/fused_xent.cu",
               "src/repro/kernels/fused_xent.py:85", launches, errs, ms, plain_ms, lib_ms,
               nbytes, flops, "bfloat16")
    kern = lambda a, b, c: fused_xent(a, b, c)   # noqa: E731
    lib = lambda a, b, c: F.cross_entropy(a @ b, c, reduction="none")   # noqa: E731
    row.update({"device_ms": _graph_ms(kern, sets, 5),
                "device_queued_ms": _queued_ms(kern, sets, 10),
                "library_device_ms": _graph_ms(lib, sets, 5),
                "library_device_queued_ms": _queued_ms(lib, sets, 10)})
    out.append(row)
    return out


# ---------------------------------------------------------------------------
# Phase 3, the dequant kernel
# ---------------------------------------------------------------------------

QUANT_MICRO = 8                              # --microbatches of the quantized runs
FULL_ROW = 50_335_744                        # elements of one qwen3-1.7b layer row


def _quant_plan(pool_dtype="int8", n_layers=None):
    from repro_torch.core.plan import plan_from_config
    from repro_torch.models.config import get_config
    cfg = get_config(ARCH)
    if n_layers is not None:
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return cfg, plan_from_config(cfg, TRAIN_WORKERS, pool_dtype=pool_dtype)


def _dequant_inputs(rows, elems, packed, fill, gen):
    """codes and fp32 scales of ``rows`` rows of ``elems`` elements (a
    multiple of 256): random codes and scales, every code value, all-zero
    blocks, or the codes of random weights."""
    import torch
    from repro_torch.kernels.dequant import QUANT_BLOCK, quantize_rows
    nb = elems // QUANT_BLOCK
    cols = elems // 2 if packed else elems
    if fill == "weights":
        return quantize_rows(torch.randn((rows, elems), generator=gen, device=DEVICE),
                             bits=4 if packed else 8)
    if fill == "zeros":
        x = torch.randn((rows, elems), generator=gen, device=DEVICE)
        x.view(rows, nb, QUANT_BLOCK)[:, ::2] = 0.0
        return quantize_rows(x, bits=4 if packed else 8)
    if fill == "every":
        codes = torch.arange(rows * cols, device=DEVICE).remainder(256).reshape(rows, cols)
        codes = codes.to(torch.uint8) if packed else (codes - 128).to(torch.int8)
    else:
        lo, hi = (0, 256) if packed else (-128, 128)
        codes = torch.randint(lo, hi, (rows, cols), generator=gen, device=DEVICE,
                              dtype=torch.int16).to(torch.uint8 if packed else torch.int8)
    scales = torch.rand((rows, nb), generator=gen, device=DEVICE) * 0.05 + 1e-4
    return codes, scales


def dequant_cases():
    """(label, rows, elements, fill): the training shape (the largest slot's
    rows of a qwen3-1.7b layer row), one row of one block, ragged row and
    block counts, all-zero blocks, every code value, and the codes of random
    weights. Each runs for int8 and int4 codes, fp32 and bf16 output."""
    _, p = _quant_plan()
    return [("training", p.max_block, FULL_ROW, "random"),
            ("one-block", 1, 256, "random"),
            ("ragged-3x5", 3, 5 * 256, "random"),
            ("ragged-7x133", 7, 133 * 256, "random"),
            ("ragged-130x3", 130, 3 * 256, "random"),
            ("zero-blocks", 5, 64 * 256, "zeros"),
            ("every-code", 4, 256 * 256, "every"),
            ("weights", 3, 4096 * 256, "weights")]


def phase_dequant_kernel():
    """``dequant_rows`` against its plain version at atol 0."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant import dequant_rows
    gen = torch.Generator(device=DEVICE).manual_seed(8)
    n = 0
    for label, rows, elems, fill in dequant_cases():
        for packed in (False, True):
            codes, scales = _dequant_inputs(rows, elems, packed, fill, gen)
            plain = ref.dequant_rows_ref(codes, scales)
            for dtype in (torch.float32, torch.bfloat16):
                got = dequant_rows(codes, scales, out_dtype=dtype)
                torch.cuda.synchronize()
                want = plain.to(dtype)
                err = (got.float() - want.float()).abs().max().item()
                check(got.dtype == dtype and got.shape == want.shape and torch.equal(got, want),
                      f"dequant_rows[{label}, {'int4' if packed else 'int8'} -> "
                      f"{dtype_name(dtype)}]: max abs err {err:.3e}, not bit-exact")
                n += 1
                del got, want
            del codes, scales, plain
    torch.cuda.empty_cache()
    print(f"kernels vs plain: dequant_rows {n} cases (int8 and int4, fp32 and bf16 out), "
          "all bit-exact (atol 0)")
    return {"dequant_rows": 0.0, "dequant_rows@main": 0.0}


# ---------------------------------------------------------------------------
# Phase 3, the scan kernels: rwkv_scan and ssm_scan
# ---------------------------------------------------------------------------

SCAN_TOL = {"float32": 1e-4, "bfloat16": 2e-2}
RWKV_ARCH, RWKV_PROMPT = "rwkv6-7b", 1024
HYBRID_ARCH, HYBRID_PROMPT = "hymba-1.5b", 1536   # longer than its window of 1024


def _scan_compare(name, got, want, dtype) -> float:
    """|got - want| <= tol * |want| + tol * max|want| elementwise, tol 1e-4
    (fp32) or 2e-2 (bf16). Returns the max abs error."""
    import torch
    torch.cuda.synchronize()
    tol = SCAN_TOL[dtype_name(dtype)]
    g, w = got.float(), want.float()
    err = (g - w).abs()
    bound = tol * w.abs() + tol * w.abs().max()
    worst = err.max().item() if err.numel() else 0.0
    check(got.shape == want.shape and bool((err <= bound).all()),
          f"{name}: max abs err {worst:.3e} outside {tol} * (|want| + max|want|)")
    return worst


def _misaligned(t):
    """The same values in a contiguous tensor that starts 4 bytes past a
    16-byte boundary: the scans' scalar staging path, flash-decode's padded
    copies."""
    import torch
    flat = torch.empty(t.numel() + 4, dtype=t.dtype, device=t.device)
    out = flat[4 // t.element_size():][:t.numel()].view(t.shape)
    out.copy_(t)
    return out


EDGE_N = (1, 4, 17, 33, 64)   # state sizes on and off the kernels' widths of 16, 32, 64


def _edge_steps(chunk):
    """S = 1, one chunk - 1, one chunk + 1, two chunks + an odd number."""
    return (1, chunk - 1, chunk + 1, 2 * chunk + 7)


def rwkv_cases():
    """(label, B, S, H, N, dtype, decays, s0, layout): the prefill and decode
    shapes of rwkv6-7b (fp32, as the model calls it, and bf16), and a ragged
    sweep: N in {7, 16, 20, 64}, S not a multiple of the 32-step chunk, the
    model's decays (w in (0.99, 1)) and sigmoid ones, zero and random initial
    states, a misaligned layout; then the edges of the kernel's tiling: N in
    {1, 4, 17, 33, 64} at S = 1, one chunk - 1, one chunk + 1 and two chunks +
    7, in both types, and a single (batch, head) pair."""
    from repro_torch.kernels.rwkv_scan import geometry
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    from repro_torch.models.config import get_config
    cfg = get_config(RWKV_ARCH)
    h = cfg.d_model // 64
    cases = [("prefill", BATCH, RWKV_PROMPT, h, 64, f32, "model", "zeros", "dense"),
             ("prefill-bf16", BATCH, RWKV_PROMPT, h, 64, bf16, "model", "zeros", "dense"),
             ("decode", BATCH, 1, h, 64, f32, "model", "random", "dense"),
             ("decode-bf16", BATCH, 1, h, 64, bf16, "model", "random", "dense")]
    for dtype in (f32, bf16):
        for s, hh, n, decays in [(77, 3, 16, "sigmoid"), (200, 2, 64, "sigmoid"),
                                 (45, 5, 16, "model"), (33, 2, 20, "sigmoid"),
                                 (70, 3, 7, "model")]:
            cases.append((f"sweep-s{s}-h{hh}-n{n}-{decays}-{dtype_name(dtype)}", 2, s, hh, n,
                          dtype, decays, "random", "dense"))
        cases.append((f"misaligned-{dtype_name(dtype)}", 2, 50, 3, 64, dtype, "sigmoid",
                      "random", "misaligned"))
    for n in EDGE_N:
        for i, s in enumerate(_edge_steps(geometry(n)[1])):
            for dtype in (f32, bf16):
                cases.append((f"edge-n{n}-s{s}-{dtype_name(dtype)}", 2, s, 3, n, dtype,
                              ("sigmoid", "model")[i % 2], "random", "dense"))
    for dtype in (f32, bf16):
        cases.append((f"single-bh-{dtype_name(dtype)}", 1, 2 * geometry(64)[1] + 7, 1, 64,
                      dtype, "sigmoid", "random", "dense"))
    return cases


def _rwkv_inputs(b, s, h, n, dtype, decays, s0_kind, layout, gen):
    import torch
    r, k, v = (_rand((b, s, h, n), dtype, gen) for _ in range(3))
    z = torch.randn((b, s, h, n), generator=gen, device=DEVICE)
    w = (torch.exp(-torch.exp(-6.0 + 0.6 * z)) if decays == "model" else torch.sigmoid(z))
    w = w.to(dtype)
    u = torch.randn((h, n), generator=gen, device=DEVICE)
    s0 = (torch.zeros((b, h, n, n), device=DEVICE) if s0_kind == "zeros"
          else torch.randn((b, h, n, n), generator=gen, device=DEVICE))
    if layout == "misaligned":
        r, k, v, w = (_misaligned(t) for t in (r, k, v, w))
    return r, k, v, w, u, s0


def ssm_cases():
    """(label, B, S, Di, N, dtype, out dtype, h0, layout): the prefill and
    decode shapes of hymba-1.5b (bf16 in and fp32 y, as the model calls it;
    and fp32), and a ragged sweep: N in {7, 16, 64}, S not a multiple of the
    64-step chunk, d_inner 3200 (not a multiple of the Pallas block_d of
    256) and small ragged ones, y in x's type, a misaligned layout; then the
    edges of the kernel's tiling: N in {1, 4, 17, 33, 64} at S = 1, one chunk
    - 1, one chunk + 1 and two chunks + 7, in both types, d_inner 1, 31, 3201
    and 32 in turn (32 takes the 16-byte copies where N allows them), y in
    fp32 and in x's type in turn."""
    from repro_torch.kernels.ssm_scan import geometry
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    from repro_torch.models.config import get_config
    cfg = get_config(HYBRID_ARCH)
    di, n = cfg.d_inner, cfg.ssm_state
    cases = [("prefill", BATCH, HYBRID_PROMPT, di, n, bf16, f32, "zeros", "dense"),
             ("prefill-f32", BATCH, HYBRID_PROMPT, di, n, f32, f32, "zeros", "dense"),
             ("decode", BATCH, 1, di, n, bf16, f32, "random", "dense"),
             ("decode-f32", BATCH, 1, di, n, f32, f32, "random", "dense")]
    for dtype in (f32, bf16):
        for s, d_in, nn in [(77, di, 64), (130, 100, 16), (65, 33, 7), (200, 3200, 16)]:
            cases.append((f"sweep-s{s}-di{d_in}-n{nn}-{dtype_name(dtype)}", 2, s, d_in, nn,
                          dtype, dtype, "random", "dense"))
        cases.append((f"misaligned-{dtype_name(dtype)}", 2, 70, 96, 16, dtype, f32, "random",
                      "misaligned"))
    for n in EDGE_N:
        for i, s in enumerate(_edge_steps(geometry(n)[1])):
            d_in = (1, 31, 3201, 32)[i]
            for dtype in (f32, bf16):
                out = (f32, dtype)[i % 2]
                cases.append((f"edge-n{n}-s{s}-di{d_in}-{dtype_name(dtype)}-{dtype_name(out)}",
                              2, s, d_in, n, dtype, out, "random", "dense"))
    return cases


def _ssm_inputs(b, s, di, n, dtype, h0_kind, layout, gen):
    import torch
    import torch.nn.functional as F
    x = _rand((b, s, di), dtype, gen)
    dt = F.softplus(torch.randn((b, s, 1), generator=gen, device=DEVICE)).to(dtype)
    bm, cm = (_rand((b, s, n), dtype, gen) for _ in range(2))
    a = -torch.exp(0.5 * torch.randn((di, n), generator=gen, device=DEVICE))
    h0 = (torch.zeros((b, di, n), device=DEVICE) if h0_kind == "zeros"
          else torch.randn((b, di, n), generator=gen, device=DEVICE))
    if layout == "misaligned":
        x, dt, bm, cm = (_misaligned(t) for t in (x, dt, bm, cm))
    return x, dt, bm, cm, a, h0


def phase_scan_kernels():
    """``rwkv_scan`` and ``ssm_scan`` against their plain versions: y and the
    final state, at fp32 1e-4 and bf16 2e-2 (relative, plus the same share
    of the largest value)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv_scan import rwkv_scan
    from repro_torch.kernels.ssm_scan import ssm_scan
    gen = torch.Generator(device=DEVICE).manual_seed(12)
    errs = {}
    for label, b, s, h, n, dtype, decays, s0k, layout in rwkv_cases():
        args = _rwkv_inputs(b, s, h, n, dtype, decays, s0k, layout, gen)
        y, s_t = rwkv_scan(*args)
        ry, rs = ref.rwkv_scan_ref(*args)
        check(y.dtype == dtype and s_t.dtype == torch.float32, f"rwkv_scan[{label}]: dtypes")
        errs[("rwkv_scan", label)] = max(_scan_compare(f"rwkv_scan[{label}] y", y, ry, dtype),
                                         _scan_compare(f"rwkv_scan[{label}] S_T", s_t, rs,
                                                       dtype))
        del args, y, s_t, ry, rs
    for label, b, s, di, n, dtype, out_dtype, h0k, layout in ssm_cases():
        args = _ssm_inputs(b, s, di, n, dtype, h0k, layout, gen)
        y, h_t = ssm_scan(*args, out_dtype=out_dtype)
        ry, rh = ref.ssm_scan_ref(*args, out_dtype=out_dtype)
        check(y.dtype == out_dtype and h_t.dtype == torch.float32, f"ssm_scan[{label}]: dtypes")
        errs[("ssm_scan", label)] = max(_scan_compare(f"ssm_scan[{label}] y", y, ry, dtype),
                                        _scan_compare(f"ssm_scan[{label}] h_T", h_t, rh, dtype))
        del args, y, h_t, ry, rh
    torch.cuda.empty_cache()
    for name in ("rwkv_scan", "ssm_scan"):
        mine = {label: e for (k, label), e in errs.items() if k == name}
        print(f"kernels vs plain: {name} {len(mine)} cases, prefill err {mine['prefill']:.3e}, "
              f"decode err {mine['decode']:.3e}, worst {max(mine.values()):.3e}")
    return _err_summary(errs, "prefill", extra=("decode",))


# ---------------------------------------------------------------------------
# Phase 4a: the scans' backward kernels
# ---------------------------------------------------------------------------

SCAN_BWD_TRAIN = {"rwkv": (2, 1024, 64, 64), "ssm": (2, 1536, 3200, 16)}   # training micro-batch


def _scan_bwd_compare(name, got, want, dtype) -> tuple[float, float]:
    """The relative norm |got - want| / |want| within 1e-4 (fp32) or 2e-2
    (bf16); a zero ``want`` asks for |got| within the same share of 1.
    Returns (max abs err, relative norm)."""
    import torch
    torch.cuda.synchronize()
    tol = SCAN_TOL[dtype_name(dtype)]
    g, w = got.float(), want.float()
    err = (g - w).abs().max().item() if w.numel() else 0.0
    rel = ((g - w).norm() / w.norm().clamp_min(1.0 if w.norm() == 0 else 1e-30)).item()
    check(got.shape == want.shape and got.dtype == want.dtype and math.isfinite(rel)
          and rel <= tol, f"{name}: relative error {rel:.3e} above {tol} ({got.dtype} "
          f"{tuple(got.shape)} vs {want.dtype} {tuple(want.shape)})")
    return err, rel


def rwkv_bwd_cases():
    """(label, B, S, H, N, dtype, decays, s0, layout): rwkv6-7b's training
    micro-batch (fp32, as the model calls it, and bf16); then the forward's
    edge sweep at the backward's chunk of 32: N in {1, 4, 17, 33, 64} at S =
    1, 31, 33 and 71, decays near 1 (the model's), sigmoid and near 0 in
    turn, random s0 and dS_T, both types; a misaligned layout; one (batch,
    head)."""
    import torch
    from repro_torch.kernels.rwkv_scan import bwd_geometry
    f32, bf16 = torch.float32, torch.bfloat16
    b, s, h, n = SCAN_BWD_TRAIN["rwkv"]
    cases = [("train", b, s, h, n, f32, "model", "zeros", "dense"),
             ("train-bf16", b, s, h, n, bf16, "model", "zeros", "dense")]
    decays = ("model", "sigmoid", "near0")
    for n_ in EDGE_N:
        for i, s_ in enumerate(_edge_steps(bwd_geometry(n_)[1])):
            for dtype in (f32, bf16):
                cases.append((f"edge-n{n_}-s{s_}-{dtype_name(dtype)}", 2, s_, 3, n_, dtype,
                              decays[i % 3], "random", "dense"))
    for dtype in (f32, bf16):
        cases.append((f"misaligned-{dtype_name(dtype)}", 2, 50, 3, 64, dtype, "sigmoid",
                      "random", "misaligned"))
        cases.append((f"single-bh-{dtype_name(dtype)}", 1, 71, 1, 64, dtype, "near0",
                      "random", "dense"))
        chunk = bwd_geometry(64)[1]
        # the chunks' edges: S below one chunk, exactly one, 129 chunks at one
        # (batch, head), and a chunk whose decays are all exactly 0
        for label, b_, s_, h_, kind in (("below-chunk", 2, chunk - 12, 3, "sigmoid"),
                                        ("one-chunk", 2, chunk, 3, "model"),
                                        ("many-chunks", 1, 128 * chunk + 1, 1, "model"),
                                        ("zero-chunk", 2, 2 * chunk + 7, 3, "zero-chunk")):
            if label != "many-chunks" or dtype == f32:   # 4097 plain steps: fp32 only
                cases.append((f"{label}-{dtype_name(dtype)}", b_, s_, h_, 64, dtype, kind,
                              "random", "dense"))
    return cases


def ssm_bwd_cases():
    """(label, B, S, Di, N, dtype, h0, a, layout): hymba-1.5b's training
    micro-batch (bf16 x, dt, B, C and fp32 dy, as the model calls it; and
    fp32); then the forward's edge sweep at the backward's chunk of 32: N in
    {1, 4, 17, 33, 64} at S = 1, 31, 33 and 71 with d_inner 1, 31, 3201 and 32
    in turn, decays near 1, random and near 0 in turn, random h0 and dh_T,
    both types; a misaligned layout."""
    import torch
    from repro_torch.kernels.ssm_scan import bwd_geometry
    from repro_torch.models.config import get_config
    f32, bf16 = torch.float32, torch.bfloat16
    b, s, di, n = SCAN_BWD_TRAIN["ssm"]
    cfg = get_config(HYBRID_ARCH)
    assert (di, n) == (cfg.d_inner, cfg.ssm_state)
    cases = [("train", b, s, di, n, bf16, "zeros", "random", "dense"),
             ("train-f32", b, s, di, n, f32, "zeros", "random", "dense")]
    decays = ("near1", "random", "near0")
    for n_ in EDGE_N:
        for i, s_ in enumerate(_edge_steps(bwd_geometry(n_)[1])):
            for dtype in (f32, bf16):
                cases.append((f"edge-n{n_}-s{s_}-di{(1, 31, 3201, 32)[i]}-{dtype_name(dtype)}",
                              2, s_, (1, 31, 3201, 32)[i], n_, dtype, "random", decays[i % 3],
                              "dense"))
    for dtype in (f32, bf16):
        cases.append((f"misaligned-{dtype_name(dtype)}", 2, 70, 96, 16, dtype, "random",
                      "random", "misaligned"))
        chunk = bwd_geometry(16)[1]
        # the chunks' edges: S below one chunk, exactly one, 129 chunks at one
        # batch row, and a chunk whose decays are all exactly 0
        for label, b_, s_, di_, kind in (("below-chunk", 2, chunk - 12, 96, "random"),
                                         ("one-chunk", 2, chunk, 96, "near1"),
                                         ("many-chunks", 1, 128 * chunk + 1, 32, "random"),
                                         ("zero-chunk", 2, 2 * chunk + 7, 96, "zero-chunk")):
            if label != "many-chunks" or dtype == f32:   # 4097 plain steps: fp32 only
                cases.append((f"{label}-{dtype_name(dtype)}", b_, s_, di_, 16, dtype,
                              "random", kind, "dense"))
    return cases


def _rwkv_bwd_inputs(b, s, h, n, dtype, decays, s0_kind, layout, gen):
    """The forward's inputs (``near0``: w = exp(-exp(3 + 0.6 z)), most of them
    0 in fp32; ``zero-chunk``: the model's decays, and w exactly 0 over the
    second chunk of the backward), and dy in the inputs' type and a random
    fp32 dS_T."""
    import torch
    from repro_torch.kernels.rwkv_scan import bwd_geometry
    kind = "model" if decays in ("near0", "zero-chunk") else decays
    r, k, v, w, u, s0 = _rwkv_inputs(b, s, h, n, dtype, kind, s0_kind, layout, gen)
    if decays == "zero-chunk":
        chunk = bwd_geometry(n)[1]
        w[:, chunk:2 * chunk] = 0
    if decays == "near0":
        z = torch.randn((b, s, h, n), generator=gen, device=DEVICE)
        w = torch.exp(-torch.exp(3.0 + 0.6 * z)).to(dtype)
        if layout == "misaligned":
            w = _misaligned(w)
    dy = _rand((b, s, h, n), dtype, gen)
    if layout == "misaligned":
        dy = _misaligned(dy)
    ds_t = torch.randn((b, h, n, n), generator=gen, device=DEVICE)
    return (r, k, v, w, u, s0), dy, ds_t


def _ssm_bwd_inputs(b, s, di, n, dtype, h0_kind, decays, layout, gen):
    """The forward's inputs with A scaled for decays near 1 (|A| ~ 1e-3),
    random (|A| ~ 1) or near 0 (|A| ~ 50: e^(dt A) underflows); ``zero-chunk``:
    random A, and dt = 1000 over the second chunk of the backward, where
    every e^(dt A) is exactly 0 in fp32. An fp32 dy and dh_T."""
    import torch
    from repro_torch.kernels.ssm_scan import bwd_geometry
    x, dt, bm, cm, a, h0 = _ssm_inputs(b, s, di, n, dtype, h0_kind, layout, gen)
    a = a * {"near1": 1e-3, "random": 1.0, "near0": 50.0, "zero-chunk": 1.0}[decays]
    if decays == "zero-chunk":
        chunk = bwd_geometry(n)[1]
        dt[:, chunk:2 * chunk] = 1000.0
    dy = torch.randn((b, s, di), generator=gen, device=DEVICE)
    dh_t = torch.randn((b, di, n), generator=gen, device=DEVICE)
    return (x, dt, bm, cm, a, h0), dy, dh_t


def _autograd_grads(fn, args, cotangents):
    """The gradients of sum(out * cotangent) over ``fn``'s outputs with
    respect to every argument, by autograd of ``fn`` (the plain forward)."""
    import torch
    leaves = [a.detach().clone().requires_grad_() for a in args]
    with torch.enable_grad():
        outs = fn(*leaves)
        total = sum((o.float() * c.float()).sum() for o, c in zip(outs, cotangents))
        return torch.autograd.grad(total, leaves)


def phase_scan_bwd_kernels():
    """``rwkv_scan_bwd`` and ``ssm_scan_bwd`` against their plain backwards
    (``ref.*_bwd_ref``) and against autograd of the plain forwards, every
    gradient by the relative norm: fp32 1e-4, bf16 2e-2; at the training
    shapes also a second call, which must return the same bits."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv_scan import rwkv_scan_bwd
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd
    gen = torch.Generator(device=DEVICE).manual_seed(25)
    errs, rels = {}, {}
    names = {"rwkv_scan_bwd": ("dr", "dk", "dv", "dw", "du", "ds0"),
             "ssm_scan_bwd": ("dx", "ddt", "dB", "dC", "da", "dh0")}
    for kernel, cases, inputs, plain, fwd in (
            ("rwkv_scan_bwd", rwkv_bwd_cases(), _rwkv_bwd_inputs, ref.rwkv_scan_bwd_ref,
             ref.rwkv_scan_ref),
            ("ssm_scan_bwd", ssm_bwd_cases(), _ssm_bwd_inputs, ref.ssm_scan_bwd_ref,
             lambda *a: ref.ssm_scan_ref(*a, out_dtype=torch.float32))):
        run = rwkv_scan_bwd if kernel == "rwkv_scan_bwd" else ssm_scan_bwd
        for label, *shape in cases:
            args, dy, d_state = inputs(*shape, gen)
            dtype = args[0].dtype
            got = run(*args, dy, d_state)
            if label.startswith("train"):   # no atomics: a second call repeats every bit
                again = run(*args, dy, d_state)
                check(all(torch.equal(a, b) for a, b in zip(got, again)),
                      f"{kernel}[{label}]: two calls on the same inputs differ")
                del again
            want = plain(*args, dy, d_state)
            auto = _autograd_grads(fwd, args, (dy, d_state))
            worst, worst_rel = 0.0, 0.0
            for gname, g, w, a in zip(names[kernel], got, want, auto):
                e, r = _scan_bwd_compare(f"{kernel}[{label}] {gname} vs plain", g, w, dtype)
                _, ra = _scan_bwd_compare(f"{kernel}[{label}] {gname} vs autograd", g,
                                          a.to(w.dtype), dtype)
                worst, worst_rel = max(worst, e), max(worst_rel, r, ra)
            errs[(kernel, label)] = worst
            rels[(kernel, label)] = worst_rel
            del args, dy, d_state, got, want, auto
        torch.cuda.empty_cache()
        mine = {label: e for (k, label), e in rels.items() if k == kernel}
        f32 = {label: e for label, e in mine.items() if "bfloat16" not in label
               and label not in ("train-bf16", "train")}
        f32["train"] = mine["train"]
        worst32 = max(f32, key=f32.get)
        print(f"backward kernels vs plain and autograd: {kernel} {len(mine)} cases, training "
              f"shape rel {mine['train']:.3e}, worst rel {max(mine.values()):.3e}, worst fp32 "
              f"case {worst32} rel {f32[worst32]:.3e}")
    return _err_summary(errs, "train")


RWKV_TRAIN_LAYERS = 8   # rwkv6-7b's 32 layers cut to 8: ~2.3 B parameters, ~37 GB with AdamW
RECURRENT_RING_LAYERS = {RWKV_ARCH: 2, HYBRID_ARCH: 4}   # depth of the fp32 ring checks


def phase_recurrent_train():
    """Train the recurrent families through the launcher (``--mesh 1x4
    --partition auto --batch 8``, AdamW, one round, prefetch on):
    hymba-1.5b at full depth (32 layers, ``--seq 1536``, past its window of
    1024) and rwkv6-7b at ``RWKV_TRAIN_LAYERS`` of 32 (``--seq 1024``), the
    counts of every training kernel (the scans' forward and backward, flash
    for hymba's attention, the cross-entropy) set to 0 just before and held
    against the plan just after; then 3 steps of a fresh state on a repeated
    batch, the middle one traced (slot kinds, the scans' and attention's
    device ms): finite losses that fall, step ms and peak memory; then each
    family's fp32 ring against its single program (the plain versions) at
    full width, rwkv6-7b at 2 layers and hymba-1.5b at 4: loss rtol 1e-4,
    worst relative grad error 5e-3."""
    import torch
    out, launches = {}, {}
    for arch, layers, seq in ((HYBRID_ARCH, None, HYBRID_PROMPT),
                              (RWKV_ARCH, RWKV_TRAIN_LAYERS, RWKV_PROMPT)):
        name = _cut_arch(arch, n_layers=layers) if layers else arch
        run, run_launches, peak = phase_train(name, seq)
        losses, times, traced = phase_repeated_batch(run, name, seq)
        ring = _ring_vs_single("float32", arch, n_layers=RECURRENT_RING_LAYERS[arch])
        check(ring["loss_rel"] <= 1e-4, f"{arch} ring loss disagrees with the single program")
        check(ring["worst_rel"] < 5e-3, f"{arch} ring grads disagree with the single program")
        warm = sorted(run["step_s"][1:] + times)
        out[name] = {"launches": run_launches, "peak_memory_gb": peak / 1e9,
                     "plan": run["plan"].describe(), "seq": seq,
                     "train_run_step_ms": [x * 1e3 for x in run["step_s"]],
                     "losses": run["losses"], "repeated_batch_losses": losses,
                     "repeated_batch_step_ms": [x * 1e3 for x in times],
                     "warm_step_ms_median": warm[len(warm) // 2] * 1e3,
                     "warm_tok_per_s": TRAIN_BATCH * seq / warm[len(warm) // 2],
                     "traced_step": traced,
                     f"ring_vs_single_fp32_{RECURRENT_RING_LAYERS[arch]}_layers": ring}
        for k, n in run_launches.items():
            launches[k] = launches.get(k, 0) + n
        del run
        gc.collect()
        torch.cuda.empty_cache()
        print(f"recurrent train ({name}) " + json.dumps(out[name]))
    return out, launches


def phase_scan_bwd_timings(errs, launches):
    """Each backward kernel at the training micro-batch its family's ring
    gives it (``SCAN_BWD_TRAIN``), cold inputs, by CUDA events and by a
    replayed CUDA graph of the calls (device ms), beside its bound and its
    plain backward. Bound: the inputs read once and the outputs written once
    at the HBM rate (the checkpoints and partials are the kernel's own
    traffic, not the function's), against the operations at the fp32 rate,
    each exponential counted as one operation; no single PyTorch call
    computes either backward."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv_scan import rwkv_scan_bwd
    from repro_torch.kernels.ssm_scan import ssm_scan_bwd
    gen = torch.Generator(device=DEVICE).manual_seed(26)
    rows = []
    for name, run, plain, inputs, shape in (
            ("rwkv_scan_bwd", rwkv_scan_bwd, ref.rwkv_scan_bwd_ref, _rwkv_bwd_inputs,
             SCAN_BWD_TRAIN["rwkv"]),
            ("ssm_scan_bwd", ssm_scan_bwd, ref.ssm_scan_bwd_ref, _ssm_bwd_inputs,
             SCAN_BWD_TRAIN["ssm"])):
        if name == "rwkv_scan_bwd":
            b, s, h, n = shape
            sets = [(*args, dy, None) for args, dy, _ in
                    (_rwkv_bwd_inputs(b, s, h, n, torch.float32, "model", "zeros", "dense", gen)
                     for _ in range(3))]
            elems = b * s * h * n
            # r, k, v, w, dy read and dr, dk, dv, dw written (fp32); u, du; s0, ds0
            nbytes = 9 * elems * 4 + 2 * h * n * 4 + 2 * b * h * n * n * 4
            # what the function needs, an FMA counted as 2: per (b, t, h, i, j)
            # the forward state once more (2), G's update (2), G v for dk (2),
            # G^T k for dv (2), rowsum(G S) for dw (2) and S dy for dr (2): 12
            # N^2. The u terms are O(N) in the function's own formulas: per
            # (b, t, h) v . dy (2 N), u k and u r (2 N), their products with
            # v . dy into dr and dk (4 N), sum r u k (2 N) times dy into dv
            # (2 N) and r k (v . dy) into du (2 N): 14 N. At the training
            # micro-batch that is 6.6 GFLOP; the kernel also forms each chunk's
            # L and M from zero (4 N^2) and replays each sub-chunk's states
            # once more (2 N^2), which the bound does not count.
            flops = b * s * h * (12 * n * n + 14 * n)
            label = f"B={b}, S={s}, H={h}, N={n}, fp32"
        else:
            b, s, di, n = shape
            sets = [(*args, dy, None) for args, dy, _ in
                    (_ssm_bwd_inputs(b, s, di, n, torch.bfloat16, "zeros", "random", "dense",
                                     gen) for _ in range(3))]
            # x, dx (bf16), dy (fp32); dt, B, C and their gradients (bf16); A,
            # dA, h0, dh0 (fp32)
            nbytes = (b * s * di * (2 + 2 + 4) + 2 * b * s * (1 + 2 * n) * 2 + 2 * di * n * 4
                      + 2 * b * di * n * 4)
            # per (b, t, d, n): the decay (an exponential and a product), h_t
            # (2), g_t (2), dx's g B (2), dB's g dt x (1), dC's dy h (1), ddt's
            # g (A e h + x B) (4), dA's g dt e h (3), g's carry (1): 18; per
            # (b, t, d): dt x, dt * the dx sum
            flops = b * s * di * (18 * n + 2)
            label = f"B={b}, S={s}, Di={di}, N={n}, bf16 in, fp32 dy"
        ms = _time_ms(run, sets, 5)
        device_ms = _graph_ms(run, sets, 2)
        plain_ms = _time_ms(plain, sets[:1], 1)
        scan = ("_rwkv_recurrence, src/repro/models/ssm.py:147" if name == "rwkv_scan_bwd"
                else "the lax.scan of _mamba_inner, src/repro/models/ssm.py:66")
        row = _row(name, f"src/repro_torch/kernels/csrc/{name}.cu",
                   f"none (the reference differentiates its jnp scan, {scan})",
                   launches, errs, ms, plain_ms, None, nbytes, flops, "float32")
        row.update({"shape": label, "device_ms": device_ms,
                    "library_note": "none: no single PyTorch call computes this backward"})
        rows.append(row)
        del sets
        torch.cuda.empty_cache()
    print("scan backward timings " + json.dumps(rows))
    return rows


# ---------------------------------------------------------------------------
# Phase 4b: serving the recurrent families, rwkv6-7b and hymba-1.5b
# ---------------------------------------------------------------------------

def _serve_counters():
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.kernels.rwkv_scan import rwkv_scan
    from repro_torch.kernels.ssm_scan import ssm_scan
    return {"flash_attention": flash_attention, "decode_attention": decode_attention,
            "rwkv_scan": rwkv_scan, "ssm_scan": ssm_scan}


# bf16 decode-vs-prefill bars on the relative norm of the logits, at full
# depth, set from readings on the H100: above the sound runs (rwkv6-7b
# 1.90e-2 and 1.93e-2; hymba-1.5b 2.85e-2 to 4.34e-2, whose bf16 prefill lies
# ~0.2 from its fp32 one) and below a lost recurrent state (1.02 and 0.98).
# Smaller faults drown in hymba's bf16 noise (its ring one slot out of phase
# read 7.2e-2, its state rounded through bf16 4.0e-2), so the bf16 bar is
# gated on the lost state only and every fault is held by the fp32 check.
BF16_DECODE_BAR = {"rwkv6": 3e-2, "hybrid": 6e-2}
BF16_GATED_FAULTS = ("state_zeroed",)


def _decode_faults(cfg):
    """Decode-side faults, each injected into a fresh prefill cache:
    the recurrent state rounded through bf16 (what a bf16 state cache would
    do), the recurrent state lost, and (hybrid) the attention ring one slot
    out of phase."""
    faults = ["state_bf16", "state_zeroed"]
    return faults + ["ring_shifted"] if cfg.block_kind == "hybrid" else faults


def _inject(fault, cache, cfg):
    import torch
    state = cache["rwkv"]["time_s"] if cfg.block_kind == "rwkv6" else cache["ssm_h"]
    with torch.inference_mode():   # the serving steps' caches are inference tensors
        if fault == "state_bf16":
            state.copy_(state.to(torch.bfloat16).float())
        elif fault == "state_zeroed":
            state.zero_()
        elif fault == "ring_shifted":
            for name in ("k", "v"):
                cache[name].copy_(torch.roll(cache[name], 1, dims=2))


def phase_serve_recurrent(arch, prompt):
    """Serve full-width ``arch`` (bf16, random weights from a seeded
    ``torch.Generator``; batch 4, ``prompt`` tokens, 32 greedy tokens)
    through ``serve.main`` with the counts set to 0 just before and read just
    after; check the counts, finite logits, and that a decode step's logits
    match a prefill of the prefix one token longer (bf16 on the relative
    norm; fp32 elementwise at full width and 2 layers, across hymba's ring
    wrap). Then time prefill and decode, trace four decode steps, and time
    each scan at the prefill and decode shapes beside its bound and its plain
    version."""
    import torch
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models import transformer as T
    from repro_torch.models.config import get_config

    cfg = get_config(arch)
    counters = _serve_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    served = serve.main(["--arch", arch, "--batch", str(BATCH), "--prompt-len", str(prompt),
                         "--gen", str(GEN), "--device", DEVICE])
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    per_run = cfg.n_layers * (GEN + 1)   # one launch per layer in prefill and in each step
    if cfg.block_kind == "rwkv6":
        want = {"flash_attention": 0, "decode_attention": 0, "rwkv_scan": per_run,
                "ssm_scan": 0}
    else:
        want = {"flash_attention": cfg.n_layers, "decode_attention": cfg.n_layers * GEN,
                "rwkv_scan": 0, "ssm_scan": per_run}
    print(f"{arch} serve launches: {launches} (expected {want}), peak memory "
          f"{peak / 1e9:.2f} GB")
    check(launches == want, f"{arch} serve launches {launches} != {want}")
    check(all(bool(torch.isfinite(lg).all()) for lg in served.logits),
          f"{arch}: non-finite logits")
    check(tuple(served.tokens.shape) == (BATCH, GEN), f"tokens {tuple(served.tokens.shape)}")

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    # bf16: the decode step against the prefill one token longer, on the
    # relative norm, at a fixed bar per family (BF16_DECODE_BAR); beside it
    # the bf16 prefill's distance from an fp32 prefill of the same weights
    # (the model's bf16 noise, not a gate), and faulted controls: the same
    # decode step from a cache with one decode-side fault each.
    prefix = torch.cat([served.prompts, served.tokens[:, :1]], dim=1)
    got = served.logits[1]
    want_logits, _ = build_prefill_step(cfg, prompt + 1)(served.params, {"tokens": prefix})
    truth, _ = build_prefill_step(cfg, prompt + 1)(_cast(served.params, torch.float32),
                                                   {"tokens": prefix})
    torch.cuda.empty_cache()
    bf16_rel, floor = rel(got, want_logits), rel(want_logits, truth)
    bar = BF16_DECODE_BAR[cfg.block_kind]
    print(f"{arch} decode vs prefill, bf16, {cfg.n_layers} layers: relative error "
          f"{bf16_rel:.3e} (bar {bar:.3e}; max abs {(got - want_logits).abs().max().item():.3e}, "
          f"logits max abs {want_logits.abs().max().item():.2f}); vs fp32: decode "
          f"{rel(got, truth):.3e}, prefill {floor:.3e}; argmax agrees with fp32: decode "
          f"{(got.argmax(-1) == truth.argmax(-1)).float().mean().item():.2f}, prefill "
          f"{(want_logits.argmax(-1) == truth.argmax(-1)).float().mean().item():.2f}")
    check(bf16_rel <= bar, f"{arch}: bf16 decode logits disagree with the prefill of the "
                           "same prefix")
    del truth
    controls = {}
    for fault in _decode_faults(cfg):
        _, cache = build_prefill_step(cfg, prompt + GEN)(served.params,
                                                         {"tokens": served.prompts})
        _inject(fault, cache, cfg)
        faulted, _ = build_decode_step(cfg)(served.params, cache, served.tokens[:, 0])
        controls[fault] = rel(faulted, want_logits)
        del cache, faulted
    print(f"{arch} faulted controls, bf16 decode vs prefill (bar {bar:.3e}): "
          + json.dumps(controls))
    for fault, err in controls.items():
        if fault in BF16_GATED_FAULTS:
            check(err > bar, f"{arch}: the bf16 bar {bar:.3e} does not catch the fault "
                             f"{fault!r} ({err:.3e})")
    torch.cuda.empty_cache()

    # fp32, full width, 2 layers: the decode step against the prefill one
    # token longer, elementwise (hymba: a prompt past its window, so the
    # prefill rolls the ring and the decode step writes into a wrapped slot)
    cfg2 = dataclasses.replace(cfg, n_layers=2)
    gen = torch.Generator(device=DEVICE).manual_seed(13)
    p32 = T.init_params(cfg2, gen, dtype=torch.float32, device=DEVICE)
    p2 = prompt if cfg.block_kind == "hybrid" else 256
    toks = torch.randint(0, cfg2.vocab_size, (2, p2 + 1), generator=gen, device=DEVICE)
    _, cache = build_prefill_step(cfg2, p2 + 4)(p32, {"tokens": toks[:, :p2]})
    step_logits, _ = build_decode_step(cfg2)(p32, cache, toks[:, p2])
    want32, _ = build_prefill_step(cfg2, p2 + 1)(p32, {"tokens": toks})
    f32_err = (step_logits - want32).abs().max().item()
    check(torch.allclose(step_logits, want32, rtol=1e-4, atol=1e-4),
          f"{arch}: fp32 decode logits disagree with the prefill of the same prefix")
    f32_controls = {}
    for fault in _decode_faults(cfg2):   # each must break the 1e-4 bar
        _, fcache = build_prefill_step(cfg2, p2 + 4)(p32, {"tokens": toks[:, :p2]})
        _inject(fault, fcache, cfg2)
        faulted, _ = build_decode_step(cfg2)(p32, fcache, toks[:, p2])
        f32_controls[fault] = (faulted - want32).abs().max().item()
        check(not torch.allclose(faulted, want32, rtol=1e-4, atol=1e-4),
              f"{arch}: the fp32 bar does not catch the fault {fault!r}")
        del fcache, faulted
    print(f"{arch} decode vs prefill, fp32, 2 layers, prompt {p2}: max abs err {f32_err:.3e}; "
          f"faulted controls {json.dumps(f32_controls)}")
    del p32, cache

    # serving steps, warm, timed on the host around a synchronise
    prefill = build_prefill_step(cfg, prompt + GEN)
    decode = build_decode_step(cfg)
    batch = {"tokens": served.prompts}
    t_pre = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        logits, cache = prefill(served.params, batch)
        torch.cuda.synchronize()
        t_pre.append(time.perf_counter() - t0)
    tok = logits.argmax(-1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(GEN):
        logits, cache = decode(served.params, cache, tok)
        tok = logits.argmax(-1)
    torch.cuda.synchronize()
    t_dec = time.perf_counter() - t0
    logits, cache = prefill(served.params, batch)
    state = {"tok": logits.argmax(-1), "cache": cache}

    def step():
        lg, state["cache"] = decode(served.params, state["cache"], state["tok"])
        state["tok"] = lg.argmax(-1)

    traced = _trace(step, 4)
    timings = {"serve_run": {"prefill_ms": served.t_prefill * 1e3,
                             "decode_ms_per_token": served.t_decode * 1e3 / GEN},
               "warm": {"prefill_ms": sorted(t_pre)[1] * 1e3,
                        "prefill_tok_per_s": BATCH * prompt / sorted(t_pre)[1],
                        "decode_ms_per_token": t_dec * 1e3 / GEN,
                        "decode_tok_per_s": BATCH * GEN / t_dec},
               "traced_decode_step": traced, "peak_memory_gb": peak / 1e9,
               "decode_vs_prefill": {"bf16_rel": bf16_rel, "bf16_bar": bar,
                                     "bf16_prefill_vs_fp32_rel": floor,
                                     "faulted_controls": controls,
                                     "fp32_2_layers_max_abs": f32_err,
                                     "fp32_faulted_controls": f32_controls}}
    print(f"{arch} timings " + json.dumps(timings))
    del served, state, cache
    torch.cuda.empty_cache()
    return launches, timings


def _traced_per_call(timings, kernel, arch):
    """The kernel's device ms per call in the serving run's traced decode
    steps (one call per layer and step), or "not measured"."""
    from repro_torch.models.config import get_config
    traced = timings["traced_decode_step"]
    if not isinstance(traced, dict) or f"{kernel}_ms" not in traced:
        return "not measured: the trace holds no such kernel"
    return traced[f"{kernel}_ms"] / get_config(arch).n_layers


def _scan_row(name, source, replaces, launches, errs, ms, plain_ms, nbytes, flops, shapes):
    row = _row(name, source, replaces, launches, errs, ms["prefill"], plain_ms["prefill"], None,
               nbytes["prefill"], flops["prefill"], "float32")
    dec = _row(name, source, replaces, launches, errs, ms["decode"], plain_ms["decode"], None,
               nbytes["decode"], flops["decode"], "float32")
    row.update({"shape": shapes["prefill"], "decode_shape": shapes["decode"],
                "decode_ms": ms["decode"], "decode_plain_ms": plain_ms["decode"],
                "decode_bound_ms": dec["bound_ms"], "decode_bound_by": dec["bound_by"],
                "decode_shape_err": errs[f"{name}@decode"],
                "library_note": "none: no single PyTorch call computes this scan"})
    return row


def phase_scan_timings(errs, launches, recurrent):
    """Each scan at the shapes the main path gives it (prefill and one decode
    step), cold inputs, beside its bound and its plain version. Bound: the
    inputs read once and the outputs written once at the HBM rate, against
    the operations at the fp32 rate (the math is fp32; each exponential
    counted as one operation). At the decode shape the CUDA events time
    back-to-back calls that the host's launch path paces, so the row also
    gives the kernel's device time per call inside the traced decode steps
    of the serving run; at the prefill shape it also gives the device time
    by a replayed CUDA graph of the calls (``prefill_device_ms``)."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.rwkv_scan import rwkv_scan
    from repro_torch.kernels.ssm_scan import ssm_scan
    from repro_torch.models.config import get_config
    gen = torch.Generator(device=DEVICE).manual_seed(14)
    f32, bf16 = torch.float32, torch.bfloat16
    rows = []

    h, n = get_config(RWKV_ARCH).d_model // 64, 64
    ms, plain_ms, nbytes, flops, shapes = {}, {}, {}, {}, {}
    for kind, s in (("prefill", RWKV_PROMPT), ("decode", 1)):
        sets = [_rwkv_inputs(BATCH, s, h, n, f32, "model", "random", "dense", gen)
                for _ in range(4)]
        ms[kind] = _time_ms(rwkv_scan, sets, 10 if s > 1 else 50)
        if kind == "prefill":
            device_ms = _graph_ms(rwkv_scan, sets, 3)
        plain_ms[kind] = _time_ms(ref.rwkv_scan_ref, sets[:1], 2 if s > 1 else 10)
        elems = BATCH * s * h * n
        nbytes[kind] = 5 * elems * 4 + h * n * 4 + 2 * BATCH * h * n * n * 4
        # per (b, t, h): y is N^2 multiply-adds of r_i S[i, j] plus 3 N for
        # v_j sum_i r_i u_i k_i; the update a multiply and a multiply-add per
        # state entry: 5 N^2 + 3 N flops
        flops[kind] = BATCH * s * h * (5 * n * n + 3 * n)
        shapes[kind] = f"B={BATCH}, S={s}, H={h}, N={n}, fp32"
        del sets
    rows.append(_scan_row("rwkv_scan", "src/repro_torch/kernels/csrc/rwkv_scan.cu",
                          "src/repro/kernels/rwkv_scan.py:52", launches, errs, ms, plain_ms,
                          nbytes, flops, shapes))
    rows[-1]["prefill_device_ms"] = device_ms
    # the scalar staging path (misaligned inputs) beside the 16-byte one
    sets = [_rwkv_inputs(BATCH, RWKV_PROMPT, h, n, f32, "model", "random", "misaligned", gen)
            for _ in range(4)]
    rows[-1]["prefill_scalar_staging_ms"] = _time_ms(rwkv_scan, sets, 10)
    del sets
    rows[-1]["decode_device_ms_traced"] = _traced_per_call(recurrent[RWKV_ARCH], "rwkv_scan",
                                                           RWKV_ARCH)

    cfg = get_config(HYBRID_ARCH)
    di, n = cfg.d_inner, cfg.ssm_state
    ms, plain_ms, nbytes, flops, shapes = {}, {}, {}, {}, {}
    for kind, s in (("prefill", HYBRID_PROMPT), ("decode", 1)):
        sets = [_ssm_inputs(BATCH, s, di, n, bf16, "random", "dense", gen) for _ in range(4)]
        ms[kind] = _time_ms(lambda *a: ssm_scan(*a, out_dtype=f32), sets, 10 if s > 1 else 50)
        if kind == "prefill":
            device_ms = _graph_ms(lambda *a: ssm_scan(*a, out_dtype=f32), sets, 3)
        plain_ms[kind] = _time_ms(lambda *a: ref.ssm_scan_ref(*a, out_dtype=f32), sets[:1],
                                  2 if s > 1 else 10)
        # x, dt, B, C in bf16 and y in fp32; A, h0 and h_T in fp32
        nbytes[kind] = (BATCH * s * (di + 1 + 2 * n) * 2 + BATCH * s * di * 4 + di * n * 4
                        + 2 * BATCH * di * n * 4)
        # per (b, t, d, n): dt*a, exp, *h, dx*B, +, *C, +; per (b, t, d): dt*x
        flops[kind] = BATCH * s * di * (7 * n + 1)
        shapes[kind] = f"B={BATCH}, S={s}, Di={di}, N={n}, bf16 in, fp32 y"
        del sets
    rows.append(_scan_row("ssm_scan", "src/repro_torch/kernels/csrc/ssm_scan.cu",
                          "src/repro/kernels/ssm_scan.py:50", launches, errs, ms, plain_ms,
                          nbytes, flops, shapes))
    rows[-1]["prefill_device_ms"] = device_ms
    rows[-1]["decode_device_ms_traced"] = _traced_per_call(recurrent[HYBRID_ARCH], "ssm_scan",
                                                           HYBRID_ARCH)
    torch.cuda.empty_cache()
    print("scan kernel timings " + json.dumps(rows))
    return rows


def phase_hybrid_attention_timings(rows, errs):
    """Flash attention at hymba-1.5b's prefill shape (group 5, d_head 64,
    window 1024, bf16) and flash-decode over its full ring, beside their
    bounds, their plain versions and ``scaled_dot_product_attention``: extra
    ``hymba_*`` keys on the two serving kernels' rows."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    hy = _hybrid_attn()
    h, kh, d, w = hy["h"], hy["kh"], hy["d"], hy["window"]
    s = HYBRID_PROMPT
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    bf16, elem = torch.bfloat16, 2
    gqa = _sdpa_gqa()
    kw = {"enable_gqa": True} if gqa else {}
    by_name = {row["name"]: row for row in rows}

    def widen(k, v):
        return (k, v) if gqa else (k.repeat_interleave(h // kh, 1), v.repeat_interleave(h // kh, 1))

    def record(name, shape, ms, plain_ms, lib_ms, nbytes, flops, device):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        by_name[name].update({
            "hymba_shape": shape, "hymba_ms": ms, "hymba_plain_ms": plain_ms,
            "hymba_library_ms": lib_ms, "hymba_bound_ms": max(t_bytes, t_ops),
            "hymba_bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "hymba_err": errs[f"{name}@hymba"],
            **{f"hymba_{k}": v for k, v in device.items()}})

    # prefill: each query sees min(i + 1, window) keys
    sets = [_flash_inputs(BATCH, s, h, kh, d, d, bf16, "bshd", gen) for _ in range(4)]
    ms = _time_ms(lambda q, k, v: flash_attention(q, k, v, causal=True, sliding_window=w),
                  sets, 10)
    plain_ms = _time_ms(lambda q, k, v: ref.flash_attention_ref(q, k, v, causal=True,
                                                                sliding_window=w), sets[:2], 3)
    pos = torch.arange(s, device=DEVICE)
    mask = (pos[None, :] <= pos[:, None]) & (pos[None, :] > pos[:, None] - w)
    lib_sets = []
    for q, k, v in sets:
        q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
        lib_sets.append((q, *widen(k, v)))
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, **kw)  # noqa: E731
    lib_ms = _time_ms(sdpa, lib_sets, 10)
    pairs = sum(min(i + 1, w) for i in range(s))
    kern = lambda q, k, v: flash_attention(q, k, v, causal=True, sliding_window=w)  # noqa: E731
    record("flash_attention", f"B={BATCH}, S={s}, H={h}, KH={kh}, Dh={d}, window {w}, bf16",
           ms, plain_ms, lib_ms, (2 * BATCH * s * h * d + 2 * BATCH * s * kh * d) * elem,
           2 * BATCH * h * pairs * (d + d),
           {"device_ms": _graph_ms(kern, sets, 5), "library_device_ms": _graph_ms(sdpa, lib_sets, 5)})
    del sets, lib_sets

    # decode: one token over the full ring of `window` slots
    nv = torch.full((BATCH,), w, dtype=torch.int32, device=DEVICE)
    sets = [_decode_inputs(BATCH, w, h, kh, d, d, bf16, "dense", gen) for _ in range(8)]
    ms = _time_ms(lambda q, k, v: decode_attention(q, k, v, nv), sets, 20)
    plain_ms = _time_ms(lambda q, k, v: ref.decode_attention_ref(q, k, v, nv), sets, 5)
    lib_sets = [(q[:, :, None, :], *widen(k.transpose(1, 2).contiguous(),
                                          v.transpose(1, 2).contiguous()))
                for q, k, v in sets]
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(q, k, v, **kw)  # noqa: E731
    lib_ms = _time_ms(sdpa, lib_sets, 20)
    kern = lambda q, k, v: decode_attention(q, k, v, nv)   # noqa: E731
    record("decode_attention", f"B={BATCH}, ring {w}, H={h}, KH={kh}, Dh={d}, n_valid {w}, bf16",
           ms, plain_ms, lib_ms, (2 * BATCH * h * d + 2 * BATCH * w * kh * d) * elem + 4 * BATCH,
           2 * BATCH * h * w * (d + d),
           {"device_ms": _graph_ms(kern, sets, 20),
            "library_device_ms": _graph_ms(sdpa, lib_sets, 20),
            "device_kernels_ms": _kernel_ms(kern, sets, 10),
            "library_device_kernels_ms": _kernel_ms(sdpa, lib_sets, 10)})
    del sets, lib_sets
    torch.cuda.empty_cache()
    print("hymba attention timings " + json.dumps(
        {name: {k: v for k, v in by_name[name].items() if k.startswith("hymba_")}
         for name in ("flash_attention", "decode_attention")}))


# ---------------------------------------------------------------------------
# Phase 8: the quantized, multi-round training path
# ---------------------------------------------------------------------------

def _quant_counters():
    from repro_torch.kernels.dequant import dequant_rows
    return dict(_train_counters(), dequant_rows=dequant_rows)


def _quant_step_cfg(plan, pool_dtype, grad_compress, lr=3e-4):
    from repro_torch.launch.steps import StepConfig
    from repro_torch.optim import OptConfig
    return StepConfig(strategy="roundpipe", kv_chunk=min(1024, TRAIN_SEQ),
                      xent_chunk=min(256, TRAIN_SEQ), partition=plan,
                      n_microbatches=QUANT_MICRO, pool_dtype=pool_dtype,
                      grad_compress=grad_compress, opt=OptConfig(lr=lr))


def _ring_launches(plan, passes, quant):
    """The training kernels' launches that ``plan`` predicts for ``passes``
    rounds of the ring (steps x rounds): each of the N workers runs flash
    forward once a layer in F and B slots (once in the fused slot's), the
    backward once a layer, the cross-entropy once; the dequant kernel runs
    once a promote of a slot with layers."""
    n, layers, f = plan.n_workers, plan.n_layers, plan.fused.size
    return {"flash_attention": passes * n * (2 * layers - f),
            "flash_attention_bwd": passes * n * layers,
            "fused_xent": passes * n,
            "dequant_rows": passes * sum(1 for st in plan.stages if st.size) if quant else 0}


def phase_quant_train(pool_dtype, grad_compress):
    """The launcher's multi-round run (prefetch on, R = 2) with the pool in
    ``pool_dtype`` and ``grad_compress`` deposits, the counts set to 0 just
    before and read just after; then, on its final state, one warm step and
    one traced step, and (quantized pools) the quantize pass timed alone."""
    import torch
    from repro_torch.core.dispatch import build_roundpipe_train_step
    from repro_torch.core.ring import OneCardTransport, RingMachine
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch import train
    from repro_torch.models.config import get_config

    counters = _quant_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    argv = ["--arch", ARCH, "--strategy", "roundpipe", "--mesh", f"1x{TRAIN_WORKERS}",
            "--partition", "auto", "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--microbatches", str(QUANT_MICRO), "--pool-dtype", pool_dtype,
            "--grad-compress", grad_compress, "--steps", str(TRAIN_STEPS), "--log-every", "1",
            "--device", DEVICE]
    out = train.main(argv)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    plan = out["plan"]
    rounds = plan.rounds_for(QUANT_MICRO)
    quant = pool_dtype != "none"
    want = _ring_launches(plan, TRAIN_STEPS * rounds, quant)
    label = f"pool {pool_dtype}, deposits {grad_compress}, R={rounds}"
    print(f"quantized train ({label}) launches: {launches} (the plan predicts {want}), peak "
          f"memory {peak / 1e9:.2f} GB, step ms {[x * 1e3 for x in out['step_s']]}")
    check(launches == want, f"training launches ({label}) {launches} != the plan's {want}")
    check(all(math.isfinite(x) for x in out["losses"]), f"non-finite losses {out['losses']}")
    check(("grad_residual" in out["state"]["opt"]) == (grad_compress != "none"),
          "the residual is not where the state keeps it")

    cfg = get_config(ARCH)
    step, _ = build_roundpipe_train_step(
        cfg, TRAIN_WORKERS, _quant_step_cfg(plan, pool_dtype, grad_compress), TRAIN_BATCH,
        TRAIN_SEQ, plan=plan, round_major=True)
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                         rounds=rounds, seed=9))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(0).items()}
    box = {"s": out.pop("state")}

    def one():
        box["s"], m = step(box["s"], batch)
        check(math.isfinite(float(m["loss"])), "non-finite loss in the traced steps")

    one()
    traced = _trace(one, 1)
    quantize_ms = None
    if quant:
        layers_ = box["s"]["params"]["layers"]
        rm = RingMachine(cfg=cfg, plan=plan, n_workers=TRAIN_WORKERS, l_pad=len(layers_),
                         transport=OneCardTransport(TRAIN_WORKERS), pool_template=layers_[0],
                         pool_dtype=pool_dtype)
        with torch.no_grad():
            quantize_ms = _time_ms(lambda: rm.quantize_pool(rm.shards(layers_)), [()], 2)
    del box
    torch.cuda.empty_cache()
    result = {"launches": launches, "step_ms": [x * 1e3 for x in out["step_s"]],
              "losses": out["losses"], "peak_memory_gb": peak / 1e9, "traced_step": traced,
              "quantize_pass_ms": quantize_ms}
    if quant and isinstance(traced, dict) and "dequant_ms" in traced:
        result["dequant_share_of_traced_device_busy"] = (traced["dequant_ms"]
                                                          / traced["device_busy_ms"])
    return result


def _forced_chunks(plan):
    """The plan's prefetch program with every row split into three chunks or
    more (``tests/roundpipe_subprocess.py`` prefetch modes)."""
    biggest = max(int(c.upload_stream_bytes) for c in plan.layer_costs[:plan.n_layers])
    program = plan.prefetch_program(chunk_limit=max(1, biggest // 3))
    n_chunks = sum(1 for table in program.uploads for cu in table if cu.row >= 0)
    check(n_chunks > plan.n_layers, "row chunk splitting did not engage")
    return program, n_chunks


def phase_ring_bit_identity():
    """At full width and 8 layers, bf16 weights, R = 2: the standby prefetch
    with every row split into chunks gives grads bit-identical to whole-block
    injection, dense and int8; and R = 1 through the prefetch path is
    bit-identical to the one-round whole-block path. Sequences of 32 tokens
    (one kv tile of the flash backward, whose dQ sums by atomics) and tokens
    that occur once (the embedding scatter sums by atomics) keep both runs
    deterministic, so a difference can only come from the standby."""
    import torch
    from repro_torch.core.dispatch import build_roundpipe_grads_fn, pad_pool
    from repro_torch.models import transformer as T
    from repro_torch.optim.adam import tree_leaves

    seq, layers = 32, 8
    gen = torch.Generator(device=DEVICE).manual_seed(10)
    report = {}

    def batch_of(rows, cfg):
        perm = torch.randperm(cfg.vocab_size, generator=gen, device=DEVICE)
        tokens = perm[:rows * seq].reshape(rows, seq)
        labels = torch.randint(0, cfg.vocab_size, (rows, seq), generator=gen, device=DEVICE)
        labels[:, :3] = -100
        return {"tokens": tokens, "labels": labels}

    def same(a, b):
        la, lb = tree_leaves(list(a)), tree_leaves(list(b))
        return len(la) == len(lb) and all(
            x.dtype == y.dtype and torch.equal(x, y) for x, y in zip(la, lb))

    for pool_dtype in ("none", "int8"):
        cfg, plan = _quant_plan(pool_dtype, n_layers=layers)
        params = pad_pool(T.init_params(cfg, gen, dtype=torch.bfloat16, device=DEVICE), cfg,
                          TRAIN_WORKERS)
        batch = batch_of(2 * TRAIN_BATCH, cfg)
        program, n_chunks = _forced_chunks(plan)
        kw = dict(n_microbatches=2 * TRAIN_WORKERS, pool_dtype=pool_dtype)
        whole = build_roundpipe_grads_fn(cfg, TRAIN_WORKERS, plan, **kw)(params, batch)
        chunked = build_roundpipe_grads_fn(cfg, TRAIN_WORKERS, plan, prefetch_program=program,
                                           **kw)(params, batch)
        again = build_roundpipe_grads_fn(cfg, TRAIN_WORKERS, plan, **kw)(params, batch)
        check(same(whole, again), f"pool {pool_dtype}: two whole-block runs differ: the "
                                  "check is not deterministic")
        check(same(whole, chunked), f"pool {pool_dtype}: prefetch with {n_chunks} chunks is "
                                    "not bit-identical to whole-block injection")
        report[f"prefetch_{pool_dtype}_chunks"] = n_chunks
        if pool_dtype == "none":
            batch1 = batch_of(TRAIN_BATCH, cfg)
            one_round = build_roundpipe_grads_fn(cfg, TRAIN_WORKERS, plan)(params, batch1)
            r1 = build_roundpipe_grads_fn(cfg, TRAIN_WORKERS, plan,
                                          n_microbatches=TRAIN_WORKERS,
                                          prefetch_program=plan.prefetch_program())(params,
                                                                                    batch1)
            check(same(one_round, r1), "R=1 with prefetch is not bit-identical to the "
                                       "one-round whole-block path")
        del params, whole, chunked, again
    torch.cuda.empty_cache()
    print(f"ring bit-identity, full width, {layers} layers, bf16, seq {seq}: prefetch == "
          f"whole-block (dense {report['prefetch_none_chunks']} and int8 "
          f"{report['prefetch_int8_chunks']} chunk uploads, R=2), R=1 == the one-round path")
    return report


def phase_dequant_timings(errs, launches):
    """The dequant kernel at the training shape (the largest slot's rows,
    int8 codes -> bf16, as the main path calls it) beside its bound and its
    plain version; int4 -> bf16 and int8 -> fp32 on the side. No single
    PyTorch call computes this function, so there is no library time."""
    import torch
    from repro_torch.kernels import ref
    from repro_torch.kernels.dequant import QUANT_BLOCK, dequant_rows
    _, p = _quant_plan()
    rows, elems = p.max_block, FULL_ROW
    nb = elems // QUANT_BLOCK
    gen = torch.Generator(device=DEVICE).manual_seed(11)
    by_format = {}
    row = None
    for packed, dtype in ((False, torch.bfloat16), (True, torch.bfloat16),
                          (False, torch.float32)):
        sets = [_dequant_inputs(rows, elems, packed, "random", gen) for _ in range(2)]
        ms = _time_ms(lambda c, s: dequant_rows(c, s, out_dtype=dtype), sets, 10)
        nbytes = rows * (elems // (2 if packed else 1) + nb * 4
                         + elems * (2 if dtype == torch.bfloat16 else 4))
        key = f"{'int4' if packed else 'int8'}->{dtype_name(dtype)}"
        by_format[key] = {"ms": ms, "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3}
        if row is None:
            plain_ms = _time_ms(lambda c, s: ref.dequant_rows_ref(c, s).to(dtype), sets[:1], 3)
            row = _row("dequant_rows", "src/repro_torch/kernels/csrc/dequant.cu",
                       "src/repro/kernels/dequant.py:97", launches, errs, ms, plain_ms, None,
                       nbytes, rows * elems, "float32")
            row["shape"] = f"{rows} rows x {elems} elements, int8 -> bfloat16"
            row["library_note"] = "none: no single PyTorch call dequantizes blockwise codes"
        del sets
        torch.cuda.empty_cache()
    row["by_format"] = by_format
    print(f"dequant_rows timings: {json.dumps(by_format)}")
    return row


# ---------------------------------------------------------------------------
# Phase 9: frozen-base LoRA fine-tuning
# ---------------------------------------------------------------------------

LORA_RANK = 8


def _lora_cfg(cfg=None):
    """Rank ``LORA_RANK`` over the default targets, or over those of them
    that apply to ``cfg`` (the attention only on an MoE layer)."""
    from repro_torch.models.lora import LoraConfig, applicable_targets
    if cfg is None:
        return LoraConfig(rank=LORA_RANK)
    return LoraConfig(rank=LORA_RANK, target_modules=applicable_targets(cfg))


def phase_lora_train(pool_dtype="none", grad_compress="none", microbatches=None):
    """The launcher's LoRA run (``--lora-rank 8``, prefetch on), the counts
    set to 0 just before and read just after and checked against the plan;
    finite losses; the base (layers, embedding, final norm) bit-identical to
    the seeded initial weights after the steps; every adapter B moved off its
    zero init. Then, on the final state, one warm step and one traced step."""
    import torch
    from repro_torch.core.dispatch import build_roundpipe_train_step, pad_pool
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch import train
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models import transformer as T
    from repro_torch.models.config import get_config
    from repro_torch.models.lora import at_path, target_leaf_paths
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adam import tree_leaves

    counters = _quant_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    argv = ["--arch", ARCH, "--strategy", "roundpipe", "--mesh", f"1x{TRAIN_WORKERS}",
            "--partition", "auto", "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--lora-rank", str(LORA_RANK), "--pool-dtype", pool_dtype,
            "--grad-compress", grad_compress, "--steps", str(TRAIN_STEPS), "--log-every", "1",
            "--device", DEVICE]
    if microbatches:
        argv += ["--microbatches", str(microbatches)]
    out = train.main(argv)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    plan = out["plan"]
    rounds = plan.rounds_for(microbatches or TRAIN_WORKERS)
    want = _ring_launches(plan, TRAIN_STEPS * rounds, pool_dtype != "none")
    label = f"LoRA r={LORA_RANK}, pool {pool_dtype}, deposits {grad_compress}, R={rounds}"
    print(f"lora train ({label}) launches: {launches} (the plan predicts {want}), peak memory "
          f"{peak / 1e9:.2f} GB, step ms {[x * 1e3 for x in out['step_s']]}")
    check(launches == want, f"training launches ({label}) {launches} != the plan's {want}")
    check(all(math.isfinite(x) for x in out["losses"]), f"non-finite losses {out['losses']}")

    state = out.pop("state")
    cfg = get_config(ARCH)
    gen = torch.Generator(device=DEVICE).manual_seed(0)   # the launcher's seed: base first
    init = pad_pool(T.init_params(cfg, gen, device=DEVICE), cfg, TRAIN_WORKERS)
    params = state["params"]
    base_same = all(torch.equal(a, b) for key in ("layers", "embed", "final_norm")
                    for a, b in zip(tree_leaves(init[key]), tree_leaves(params[key])))
    del init
    check(base_same, f"the frozen base changed under LoRA training ({label})")
    paths = target_leaf_paths(params["layers"], _lora_cfg())
    b_moved = all(bool(at_path(row, path)["B"].any())
                  for row in params["lora"][:plan.n_layers] for path in paths)
    check(b_moved, f"an adapter B did not move off its zero init ({label})")
    check(set(state["opt"]["master"]) == {"lora"},
          "the optimizer state holds more than the adapters")

    step_cfg = StepConfig(strategy="roundpipe", kv_chunk=min(1024, TRAIN_SEQ),
                          xent_chunk=min(256, TRAIN_SEQ), partition=plan, lora=_lora_cfg(),
                          n_microbatches=microbatches, pool_dtype=pool_dtype,
                          grad_compress=grad_compress, opt=OptConfig(lr=3e-4))
    step, _ = build_roundpipe_train_step(cfg, TRAIN_WORKERS, step_cfg, TRAIN_BATCH, TRAIN_SEQ,
                                         plan=plan, round_major=bool(microbatches))
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH,
                                         rounds=rounds if microbatches else 0, seed=9))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(0).items()}
    box = {"s": state}
    del state, params

    def one():
        box["s"], m = step(box["s"], batch)
        check(math.isfinite(float(m["loss"])), "non-finite loss in the traced steps")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    one()
    torch.cuda.synchronize()
    warm = time.perf_counter() - t0
    traced = _trace(one, 1)
    del box
    torch.cuda.empty_cache()
    return {"launches": launches, "step_ms": [x * 1e3 for x in out["step_s"]],
            "extra_warm_step_ms": warm * 1e3, "losses": out["losses"],
            "peak_memory_gb": peak / 1e9, "traced_step": traced,
            "base_bit_identical": base_same, "adapter_b_moved": b_moved}


LORA_BF16_TRUTH_RATIO = 1.25


def phase_lora_ring_vs_single():
    """The frozen ring's adapter grads (kernels) against ``torch.autograd.grad``
    of the single program on the merged weights (the plain versions), at full
    width, 2 layers, one layer a slot, adapters randomised away from B = 0.
    fp32: loss rtol 1e-4, worst max-abs relative error 5e-3. bf16: the loss
    and the whole adapter gradient within 2e-2 on the relative norm; and, per
    leaf, the ring no farther from the fp32 single program on the same weights
    than 1.25 times the bf16 single program's own distance from it. Per leaf,
    two bf16 computations sit ~2e-2 apart while each is 3.1-3.5e-2 from the
    fp32 one (an H100 at 700 W, three seeds; PERF.md §6), so a per-leaf 2e-2
    between them measures bf16 rounding, not the kernels; the distance to
    fp32 does."""
    out = {d: _lora_ring_vs_single(d) for d in ("float32", "bfloat16")}
    f32, b16 = out["float32"], out["bfloat16"]
    check(f32["loss_rel"] <= 1e-4, "LoRA ring loss disagrees with the single program (fp32)")
    check(f32["worst_rel"] < 5e-3, "LoRA ring grads disagree with the single program (fp32)")
    check(b16["loss_rel"] <= BWD_REL_BF16,
          "LoRA ring loss disagrees with the single program (bf16)")
    check(b16["tree_norm_rel"] <= BWD_REL_BF16,
          "LoRA ring grads disagree with the single program (bf16)")
    check(b16["worst_truth_ratio"] <= LORA_BF16_TRUTH_RATIO,
          "LoRA ring grads (bf16) are farther from the fp32 single program than the bf16 "
          "single program is")
    return out


def _merged_oracle(params, adapters, lcfg, batch, cfg):
    """Loss and adapter grads of the single program on the merged weights."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.models.lora import merge_params
    from repro_torch.optim.adam import tree_leaves, tree_map

    adapters = tree_map(lambda a: a.detach().clone().requires_grad_(), adapters)
    leaves = tree_leaves(adapters)
    loss = T.loss_fn(merge_params(params, adapters, lcfg), batch, cfg, remat=False)
    return loss.item(), torch.autograd.grad(loss, leaves)


def _lora_ring_vs_single(dtype_label, arch=ARCH, **extra):
    """``extra`` replaces fields of ``arch``'s config (another depth than 2
    layers, another capacity factor)."""
    import torch
    from repro_torch.core.dispatch import build_roundpipe_grads_fn
    from repro_torch.core.plan import plan_from_config, uniform_partition
    from repro_torch.models import transformer as T
    from repro_torch.models.config import get_config
    from repro_torch.models.lora import init_adapters
    from repro_torch.optim.adam import tree_leaves, tree_map

    dtype = getattr(torch, dtype_label)
    cfg = dataclasses.replace(get_config(arch), **{"n_layers": 2, **extra})
    lcfg = _lora_cfg(cfg)
    plan = plan_from_config(cfg, TRAIN_WORKERS, partition=uniform_partition(cfg.n_layers),
                            lora=lcfg)
    gen = torch.Generator(device=DEVICE).manual_seed(15)
    params = T.init_params(cfg, gen, dtype=dtype, device=DEVICE)
    # B away from its zero init, or every A grad is exactly zero
    adapters = tree_map(lambda a: (torch.randn(a.shape, generator=gen, device=DEVICE) * 0.05)
                        .to(dtype), init_adapters(gen, params["layers"], lcfg))
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_WORKERS, 256), generator=gen, device=DEVICE)
    labels = torch.randint(0, cfg.vocab_size, (TRAIN_WORKERS, 256), generator=gen, device=DEVICE)
    labels[:, ::5] = -100
    batch = {"tokens": tokens, "labels": labels}
    ring_fn = build_roundpipe_grads_fn(cfg, TRAIN_WORKERS, plan, lora=lcfg)
    counters = _train_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    grads, loss, _ = ring_fn(dict(params, lora=adapters), batch)
    ring = {k: fn.launches for k, fn in counters.items()}
    check(set(grads) == {"lora"}, f"the LoRA ring returned {sorted(grads)}")
    check(all(ring[k] > before[k] for k in counters),
          f"the LoRA ring did not run through every training kernel ({dtype_label})")
    floor = truth = None
    with _plain_ops():
        if dtype == torch.bfloat16:
            floor = tree_leaves(ring_fn(dict(params, lora=adapters), batch)[0])
        want_loss, want = _merged_oracle(params, adapters, lcfg, batch, cfg)
        if dtype == torch.bfloat16:
            truth = _merged_oracle(_cast(params, torch.float32),
                                   _cast(adapters, torch.float32), lcfg, batch, cfg)[1]
    check({k: fn.launches for k, fn in counters.items()} == ring,
          "the single-program oracle launched a kernel")
    got = tree_leaves(grads)
    check(len(got) == len(want), "ring grads and single-program grads differ in structure")
    check(all(bool(w.abs().max() > 0) for w in want), "a reference adapter grad is zero")
    names = _leaf_names(adapters)
    worst = max(((g.float() - w.float()).abs().max() / (w.float().abs().max() + 1e-6)).item()
                for g, w in zip(got, want))
    norms = sorted(((_rel(g, w), n) for g, w, n in zip(got, want, names)), reverse=True)
    flat = lambda xs: torch.cat([x.float().reshape(-1) for x in xs])   # noqa: E731
    rel_loss = abs(float(loss) - want_loss) / abs(want_loss)
    out = {"loss_rel": rel_loss, "worst_rel": worst,
           "tree_norm_rel": _rel(flat(got), flat(want)), "worst_norm_rel": norms[0][0],
           "worst_leaves": {n: e for e, n in norms[:3]}}
    if floor is not None:
        out["plain_ring_worst_norm_rel"] = max(_rel(g, w) for g, w in zip(floor, want))
        ratios = sorted(((_rel(g, t) / _rel(w, t), n, _rel(g, t), _rel(w, t))
                         for g, w, t, n in zip(got, want, truth, names)), reverse=True)
        out["worst_truth_ratio"] = ratios[0][0]
        out["worst_truth_leaf"] = {"leaf": ratios[0][1], "ring_vs_fp32": ratios[0][2],
                                   "single_bf16_vs_fp32": ratios[0][3]}
        out["ring_vs_fp32_worst"] = max(r[2] for r in ratios)
        out["single_bf16_vs_fp32_worst"] = max(r[3] for r in ratios)
    print(f"LoRA ring vs single program ({arch}), {dtype_label}, full width, {cfg.n_layers} "
          f"layers, r={lcfg.rank}, targets {lcfg.target_modules}, "
          f"plan {plan.describe()}: loss {float(loss):.6f} vs {want_loss:.6f} (rel "
          f"{rel_loss:.2e}), worst relative adapter grad error {worst:.3e} (max abs), "
          f"{norms[0][0]:.3e} (norm, {norms[0][1]}) over {len(got)} leaves, "
          f"{out['tree_norm_rel']:.3e} over all of them; "
          + json.dumps({k: v for k, v in out.items() if k not in ("loss_rel", "worst_rel")}))
    del params, adapters, grads, want, floor, truth
    torch.cuda.empty_cache()
    return out


# The device kernels each traced wrapper launches, by name in a trace.
# ---------------------------------------------------------------------------
# Phase 10: the chained staleness-1 optimizer, the host-resident optimizer
# and checkpoint restarts
# ---------------------------------------------------------------------------

ASYNC_K, ASYNC_STEPS = 4, 4                  # --async-steps and --steps: one chain (the
                                             # repeated-batch calls cross chain boundaries)
ASYNC_LR = "1e-4"
HOST_LAYERS = 2                              # depth of the host-resident optimizer run
HOST_STEPS = 2
HOST_EVENT_S = 30.0                          # the protocol's wait for one event (consistency.py)


@contextlib.contextmanager
def _count_quantize():
    """Counts ``RingMachine.quantize_pool`` passes while the block runs."""
    from repro_torch.core.ring import RingMachine
    kept = RingMachine.quantize_pool
    box = {"passes": 0}

    def counted(self, shards):
        box["passes"] += 1
        return kept(self, shards)

    RingMachine.quantize_pool = counted
    try:
        yield box
    finally:
        RingMachine.quantize_pool = kept


def _stacked_batches(cfg, k, seed, seq=None):
    """``k`` consecutive launcher batches stacked on a leading step axis, on
    the card."""
    import torch
    from repro_torch.data import DataConfig, SyntheticLMDataset
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, seq or TRAIN_SEQ, TRAIN_BATCH,
                                         seed=seed))
    bs = [data.batch(i) for i in range(k)]
    return {key: torch.stack([torch.from_numpy(b[key]) for b in bs]).to(DEVICE) for key in bs[0]}


def phase_async_train(k=ASYNC_K, steps=ASYNC_STEPS, pool_dtype="none", grad_compress="none",
                      microbatches=None, lora=False):
    """The launcher's chained run (``--async-opt --async-steps k``) at full
    width and depth, the counts set to 0 just before and read just after and
    checked against the plan (per step, as the synchronous runs: the chain
    changes when work runs, not how much); quantize passes: one per version
    a chain injects (its steps 0 and 1 share v_0; a frozen base is quantized
    once a chain), never more than one a step; finite losses; no restart.
    The run's learning rate is 1e-4: Adam's first steps at 3e-4 overshoot at
    this width without warmup (``phase_repeated_batch``), and on fresh
    batches the loss rises for the first steps even at 1e-4, so the falling
    loss is checked as ``phase_repeated_batch`` checks it: two more chained
    calls of 2 steps on the final state, on one repeated batch at learning
    rate 1e-5, the second traced (device time per slot kind, in the ``D_k``
    updates and outside any range; its I*R*S + N - 1 ticks; 2 steps, not K,
    as the profiler's processing of a trace grows with its ~36,000-112,000
    device events a step); the last step's loss must be below the first's."""
    import torch
    from repro_torch.core.dispatch import build_roundpipe_async_train_step
    from repro_torch.launch import train
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.config import get_config
    from repro_torch.optim import OptConfig

    counters = _quant_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    argv = ["--arch", ARCH, "--strategy", "roundpipe", "--mesh", f"1x{TRAIN_WORKERS}",
            "--partition", "auto", "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--async-opt", "--async-steps", str(k), "--steps", str(steps), "--lr", ASYNC_LR,
            "--pool-dtype", pool_dtype, "--grad-compress", grad_compress, "--log-every", "1",
            "--device", DEVICE]
    if microbatches:
        argv += ["--microbatches", str(microbatches)]
    if lora:
        argv += ["--lora-rank", str(LORA_RANK)]
    with _count_quantize() as quantized:
        out = train.main(argv)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    plan = out["plan"]
    rounds = plan.rounds_for(microbatches or TRAIN_WORKERS)
    quant = pool_dtype != "none"
    want = _ring_launches(plan, steps * rounds, quant)
    calls = steps // k
    want_q = 0 if not quant else calls * (1 if lora else max(1, k - 1))
    label = (f"K={k}, R={rounds}, pool {pool_dtype}, deposits {grad_compress}"
             + (f", LoRA r={LORA_RANK}" if lora else ""))
    print(f"async train ({label}) launches: {launches} (the plan predicts {want}), quantize "
          f"passes {quantized['passes']} (want {want_q}), peak memory {peak / 1e9:.2f} GB, "
          f"step ms {[x * 1e3 for x in out['step_s']]}, losses {out['losses']}")
    check(launches == want, f"async launches ({label}) {launches} != the plan's {want}")
    check(quantized["passes"] == want_q,
          f"async quantize passes ({label}) {quantized['passes']} != {want_q}")
    check(out["steps"] == steps and len(out["losses"]) == steps,
          f"the chained run ({label}) ran {out['steps']} steps")
    check(all(math.isfinite(x) for x in out["losses"]), f"non-finite losses {out['losses']}")
    check(out["loop"].restarts == 0, f"the chained run ({label}) restarted")

    cfg = get_config(ARCH)
    step_cfg = StepConfig(strategy="roundpipe", kv_chunk=min(1024, TRAIN_SEQ),
                          xent_chunk=min(256, TRAIN_SEQ), partition=plan,
                          lora=_lora_cfg() if lora else None, n_microbatches=microbatches,
                          pool_dtype=pool_dtype, grad_compress=grad_compress,
                          opt=OptConfig(lr=1e-5))
    kt = 2
    multi, _ = build_roundpipe_async_train_step(cfg, TRAIN_WORKERS, step_cfg, TRAIN_BATCH,
                                                TRAIN_SEQ, steps_per_call=kt, plan=plan)
    one_batch = _stacked_batches(cfg, 1, seed=9)
    batches = {key: v.expand(kt, *v.shape[1:]) for key, v in one_batch.items()}
    box = {"s": out.pop("state")}
    repeated = []

    def one():
        box["s"], m = multi(box["s"], batches)
        repeated.extend(m["loss"].tolist())

    one()
    traced = _trace(one, 1)
    print(f"async train ({label}) on a repeated batch at lr 1e-5: losses {repeated}")
    check(all(math.isfinite(x) for x in repeated), f"non-finite losses {repeated}")
    check(repeated[-1] < repeated[0],
          f"the chained loss ({label}) does not fall on a repeated batch: {repeated}")
    ticks = len(plan.tick_program(rounds, kt).records)
    check(ticks == kt * rounds * plan.n_slots + TRAIN_WORKERS - 1,
          f"the chained program has {ticks} ticks")
    del box, batches
    torch.cuda.empty_cache()
    return {"launches": launches, "quantize_passes": quantized["passes"],
            "step_ms": [x * 1e3 for x in out["step_s"]], "losses": out["losses"],
            "repeated_batch_losses": repeated, "peak_memory_gb": peak / 1e9,
            "chained_steps": k, "rounds": rounds, "traced_call_steps": kt,
            "traced_call_ticks": ticks, "traced_chained_call": traced}


def _max_rel(got, want) -> float:
    """max over leaves of max |got - want| / (max |want| + 1e-6)."""
    return max(_leaf_max_rel(got, want).values())


def _leaf_max_rel(got, want) -> dict:
    """leaf name -> max |got - want| / (max |want| + 1e-6)."""
    from repro_torch.optim.adam import tree_leaves
    return {n: ((g.float() - w.float()).abs().max() / (w.float().abs().max() + 1e-6)).item()
            for g, w, n in zip(tree_leaves(got), tree_leaves(want), _leaf_names(want))}


def _single_grads(cfg):
    """``grad_of(params, batch) -> (loss, grads)``: the port's single program
    (``T.loss_fn``) differentiated by autograd, on the card through the
    kernels."""
    import torch
    from repro_torch.models import transformer as T
    from repro_torch.optim.adam import tree_leaves, tree_map

    def grad_of(params, batch):
        p = tree_map(lambda a: a.detach().requires_grad_(), params)
        loss = T.loss_fn(p, batch, cfg, remat=False)
        grads = torch.autograd.grad(loss, tree_leaves(p))
        it = iter(grads)
        return loss.detach(), tree_map(lambda _: next(it), p)

    return grad_of


def _staleness_oracles(params, grad_of, batches, steps, ocfg):
    """The serial staleness-1 oracle (``reference_staleness1``: final weights,
    losses) and the staleness-0 trajectory's final weights, with the port's
    ``apply_updates`` on the card."""
    from repro_torch.core.consistency import reference_staleness1
    from repro_torch.optim.adam import apply_updates, init_opt_state

    losses = []
    cell = {"opt": init_opt_state(params, ocfg)}

    def device_fn(weights, t):
        loss, grads = grad_of(weights[0], {k: v[t] for k, v in batches.items()})
        losses.append(float(loss))
        return [grads]

    def optimizer_fn(opt_w, staged, t):
        new, cell["opt"], _ = apply_updates(cell["opt"], staged[0], ocfg, param_like=params)
        return [new]

    s1 = reference_staleness1(1, device_fn, optimizer_fn, [params], steps)[0]
    cur, opt = params, init_opt_state(params, ocfg)
    for t in range(steps):
        _, grads = grad_of(cur, {k: v[t] for k, v in batches.items()})
        cur, opt, _ = apply_updates(opt, grads, ocfg, param_like=params)
    return s1, losses, cur


ASYNC_ORACLE_LR = 1e-3


def phase_async_vs_staleness1():
    """The chained ring (kernels) against the serial staleness-1 oracle
    ``reference_staleness1`` driven by the port's single program on the card
    (kernels too) and ``apply_updates``, at full width, 2 layers, one layer a
    slot, K = 3 steps, R = 1, prefetch on, 8 sequences of 256 tokens,
    learning rate 1e-3. fp32, the bars of ``tests/roundpipe_subprocess.py``
    ``run_async``: losses rtol 1e-4, worst relative weight error (max abs)
    below 5e-3, the oracle's separation from staleness-0 more than 10x that
    error and the ring's distance from staleness-0 more than 5x it. bf16,
    the bar of the LoRA check (``phase_lora_ring_vs_single``) on the final
    weights: losses and the whole weight tree within 2e-2 on the relative
    norm, and each leaf no farther from the fp32 oracle (run from the same
    bf16 weights in fp32) than 1.25x the bf16 oracle is."""
    out = {d: _async_vs_staleness1(d) for d in ("float32", "bfloat16")}
    f32, b16 = out["float32"], out["bfloat16"]
    check(f32["loss_rtol"] <= 1e-4, "chained losses disagree with the staleness-1 oracle (fp32)")
    check(f32["err_s1"] < 5e-3, "chained weights disagree with the staleness-1 oracle (fp32)")
    check(f32["separation"] > 10 * max(f32["err_s1"], 1e-9),
          "the staleness-1 oracle is not separated from staleness-0 (fp32)")
    check(f32["err_s0"] > 5 * f32["err_s1"], "the chained ring is staleness-0 (fp32)")
    check(b16["loss_rtol"] <= BWD_REL_BF16,
          "chained losses disagree with the staleness-1 oracle (bf16)")
    check(b16["tree_norm_rel"] <= BWD_REL_BF16,
          "chained weights disagree with the staleness-1 oracle (bf16)")
    check(b16["worst_truth_ratio"] <= LORA_BF16_TRUTH_RATIO,
          "chained weights (bf16) are farther from the fp32 oracle than the bf16 oracle is")
    return out


def _async_vs_staleness1(dtype_label):
    import torch
    from repro_torch.core.dispatch import build_roundpipe_async_train_step, pad_pool
    from repro_torch.core.plan import plan_from_config, uniform_partition
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models import transformer as T
    from repro_torch.models.config import get_config
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adam import init_opt_state, tree_leaves, tree_map

    dtype = getattr(torch, dtype_label)
    steps, seq = 3, 256
    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    plan = plan_from_config(cfg, TRAIN_WORKERS, partition=uniform_partition(2))
    gen = torch.Generator(device=DEVICE).manual_seed(16)
    params = T.init_params(cfg, gen, dtype=dtype, device=DEVICE)
    tokens = torch.randint(0, cfg.vocab_size, (steps, TRAIN_BATCH, seq), generator=gen,
                           device=DEVICE)
    labels = torch.randint(0, cfg.vocab_size, (steps, TRAIN_BATCH, seq), generator=gen,
                           device=DEVICE)
    labels[:, :, ::5] = -100
    batches = {"tokens": tokens, "labels": labels}
    ocfg = OptConfig(lr=ASYNC_ORACLE_LR)
    grad_of = _single_grads(cfg)
    s1, losses, s0 = _staleness_oracles(params, grad_of, batches, steps, ocfg)
    truth = None
    if dtype == torch.bfloat16:
        truth = _staleness_oracles(_cast(params, torch.float32), grad_of, batches, steps,
                                   ocfg)[0]
    state = {"params": pad_pool(tree_map(torch.clone, params), cfg, TRAIN_WORKERS)}
    state["opt"] = init_opt_state(state["params"], ocfg)
    step_cfg = StepConfig(strategy="roundpipe", kv_chunk=min(1024, seq), xent_chunk=256,
                          partition=plan, opt=ocfg)
    multi, _ = build_roundpipe_async_train_step(cfg, TRAIN_WORKERS, step_cfg, TRAIN_BATCH, seq,
                                                steps_per_call=steps, plan=plan)
    counters = _train_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    state, metrics = multi(state, batches)
    check(all(fn.launches > before[k] for k, fn in counters.items()),
          f"the chained ring did not run through every training kernel ({dtype_label})")
    got = dict(state["params"], layers=state["params"]["layers"][:cfg.n_layers])
    ring_losses = metrics["loss"].tolist()
    flat = lambda tree: torch.cat([x.float().reshape(-1) for x in tree_leaves(tree)])  # noqa: E731
    out = {"loss_rtol": max(abs(a - b) / abs(b) for a, b in zip(ring_losses, losses)),
           "err_s1": _max_rel(got, s1), "err_s0": _max_rel(got, s0),
           "separation": _max_rel(s0, s1), "tree_norm_rel": _rel(flat(got), flat(s1)),
           "worst_leaves": dict(sorted(_leaf_max_rel(got, s1).items(),
                                       key=lambda kv: -kv[1])[:3]),
           "losses": ring_losses, "oracle_losses": losses}
    if truth is not None:
        names = _leaf_names(got)
        ratios = sorted(((_rel(g, t) / max(_rel(w, t), 1e-30), n, _rel(g, t), _rel(w, t))
                         for g, w, t, n in zip(tree_leaves(got), tree_leaves(s1),
                                               tree_leaves(truth), names)), reverse=True)
        out["worst_truth_ratio"] = ratios[0][0]
        out["worst_truth_leaf"] = {"leaf": ratios[0][1], "ring_vs_fp32": ratios[0][2],
                                   "oracle_bf16_vs_fp32": ratios[0][3]}
    print(f"chained ring vs staleness-1 oracle, {dtype_label}, full width, 2 layers, K={steps}, "
          f"plan {plan.describe()}: " + json.dumps(out))
    del params, state, s1, s0, truth, got
    torch.cuda.empty_cache()
    return out


def _unique_token_data(seq):
    """A dataset class for the launcher whose batches draw every token once
    (a permutation of the vocabulary; the embedding scatter sums by atomics)
    at ``seq`` tokens (one kv tile of the flash backward, whose dQ sums by
    atomics), so two runs are bit-identical; labels from the same stream,
    the first 3 of each row ignored."""
    import numpy as np

    class UniqueTokens:
        def __init__(self, cfg):
            self.cfg = cfg

        def batch(self, step):
            rng = np.random.default_rng(np.random.SeedSequence([self.cfg.seed, step]))
            rows = self.cfg.global_batch
            tokens = rng.permutation(self.cfg.vocab_size)[:rows * seq].reshape(rows, seq)
            labels = rng.integers(0, self.cfg.vocab_size, (rows, seq))
            labels[:, :3] = -100
            return {"tokens": tokens.astype(np.int32), "labels": labels.astype(np.int32)}

    return UniqueTokens


@contextlib.contextmanager
def _launcher_data(cls):
    from repro_torch import data
    kept = data.SyntheticLMDataset
    data.SyntheticLMDataset = cls
    try:
        yield
    finally:
        data.SyntheticLMDataset = kept


def _two_layer_arch():
    """qwen3-1.7b at full width and 2 layers, registered for the launcher."""
    from repro_torch.models.config import REGISTRY, get_config, register
    name = f"{ARCH}-2l"
    if name not in REGISTRY:
        register(dataclasses.replace(get_config(ARCH), name=name, n_layers=2))
    return name


def _same_state(a, b) -> bool:
    import torch
    from repro_torch.optim.adam import tree_leaves
    la, lb = tree_leaves(a), tree_leaves(b)
    return len(la) == len(lb) and all(x.dtype == y.dtype and torch.equal(x, y)
                                      for x, y in zip(la, lb))


def phase_resume():
    """At full width, 2 layers, 32-token sequences of tokens that occur
    once (so runs are bit-identical on the card): through the launcher, 4
    uninterrupted steps equal 1 step, a resume, 1 step, a resume, 2 steps
    (synchronous, ``--ckpt-dir``), and 4 chained steps (K = 2) equal one
    chain, a resume, one chain; a synchronous checkpoint off a chain
    boundary is refused under ``--async-opt``. The checkpoint's bytes and its
    save and load seconds, timed alone."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import latest_step, load_checkpoint, save_checkpoint
    from repro_torch.launch import train

    arch, seq = _two_layer_arch(), 32

    def run(ckpt, steps, *extra):
        # one layer a slot: the auto plan of 2 layers is one slot, too few
        # ticks a step for chaining (R*S >= N - 1)
        argv = ["--arch", arch, "--strategy", "roundpipe", "--mesh", f"1x{TRAIN_WORKERS}",
                "--partition", "uniform", "--batch", str(TRAIN_BATCH), "--seq", str(seq),
                "--steps", str(steps), "--log-every", "100", "--device", DEVICE, *extra]
        if ckpt is not None:
            argv += ["--ckpt-dir", ckpt]
        return train.main(argv)

    report = {}
    root = tempfile.mkdtemp()
    try:
        with _launcher_data(_unique_token_data(seq)):
            ref = run(None, 4)
            again = run(None, 4)
            check(_same_state(ref["state"], again["state"]),
                  "two uninterrupted runs differ: the resume check is not deterministic")
            del again
            d = f"{root}/sync"
            run(d, 1, "--ckpt-every", "1")
            refused = None
            try:
                run(d, 4, "--async-opt", "--async-steps", "2")
            except SystemExit as e:
                refused = str(e)
            check(refused is not None and "not a multiple of --async-steps 2" in refused,
                  f"an off-boundary checkpoint was not refused under --async-opt: {refused}")
            mid = run(d, 2, "--ckpt-every", "1")
            check(mid["resumed_from"] == 0, f"resumed from {mid['resumed_from']}, not step 0")
            del mid
            last = run(d, 4, "--ckpt-every", "100")
            check(last["resumed_from"] == 1 and len(last["losses"]) == 2,
                  f"resumed from {last['resumed_from']} with {len(last['losses'])} steps")
            check(last["losses"] == ref["losses"][2:],
                  f"resumed losses {last['losses']} != {ref['losses'][2:]}")
            check(_same_state(last["state"], ref["state"]),
                  "a resumed synchronous run is not bit-identical to the uninterrupted one")
            del last
            shutil.rmtree(d)
            k2 = ("--async-opt", "--async-steps", "2")
            aref = run(None, 4, *k2)
            d = f"{root}/async"
            run(d, 2, *k2, "--ckpt-every", "2")
            check(latest_step(d) == 1, f"the chain's checkpoint is at step {latest_step(d)}")
            alast = run(d, 4, *k2, "--ckpt-every", "100")
            check(alast["resumed_from"] == 1 and alast["losses"] == aref["losses"][2:],
                  f"resumed chained losses {alast['losses']} != {aref['losses'][2:]}")
            check(_same_state(alast["state"], aref["state"]),
                  "a resumed chained run is not bit-identical to the uninterrupted one")
            shutil.rmtree(d)
        state = ref["state"]
        del ref, aref, alast
        d = f"{root}/timed"
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        path = save_checkpoint(d, 0, state, keep=1)
        report["save_s"] = time.perf_counter() - t0
        report["bytes"] = sum(f.stat().st_size for f in path.iterdir())
        t0 = time.perf_counter()
        back, _ = load_checkpoint(d, 0, state)
        torch.cuda.synchronize()
        report["load_s"] = time.perf_counter() - t0
        check(_same_state(back, state), "a checkpoint does not load back bit for bit")
        del back, state
    finally:
        shutil.rmtree(root, ignore_errors=True)
    torch.cuda.empty_cache()
    report["bytes_gb"] = report["bytes"] / 1e9
    print("resume, full width, 2 layers, seq 32: sync 1+1+2 steps and async 2+2 (K=2) "
          "bit-identical to uninterrupted runs; an off-boundary checkpoint refused under "
          "--async-opt; checkpoint " + json.dumps(report))
    return report


def phase_host_async():
    """``HostAsyncRoundPipe`` at full width: the ring's grads function on
    the card, the fp32 master and moments in pinned host memory and the
    optimizer on the CPU, ``HOST_LAYERS`` layers, ``HOST_STEPS`` steps of 8
    x 1024 tokens. 2 layers, not 28: the CPU optimizer takes over 30 s a
    step at 28 layers on the 8 host cores of one H100 machine, and the
    protocol's wait for one event (``EventBook.wait``, kept as the reference
    has it) is 30 s; and 2 layers and 2 steps (the second step's update is
    the first to run under device work) keep the whole script well inside
    its time limit. The script
    prints the optimizer's seconds per parameter and what that makes at 28
    layers. Prints peak device memory, pinned host bytes, wall seconds a
    step, the device thread's and the CPU optimizer's seconds a step and the
    share of the optimizer hidden under device work, and holds the final
    weights against the serial ``reference_staleness1`` with the same grads
    function and the same host ``apply_updates``: within 5e-3 (max abs
    relative) at 1024 tokens, and bit-identical at 2 layers with 32-token
    sequences of tokens that occur once."""
    out = {"full": _host_async(HOST_LAYERS, TRAIN_SEQ, unique=False),
           "bit_identity_2_layers": _host_async(2, 32, unique=True)}
    check(out["full"]["err_vs_serial"] < 5e-3,
          "the host-resident async optimizer disagrees with the serial oracle")
    check(out["bit_identity_2_layers"]["bit_identical"],
          "the host-resident async optimizer is not bit-identical to the serial oracle")
    return out


def _host_async(layers, seq, *, unique):
    import numpy as np
    import torch
    from repro_torch.core.consistency import reference_staleness1
    from repro_torch.core.dispatch import build_roundpipe_grads_fn
    from repro_torch.core.plan import plan_from_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.models import transformer as T
    from repro_torch.models.config import get_config
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adam import apply_updates, init_opt_state, tree_leaves, tree_map
    from repro_torch.optim.async_opt import HostAsyncRoundPipe

    cfg = dataclasses.replace(get_config(ARCH), n_layers=layers)
    plan = plan_from_config(cfg, TRAIN_WORKERS)
    dcfg = DataConfig(cfg.vocab_size, seq, TRAIN_BATCH, seed=17)
    data = (_unique_token_data(seq) if unique else SyntheticLMDataset)(dcfg)
    batches = [{k: torch.from_numpy(np.asarray(v)).to(DEVICE) for k, v in data.batch(t).items()}
               for t in range(HOST_STEPS)]
    grads_fn = build_roundpipe_grads_fn(cfg, TRAIN_WORKERS, plan)
    ocfg = OptConfig(lr=float(ASYNC_LR), placement="host")
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    params = tree_map(lambda a: a.to("cpu"), T.init_params(cfg, gen, device=DEVICE))
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    host = HostAsyncRoundPipe(grads_fn, params, ocfg, batches, device=DEVICE)
    final = host.train(HOST_STEPS, timeout=600.0)
    peak = torch.cuda.max_memory_allocated()
    n_params = sum(x.numel() for x in tree_leaves(params))
    full = dataclasses.replace(cfg, n_layers=get_config(ARCH).n_layers)
    n_full = n_params + (full.n_layers - layers) * sum(
        x.numel() for x in tree_leaves(params["layers"][0]))
    report = {"layers": layers, "seq": seq, "params": n_params,
              "peak_device_memory_gb": peak / 1e9, "pinned_host_gb": host.pinned_bytes / 1e9,
              "wall_s_per_step": host.wall_s / HOST_STEPS, "device_s": host.device_s,
              "optimizer_s": host.optimizer_s, "hidden_share": host.hidden_share(),
              "optimizer_s_per_param": sorted(host.optimizer_s)[1] / n_params,
              "optimizer_s_projected_28_layers": sorted(host.optimizer_s)[1] / n_params * n_full,
              "losses": host.losses}
    check(all(math.isfinite(x) for x in host.losses), f"non-finite losses {host.losses}")
    check(max(host.optimizer_s) < HOST_EVENT_S,
          f"the CPU optimizer took {max(host.optimizer_s):.1f} s a step")
    del host
    # the serial oracle: the same grads function and the same host update
    cell = {"opt": init_opt_state(params, ocfg)}

    def device_fn(weights, t):
        dev = tree_map(lambda a: a.to(DEVICE), weights[0])
        grads = grads_fn(dev, batches[t])[0]
        return [tree_map(lambda g: g.to("cpu"), grads)]

    def optimizer_fn(opt_w, staged, t):
        new, cell["opt"], _ = apply_updates(cell["opt"], staged[0], ocfg, param_like=params)
        return [new]

    want = reference_staleness1(1, device_fn, optimizer_fn, [params], HOST_STEPS)[0]
    report["err_vs_serial"] = _max_rel(final, want)
    report["bit_identical"] = all(torch.equal(a, b) for a, b in zip(tree_leaves(final),
                                                                     tree_leaves(want)))
    print(f"host-resident async optimizer, full width, {layers} layers, seq {seq}: "
          + json.dumps(report))
    del cell, want, final, params, batches
    torch.cuda.empty_cache()
    return report


# ---------------------------------------------------------------------------
# Phase 11: the goodput supervisor
# ---------------------------------------------------------------------------

CHAOS_LAYERS, CHAOS_BATCH, CHAOS_STEPS = 7, 12, 8   # 12 divides over M = 4 and M' = 3
CHAOS_KILL_AT, CHAOS_SLOW_FROM, CHAOS_WORKERS = 5, 2, 4
CHAOS_SAVE_EVERY = 4                         # checkpoints after steps 3 and 7
CHAOS_LR = 1e-4
SUPERVISED_STEPS, SUPERVISED_CKPT_EVERY = 1, 1   # one step and its checkpoint


def run_chaos(cfg, *, seq, ckpt_dir, device, dtype, batch=CHAOS_BATCH, lr=CHAOS_LR,
              save_every=CHAOS_SAVE_EVERY, counters=None, **step_kw):
    """The reference's chaos harness (``tests/roundpipe_subprocess.py``
    ``run_chaos``) on the port's train step, driven by the goodput supervisor
    on the auto plan of ``cfg`` over 4 ring workers, asynchronous checkpoints
    every ``save_every`` steps. Worker 2 reports 5x-slow step times from step
    2 while the ring is unrotated, so the straggler streak re-scores the
    rotations (``search_schedule`` under the measured ``device_scale``) and
    rebuilds the step with the winner's ``g0``; worker 1 dies at step 5, so
    the supervisor re-plans for the 3 survivors (``replan_for_survivors``,
    M' = 3), restores the newest checkpoint through the elastic path
    (``reshape_pooled_state``) and replays. Then the same steps run
    uninterrupted on 4 workers from the same seeded state. ``step_kw`` go to
    ``StepConfig`` (the chunk sizes).

    Returns {"sup", "end", "state" (the chaos run's), "ref_state" (the
    uninterrupted run's), "losses" (step -> the loss of each run of it),
    "ring_steps" (n_workers -> steps run on that ring), "plans" (n_workers ->
    plan), "launches" (``counters``' counts over the supervised run) and
    "ring_launches" (n_workers -> those counts over that ring's steps)}."""
    import torch
    from repro_torch.core.dispatch import (build_roundpipe_train_step, init_roundpipe_state,
                                           reshape_pooled_state)
    from repro_torch.core.plan import plan_from_config, replan_for_survivors
    from repro_torch.core.simulator import search_schedule
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.steps import StepConfig
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adam import tree_map
    from repro_torch.runtime import StragglerPolicy, Supervisor, WorkerFault

    n0 = CHAOS_WORKERS
    counters = counters or {}
    plans = {n0: (plan_from_config(cfg, n0), n0)}          # ring size -> (plan, M)
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, seq, batch, seed=11))
    losses, killed, built = {}, [], {}
    ring_steps = {}
    ring_launches = {}

    def step_cfg(n, g0):
        plan, m = plans[n]
        return StepConfig(strategy="roundpipe", partition=plan, n_microbatches=m,
                          opt=OptConfig(lr=lr), g0=g0, **step_kw)

    def fresh_state(n, dev=device, gen_device=device):
        gen = torch.Generator(device=gen_device).manual_seed(0)
        return init_roundpipe_state(gen, cfg, step_cfg(n, 0), n_workers=n, dtype=dtype,
                                    device=dev)

    def fetch(t):
        return t, {k: torch.from_numpy(v).to(device) for k, v in data.batch(t).items()}

    def make_runtime(*, n_workers, g0, use_async, replan=None):
        del use_async
        if replan is not None:
            plans[n_workers] = (replan.plan, replan.n_microbatches)
        plan, m = plans[n_workers]
        if (n_workers, g0) not in built:
            built[n_workers, g0] = build_roundpipe_train_step(
                cfg, n_workers, step_cfg(n_workers, g0), batch, seq, plan=plan)[0]
        step = built[n_workers, g0]
        ticks = []

        class Runtime:
            like = fresh_state(n_workers, dev="meta", gen_device="cpu")
            batch_for = staticmethod(fetch)

            @staticmethod
            def init_state():
                return fresh_state(n_workers)

            @staticmethod
            def step_fn(state, step_batch):
                t, b = step_batch
                if t == CHAOS_KILL_AT and not killed:
                    killed.append(t)
                    raise WorkerFault(1, "chaos: injected device loss")
                before = {k: fn.launches for k, fn in counters.items()}
                state, metrics = step(state, b)
                losses.setdefault(t, []).append(float(metrics["loss"]))
                ring_steps[n_workers] = ring_steps.get(n_workers, 0) + 1
                got = ring_launches.setdefault(n_workers, dict.fromkeys(counters, 0))
                for k, fn in counters.items():
                    got[k] += fn.launches - before[k]
                return state, metrics

            @staticmethod
            def adapt_state(host_state):
                return tree_map(lambda x: x.to(device),
                                reshape_pooled_state(host_state, cfg, n_workers))

            @staticmethod
            def worker_times(metrics):
                ticks.append(1)
                if n_workers == n0 and g0 == 0 and len(ticks) > CHAOS_SLOW_FROM:
                    return [1.0, 1.0, 5.0, 1.0]           # worker 2 is 5x slow
                return [1.0] * n_workers

            @staticmethod
            def rescore(scales):
                return search_schedule(plan, m, round_size=n_workers,
                                       device_scale=list(scales)).choice.g0

        return Runtime

    sup = Supervisor(make_runtime, ckpt_dir, n_workers=n0,
                     replan_fn=lambda n: replan_for_survivors(cfg, n, n_microbatches=n0,
                                                              async_steps=1),
                     straggler=StragglerPolicy(factor=2.0, min_samples=2),
                     save_every=save_every, async_ckpt=True, use_async=False)
    for fn in counters.values():
        fn.launches = 0
    state, end = sup.run(CHAOS_STEPS)
    launches = {k: fn.launches for k, fn in counters.items()}
    ref_state, ref_step = fresh_state(n0), built[n0, 0]
    for t in range(CHAOS_STEPS):
        ref_state, _ = ref_step(ref_state, fetch(t)[1])
    return {"sup": sup, "end": end, "state": state, "ref_state": ref_state, "losses": losses,
            "ring_steps": ring_steps, "plans": {n: p for n, (p, _) in plans.items()},
            "launches": launches, "ring_launches": ring_launches}


def _real_params(state, n_layers):
    """A train state's parameters with the pool cut to the model's layers."""
    params = state["params"]
    return dict(params, layers=params["layers"][:n_layers])


def phase_chaos():
    """The chaos scenario on the card (``run_chaos``): full-width qwen3-1.7b,
    7 layers, fp32 weights and master (the kernels' fp32 paths), 12 x 1024
    tokens a step, learning rate 1e-4, asynchronous checkpoints after steps 3
    and 7 (~10.6 GB each). The counts set to 0 just before the supervised run
    and read just after. Checks the reference harness's events (a straggler
    on worker 2, one rotation to g0 = 3, a dead worker re-planned to N = 3
    with M' = 3, resumed at step 4), the replayed step-4 loss within rtol 1e-4
    of its first run, goodput in (0, 1) with replay and replan seconds,
    launches against each ring's plan over its steps, and the final weights
    within 5e-3 (worst relative, the harness's definition) of the
    uninterrupted 4-worker run. Prints the goodput ledger and the writer's
    snapshot and background-write seconds."""
    import shutil
    import tempfile

    import torch
    from repro_torch.models.config import get_config

    cfg = dataclasses.replace(get_config(ARCH), n_layers=CHAOS_LAYERS)
    counters = _quant_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    root = tempfile.mkdtemp()
    t0 = time.perf_counter()
    try:
        out = run_chaos(cfg, seq=TRAIN_SEQ, ckpt_dir=root, device=DEVICE, dtype=torch.float32,
                        counters=counters, kv_chunk=min(1024, TRAIN_SEQ),
                        xent_chunk=min(256, TRAIN_SEQ))
    finally:
        shutil.rmtree(root, ignore_errors=True)
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    sup, losses = out["sup"], out["losses"]
    events = [(e.step, e.kind, e.detail) for e in sup.events]
    print(f"chaos events: {events}")
    check(out["end"] == CHAOS_STEPS and sup.n_workers == CHAOS_WORKERS - 1,
          f"the chaos run ended at step {out['end']} on N={sup.n_workers}")
    stragglers, rotations = sup.events_of("straggler"), sup.events_of("rotate")
    check(bool(stragglers) and stragglers[0].detail["worker"] == 2,
          f"no straggler on worker 2: {events}")
    check(len(rotations) == 1 and rotations[0].detail["g0"] == 3
          and rotations[0].detail["worker"] == 2, f"not one rotation to g0=3: {events}")
    replans, restores = sup.events_of("replan"), sup.events_of("restore")
    check(len(replans) == 1 and replans[0].detail["n_workers"] == 3
          and replans[0].detail["n_microbatches"] == 3 and replans[0].detail["async_ok"],
          f"not one re-plan to N=3, M'=3: {events}")
    check(len(restores) == 1 and restores[0].detail["resumed_at"] == 4,
          f"not one restore at step 4: {events}")
    check(len(losses[4]) == 2, f"step 4 ran {len(losses[4])} times")
    replay_rel = abs(losses[4][1] - losses[4][0]) / abs(losses[4][0])
    check(replay_rel <= 1e-4, f"the replayed step-4 loss {losses[4]} differs by {replay_rel}")
    rep = sup.meter.report()
    check(0.0 < rep["goodput"] < 1.0 and rep["replay_s"] > 0 and rep["replan_s"] > 0,
          f"goodput ledger {rep}")
    for n, steps in out["ring_steps"].items():
        want = _ring_launches(out["plans"][n], steps, False)
        got = out["ring_launches"][n]
        check(got == want, f"chaos launches on N={n} over {steps} steps {got} != the plan's "
                           f"{want}")
    param_err = _max_rel(_real_params(out["state"], CHAOS_LAYERS),
                         _real_params(out["ref_state"], CHAOS_LAYERS))
    check(param_err < 5e-3, f"chaos final weights differ from the uninterrupted run by "
                            f"{param_err}")
    report = {"events": [(s, k) for s, k, _ in events], "ledger": rep,
              "checkpoints": sup.ckpt_io, "launches": out["launches"],
              "ring_steps": out["ring_steps"], "losses": losses,
              "replay_loss_rel": replay_rel, "final_param_err": param_err,
              "peak_memory_gb": peak / 1e9, "wall_s": wall}
    del out
    torch.cuda.empty_cache()
    print("chaos, full width, 7 layers, fp32: " + json.dumps(report))
    return report


def _seven_layer_arch():
    """qwen3-1.7b at full width and the chaos depth, registered for the launcher."""
    from repro_torch.models.config import REGISTRY, get_config, register
    name = f"{ARCH}-{CHAOS_LAYERS}l"
    if name not in REGISTRY:
        register(dataclasses.replace(get_config(ARCH), name=name, n_layers=CHAOS_LAYERS))
    return name


def phase_supervised_launcher():
    """The launcher under the supervisor, ``--elastic --ckpt-dir``, without
    and with ``--async-ckpt``: full width, 7 layers, bf16, 8 x 1024 tokens,
    ``SUPERVISED_STEPS`` = 1 step and its checkpoint (~9.3 GB).
    Each run with the counts set to 0 just before and read just after,
    checked against the plan; no supervisor event, finite losses, the newest
    checkpoint at the last step. Prints both ledgers: the checkpoint seconds the
    step paid (``ckpt_s``), the writer's snapshot and background-write
    seconds, and the checkpoint's bytes."""
    import shutil
    import tempfile

    import torch
    from repro_torch.checkpoint import latest_step
    from repro_torch.launch import train

    arch = _seven_layer_arch()
    counters = _quant_counters()
    report = {}
    for mode in ("sync", "async"):
        root = tempfile.mkdtemp()
        argv = ["--arch", arch, "--strategy", "roundpipe", "--mesh", f"1x{TRAIN_WORKERS}",
                "--partition", "auto", "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
                "--steps", str(SUPERVISED_STEPS), "--ckpt-every", str(SUPERVISED_CKPT_EVERY),
                "--lr", ASYNC_LR, "--elastic", "--ckpt-dir", root, "--log-every", "1",
                "--device", DEVICE] + (["--async-ckpt"] if mode == "async" else [])
        torch.cuda.empty_cache()
        for fn in counters.values():
            fn.launches = 0
        try:
            out = train.main(argv)
            launches = {name: fn.launches for name, fn in counters.items()}
            newest = latest_step(root)
            ckpt_bytes = sum(f.stat().st_size for f in Path(root, f"step_{newest:010d}").iterdir())
        finally:
            shutil.rmtree(root, ignore_errors=True)
        want = _ring_launches(out["plan"], SUPERVISED_STEPS, False)
        check(launches == want, f"supervised launches ({mode}) {launches} != the plan's {want}")
        check(out["steps"] == SUPERVISED_STEPS and not out["events"],
              f"the supervised run ({mode}) ran {out['steps']} steps, events {out['events']}")
        check(all(math.isfinite(x) for x in out["losses"]), f"non-finite losses {out['losses']}")
        check(newest == SUPERVISED_STEPS - 1, f"the newest checkpoint is step {newest}")
        n_ckpt = SUPERVISED_STEPS // SUPERVISED_CKPT_EVERY
        report[mode] = {"ledger": out["goodput"],
                        "ckpt_s_per_checkpoint": out["goodput"]["ckpt_s"] / n_ckpt,
                        "writer": out["supervisor"].ckpt_io, "checkpoint_gb": ckpt_bytes / 1e9,
                        "step_ms": [x * 1e3 for x in out["step_s"]], "launches": launches}
        del out
    print("supervised launcher, full width, 7 layers, bf16: " + json.dumps(report))
    return report


def phase_rotation_trace():
    """A one-round step of the launcher's configuration (full width, 28
    layers, bf16, 8 x 1024 tokens) at g0 = 0 and at g0 = 1 on one state,
    traced in turns (0, 1, 1, 0) after a warm step of each; the launches of
    each traced step against the plan's. One card runs all N logical workers,
    so the rotation moves no work: the device times should agree within the
    run-to-run spread."""
    import torch
    from repro_torch.core.dispatch import build_roundpipe_train_step, init_roundpipe_state
    from repro_torch.core.plan import plan_from_config
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.config import get_config
    from repro_torch.optim import OptConfig

    torch.cuda.empty_cache()
    cfg = get_config(ARCH)
    plan = plan_from_config(cfg, TRAIN_WORKERS)
    steps = {}
    for g0 in (0, 1):
        scfg = StepConfig(strategy="roundpipe", kv_chunk=min(1024, TRAIN_SEQ),
                          xent_chunk=min(256, TRAIN_SEQ), partition=plan,
                          opt=OptConfig(lr=1e-5), g0=g0)
        steps[g0] = build_roundpipe_train_step(cfg, TRAIN_WORKERS, scfg, TRAIN_BATCH,
                                               TRAIN_SEQ, plan=plan)[0]
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    box = {"s": init_roundpipe_state(gen, cfg, scfg, n_workers=TRAIN_WORKERS, device=DEVICE)}
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=7))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(0).items()}
    counters = _quant_counters()
    want = _ring_launches(plan, 1, False)
    traces = {0: [], 1: []}

    def one(g0):
        box["s"], m = steps[g0](box["s"], batch)
        float(m["loss"])

    one(0)
    one(1)                                       # a warm step of each
    for g0 in (0, 1, 1, 0):
        for fn in counters.values():
            fn.launches = 0
        traces[g0].append(_trace(lambda: one(g0), 1))
        launches = {name: fn.launches for name, fn in counters.items()}
        check(launches == want, f"a step at g0={g0} launched {launches}, the plan {want}")
    del box
    torch.cuda.empty_cache()
    report = {f"g0={g0}": [{k: t[k] for k in ("wall_ms", "device_busy_ms", "busy_share",
                                                "device_events", "slot_kinds_ms")}
                           if isinstance(t, dict) else t for t in ts]
              for g0, ts in traces.items()}
    print("rotation, full width, one round, traced in turns (0, 1, 1, 0): " + json.dumps(report))
    return report


# ---------------------------------------------------------------------------
# Phase 12: the dense configs with head dims above 128
# ---------------------------------------------------------------------------

def phase_wide_serve(arch):
    """Serve full-width ``arch`` (gemma-2b: 18 layers, d_head 256, MQA;
    stablelm-12b: 40 layers, d_head 160) as ``phase_serve`` serves
    qwen3-1.7b: launches, finite logits, decode against prefill (bf16 and
    fp32 at 2 layers); then its warm prefill and decode steps and peak
    memory."""
    served, launches = phase_serve(arch)
    from repro_torch.models.config import get_config
    out = {"launches": launches, "peak_memory_gb": served.peak_memory_gb,
           "decode_vs_prefill_rel": served.decode_vs_prefill_rel,
           **_warm_serving(get_config(arch), served)}
    print(f"wide serve ({arch}) " + json.dumps(out))
    del served
    return out


def phase_wide_train():
    """Train full-width gemma-2b one round through the launcher (``--mesh
    1x4 --partition auto --batch 8 --seq 1024``, AdamW) with the plan's
    launches, then 3 steps of a fresh state on a repeated batch (the middle
    one traced): finite and falling losses, step ms and peak memory."""
    import torch
    out, launches, peak = phase_train(WIDE_ARCH)
    losses, times, traced = phase_repeated_batch(out, WIDE_ARCH)
    warm = sorted(out["step_s"][1:] + times)
    report = {"launches": launches, "peak_memory_gb": peak / 1e9, "plan": out["plan"].describe(),
              "train_run_step_ms": [x * 1e3 for x in out["step_s"]], "losses": out["losses"],
              "repeated_batch_step_ms": [x * 1e3 for x in times],
              "repeated_batch_losses": losses, "warm_step_ms_median": warm[len(warm) // 2] * 1e3,
              "warm_tok_per_s": TRAIN_BATCH * TRAIN_SEQ / warm[len(warm) // 2],
              "traced_step": traced}
    del out
    torch.cuda.empty_cache()
    print(f"wide train ({WIDE_ARCH}) " + json.dumps(report))
    return report


def phase_wide_ring_vs_single():
    """gemma-2b's ring grads (the d_head-256 kernels) against its single
    program (the plain versions) at full width, 2 layers, fp32: loss rtol
    1e-4, worst relative 5e-3."""
    out = _ring_vs_single("float32", WIDE_ARCH)
    check(out["loss_rel"] <= 1e-4, f"{WIDE_ARCH} ring loss disagrees with the single program")
    check(out["worst_rel"] < 5e-3, f"{WIDE_ARCH} ring grads disagree with the single program")
    return out


def phase_wide_timings(errs, launches):
    """The instances above 128 head dims, bf16, beside their bounds, their
    plain versions and ``scaled_dot_product_attention``'s forward, backward
    alone (and forward and backward together) and decode (a yardstick only:
    the port never calls it): the flash forward at the prefill of each of
    ``WIDE_SERVE_ARCHS`` (B=4, S=1024: gemma-2b's D 256 under MQA,
    stablelm-12b's D 160 padded to 192), flash-decode over their full
    serving caches (S=1056), and the backward at gemma-2b's training shape
    of one ring worker (B=2). Rows of the ``kernels`` line, named
    ``<kernel>@<arch>``; launches are those of that arch's runs. The 192
    backward at nemotron-4-340b's kernel-case shape (B=2, S=1024, H=96,
    KH=8), on no main path, is printed beside them with its bound, its plain
    version's time and SDPA's backward."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    gen = torch.Generator(device=DEVICE).manual_seed(21)
    bf16, elem = torch.bfloat16, 2
    gqa = _sdpa_gqa()
    kw = {"enable_gqa": True} if gqa else {}
    rows = []

    def widen(k, v, group):
        return (k, v) if gqa else (k.repeat_interleave(group, 1), v.repeat_interleave(group, 1))

    def row(kernel, arch, source, replaces, shape, ms, plain_ms, lib, nbytes, flops):
        name = f"{kernel}@{arch}"
        r = _row(name, source, replaces, launches,
                 {name: errs[f"{kernel}@wide"], f"{name}@main": errs[f"{kernel}@{arch}"]},
                 ms, plain_ms, lib.get("library_ms"), nbytes, flops, "bfloat16")
        r.update({"shape": shape, **{k: v for k, v in lib.items() if k != "library_ms"}})
        rows.append(r)

    def yardstick(fn, sets, reps, device):
        """SDPA's times, or a note where it refuses the shape."""
        try:
            return {"library_ms": _time_ms(fn, sets, reps), **device()}
        except RuntimeError as e:   # a yardstick only: the port never calls SDPA
            return {"library_ms": None, "library_note": str(e).splitlines()[0][:200]}

    def sdpa_bwd_sets(sets, group):
        """SDPA's backward alone, like for like: its forward run once, the
        graph kept for every timed backward; and its inputs for the forward
        and backward together."""
        lib_sets, bwd_sets = [], []
        for q, k, v, o, lse, do in sets:
            qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
            dot = do.transpose(1, 2).contiguous()
            lib_sets.append((qt, kt, vt, dot))
            with torch.enable_grad():
                ot = F.scaled_dot_product_attention(qt, *widen(kt, vt, group), is_causal=True,
                                                    **kw)
            bwd_sets.append((ot, (qt, kt, vt), dot))
        return lib_sets, bwd_sets

    sdpa_bwd = lambda ot, leaves, dot: torch.autograd.grad(ot, leaves, dot,  # noqa: E731
                                                           retain_graph=True)

    for arch in WIDE_SERVE_ARCHS:
        a = _attn(arch)
        h, kh, d = a["h"], a["kh"], a["d"]
        # flash forward at the prefill shape
        sets = [_flash_inputs(BATCH, PROMPT, h, kh, d, d, bf16, "bshd", gen) for _ in range(4)]
        kern = lambda q, k, v: flash_attention(q, k, v, causal=True)   # noqa: E731
        ms = _time_ms(kern, sets, 10)
        device_ms = _graph_ms(kern, sets, 5)
        plain_ms = _time_ms(lambda q, k, v: ref.flash_attention_ref(q, k, v, causal=True),
                            sets[:1], 2)
        lib_sets = []
        for q, k, v in sets:
            q, k, v = (t.transpose(1, 2).contiguous() for t in (q, k, v))
            lib_sets.append((q, *widen(k, v, h // kh)))
        sdpa = lambda q, k, v: F.scaled_dot_product_attention(  # noqa: E731
            q, k, v, is_causal=True, **kw)
        lib = yardstick(sdpa, lib_sets, 10,
                        lambda: {"library_device_ms": _graph_ms(sdpa, lib_sets, 5)})
        pairs = PROMPT * (PROMPT + 1) // 2
        flops = 2 * BATCH * h * pairs * (d + d)
        row("flash_attention", arch, "src/repro_torch/kernels/csrc/flash_attention.cu",
            "src/repro/kernels/flash_attention.py:78",
            f"B={BATCH}, S={PROMPT}, H={h}, KH={kh}, D={d}, causal, bf16", ms, plain_ms, lib,
            (2 * BATCH * PROMPT * h * d + 2 * BATCH * PROMPT * kh * d) * elem, flops)
        rows[-1].update({"device_ms": device_ms, "tflops": flops / (device_ms * 1e-3) / 1e12})
        del sets, lib_sets

        # flash-decode over the full serving cache
        w = PROMPT + GEN
        nv = torch.full((BATCH,), w, dtype=torch.int32, device=DEVICE)
        sets = [_decode_inputs(BATCH, w, h, kh, d, d, bf16, "dense", gen) for _ in range(8)]
        kern = lambda q, k, v: decode_attention(q, k, v, nv)   # noqa: E731
        ms = _time_ms(kern, sets, 20)
        device_ms = _graph_ms(kern, sets, 20)
        plain_ms = _time_ms(lambda q, k, v: ref.decode_attention_ref(q, k, v, nv), sets, 5)
        lib_sets = [(q[:, :, None, :], *widen(k.transpose(1, 2).contiguous(),
                                              v.transpose(1, 2).contiguous(), h // kh))
                    for q, k, v in sets]
        sdpa = lambda q, k, v: F.scaled_dot_product_attention(q, k, v, **kw)  # noqa: E731
        lib = yardstick(sdpa, lib_sets, 20,
                        lambda: {"library_device_ms": _graph_ms(sdpa, lib_sets, 20)})
        row("decode_attention", arch, "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:55",
            f"B={BATCH}, S={w}, H={h}, KH={kh}, D={d}, n_valid {w}, bf16", ms, plain_ms, lib,
            (2 * BATCH * h * d + 2 * BATCH * w * kh * d) * elem + 4 * BATCH,
            2 * BATCH * h * w * (d + d))
        rows[-1].update({"device_ms": device_ms, "device_kernels_ms": _kernel_ms(kern, sets, 10),
                         "plan": _decode_wide_plan(w, BATCH, kh, -(-d // 64) * 64)._asdict()})
        del sets, lib_sets

    # flash backward at one worker's training shape of WIDE_ARCH
    a = _attn(WIDE_ARCH)
    h, kh, d = a["h"], a["kh"], a["d"]
    bw, s = TRAIN_BATCH // TRAIN_WORKERS, TRAIN_SEQ
    sets = []
    for _ in range(4):
        q, k, v = _flash_inputs(bw, s, h, kh, d, d, bf16, "bshd", gen)
        o, lse = flash_attention(q, k, v, return_lse=True)
        sets.append((q, k, v, o, lse, _rand(o.shape, bf16, gen)))
    ms = _time_ms(flash_attention_bwd, sets, 10)
    device_ms = _graph_ms(flash_attention_bwd, sets, 5)
    queued_ms = _queued_ms(flash_attention_bwd, sets, 10)
    plain_ms = _time_ms(ref.flash_attention_bwd_ref, sets[:2], 3)

    def sdpa_fwd_bwd(qt, kt, vt, dot, group=h // kh):
        with torch.enable_grad():
            ot = F.scaled_dot_product_attention(qt, *widen(kt, vt, group), is_causal=True, **kw)
        return torch.autograd.grad(ot, (qt, kt, vt), dot)

    lib_sets, bwd_sets = sdpa_bwd_sets(sets, h // kh)
    lib = yardstick(sdpa_bwd, bwd_sets, 10,
                    lambda: {"library_device_queued_ms": _queued_ms(sdpa_bwd, bwd_sets, 10),
                             "library_note": "SDPA's backward alone"})
    both = yardstick(sdpa_fwd_bwd, lib_sets, 10,
                     lambda: {"library_device_queued_ms": _queued_ms(sdpa_fwd_bwd, lib_sets, 10)})
    lib.update({f"library_fwd_bwd_{k.removeprefix('library_')}": v for k, v in both.items()})
    del bwd_sets
    pairs = s * (s + 1) // 2
    flops = 5 * 2 * bw * h * pairs * d
    row("flash_attention_bwd", WIDE_ARCH, "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "none (the reference differentiates jnp chunked_attention, "
        "src/repro/models/layers.py:76)", f"B={bw}, S={s}, H={h}, KH={kh}, D={d}, causal, bf16",
        ms, plain_ms, lib, (4 * bw * s * h * d + 4 * bw * s * kh * d) * elem + bw * h * s * 4,
        flops)
    rows[-1].update({"device_ms": device_ms, "device_queued_ms": queued_ms,
                     "tflops": flops / (queued_ms * 1e-3) / 1e12,
                     "device_kernels_ms": _kernel_ms(flash_attention_bwd, sets, 5)})
    del sets, lib_sets

    # the 192 backward at nemotron-4-340b's kernel-case shape: bound and SDPA
    a = _attn("nemotron-4-340b")
    h, kh, d = a["h"], a["kh"], a["d"]
    sets = []
    for _ in range(2):
        q, k, v = _flash_inputs(bw, s, h, kh, d, d, bf16, "bshd", gen)
        o, lse = flash_attention(q, k, v, return_lse=True)
        sets.append((q, k, v, o, lse, _rand(o.shape, bf16, gen)))
    flops = 5 * 2 * bw * h * pairs * d
    nbytes = (4 * bw * s * h * d + 4 * bw * s * kh * d) * elem + bw * h * s * 4
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS["bfloat16"] * 1e3
    nemotron = {"name": "flash_attention_bwd@nemotron-4-340b",
                "shape": f"B={bw}, S={s}, H={h}, KH={kh}, D={d}, causal, bf16",
                "device_ms": _graph_ms(flash_attention_bwd, sets, 3),
                "device_queued_ms": _queued_ms(flash_attention_bwd, sets, 3),
                "plain_ms": _time_ms(ref.flash_attention_bwd_ref, sets[:1], 2),
                "bound_ms": max(t_bytes, t_ops),
                "bound_by": "bytes" if t_bytes >= t_ops else "operations"}
    _, bwd_sets = sdpa_bwd_sets(sets, h // kh)
    nemotron.update(yardstick(
        sdpa_bwd, bwd_sets, 3,
        lambda: {"library_device_queued_ms": _queued_ms(sdpa_bwd, bwd_sets, 3),
                 "library_note": "SDPA's backward alone"}))
    del sets, bwd_sets
    torch.cuda.empty_cache()
    print("wide kernel timings " + json.dumps(rows + [nemotron]))
    return rows


# ---------------------------------------------------------------------------
# Phase 13: the embeds front end and the MoE family
# ---------------------------------------------------------------------------

VISION_SERVE_LAYERS = 8      # internvl2-76b's 80 layers cut to 8: ~17.9 GB of bf16 weights
MOE_LORA_LAYERS = 8          # gpt-oss-20b's 24 layers cut to 8 for the LoRA ring
FAMILY_REPEAT_LR = 1e-5      # the front end's repeated batch, as phase_repeated_batch's


def _cut_arch(arch, **fields):
    """``arch`` with ``fields`` replaced (a depth cut), registered for the
    launchers under a derived name."""
    from repro_torch.models.config import REGISTRY, get_config, register
    name = arch + "".join(f"-{k}{v}" for k, v in sorted(fields.items()))
    if name not in REGISTRY:
        register(dataclasses.replace(get_config(arch), name=name, **fields))
    return name


def _no_drop(cfg):
    """``cfg`` at the capacity factor E/k: every expert can take every token
    of a batch, so no assignment is dropped whatever the batch's size."""
    return dataclasses.replace(cfg, capacity_factor=cfg.n_experts / cfg.experts_per_token)


def _teacher_forced(params, cfg, inputs, steps):
    """The logits (B, steps + 1, V) fp32 of the last ``steps`` + 1 positions
    of one prefill over ``inputs`` ({"tokens"} or {"embeds"}): what a prefill
    of the prompt and ``steps`` decode steps over the rest should give."""
    import torch
    from repro_torch.models import transformer as T
    with torch.inference_mode():
        s = next(iter(inputs.values())).shape[1]
        x, _ = T.prefill(params, inputs, cfg, s, dtype=params["embed"].dtype)
        return (x[:, -steps - 1:] @ T.lm_head_weights(params, cfg)).float()


def _feed(params, prompt, steps):
    """The prompt ({"tokens"} or {"embeds"}) followed by the decode steps'
    inputs, (B,) tokens or (B,1,D) embeds, as one prefill's inputs; a token
    after an embeds prompt enters as its embedding row."""
    import torch
    key, x = next(iter(prompt.items()))
    if key == "tokens":
        return {"tokens": torch.cat([x] + [f[:, None] for f in steps], dim=1)}
    emb = params["embed"]
    return {"embeds": torch.cat([x] + [(f if f.ndim == 3 else emb[f[:, None]]).to(x.dtype)
                                       for f in steps], dim=1)}


def _serve_and_feed(params, cfg, prompt, steps, first=None):
    """Prefill ``prompt``, then ``steps`` decode steps (the first from the
    (B,1,D) embeds ``first`` when given, the others greedy): (the logits of
    the prefill and of every step (B, steps + 1, V), the inputs of one
    teacher-forced prefill over the same tokens)."""
    import torch
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    s = next(iter(prompt.values())).shape[1]
    logits, cache = build_prefill_step(cfg, s + steps)(params, prompt)
    decode = build_decode_step(cfg)
    got, fed = [logits], []
    for i in range(steps):
        fed.append(first if i == 0 and first is not None else got[-1].argmax(-1))
        logits, cache = decode(params, cache, fed[-1])
        got.append(logits)
    del cache
    return torch.stack(got, dim=1), _feed(params, prompt, fed)


# The bf16 bar of the serving checks below, on the relative norm of the
# logits over every decode step: the bf16 decode path no farther from the
# fp32 teacher-forced prefill of the same weights and inputs than the bf16
# prefill is, but for this factor (the rule of the LoRA ring check and of
# tests/test_torch_ssm.py). Between themselves two bf16 paths that round at
# other points part by ~2e-2 over 32 steps of internvl2-76b at 8 layers, and
# a top-k router breaks a near-tie one way on one path and the other way on
# the other (gpt-oss-20b at 2 layers: 5.9e-2, max abs 2.6; an H100 at 700 W),
# so the distance between them measures rounding, not the decode path; the
# distance to fp32 does.
FAMILY_BF16_TRUTH_RATIO = 1.25


def _bf16_vs_truth(params, cfg, inputs, steps, got):
    """The bf16 decode logits ``got`` (B, steps + 1, V) against one bf16
    teacher-forced prefill over ``inputs`` and against the same prefill on an
    fp32 copy of the weights: fails unless the decode is no farther from
    fp32 than ``FAMILY_BF16_TRUTH_RATIO`` times the bf16 prefill is."""
    import torch
    want = _teacher_forced(params, cfg, inputs, steps)
    p32 = _cast(params, torch.float32)
    truth = _teacher_forced(p32, cfg, inputs, steps)
    del p32
    out = {"decode_vs_prefill": _rel(got, want), "decode_vs_fp32": _rel(got, truth),
           "prefill_vs_fp32": _rel(want, truth),
           "decode_vs_prefill_max_abs": (got - want).abs().max().item(),
           "argmax_agrees_with_fp32": {
               "decode": (got.argmax(-1) == truth.argmax(-1)).float().mean().item(),
               "prefill": (want.argmax(-1) == truth.argmax(-1)).float().mean().item()}}
    print(f"decode vs teacher-forced prefill, bf16, {cfg.name}, {cfg.n_layers} layers, {steps} "
          f"steps, relative norm: " + json.dumps(out))
    check(out["decode_vs_fp32"] <= FAMILY_BF16_TRUTH_RATIO * out["prefill_vs_fp32"],
          f"{cfg.name}: bf16 decode logits lie farther from the fp32 prefill than the bf16 "
          "prefill does")
    del want, truth
    torch.cuda.empty_cache()
    return out


def _fp32_vs_teacher(cfg, prompt_len, steps, seed, embeds_first=False):
    """At full width in fp32 (``cfg``'s depth): decode against a
    teacher-forced prefill, elementwise rtol and atol 1e-4. Returns the max
    abs error."""
    import torch
    from repro_torch.models import transformer as T
    gen = torch.Generator(device=DEVICE).manual_seed(seed)
    p32 = T.init_params(cfg, gen, dtype=torch.float32, device=DEVICE)
    if cfg.frontend:
        prompt = {"embeds": torch.randn((2, prompt_len, cfg.d_model), generator=gen,
                                        device=DEVICE)}
    else:
        prompt = {"tokens": torch.randint(0, cfg.vocab_size, (2, prompt_len), generator=gen,
                                          device=DEVICE)}
    first = (torch.randn((2, 1, cfg.d_model), generator=gen, device=DEVICE)
             if embeds_first else None)
    got, fed = _serve_and_feed(p32, cfg, prompt, steps, first)
    want = _teacher_forced(p32, cfg, fed, steps)
    err = (got - want).abs().max().item()
    print(f"decode vs teacher-forced prefill, fp32, {cfg.name}, {cfg.n_layers} layers, prompt "
          f"{prompt_len}, {steps} steps{' (the first from embeds)' if embeds_first else ''}: "
          f"max abs err {err:.3e}")
    check(torch.allclose(got, want, rtol=1e-4, atol=1e-4),
          f"{cfg.name}: fp32 decode logits disagree with the teacher-forced prefill")
    del p32, got, want
    torch.cuda.empty_cache()
    return err


def phase_frontend_serve():
    """internvl2-76b at full width and ``VISION_SERVE_LAYERS`` of its 80
    layers (a depth cut) through ``serve.main``: ``BATCH`` prompts of
    ``PROMPT`` random bf16 embeds, ``GEN`` greedy tokens, launches and finite
    logits (``_serve_launcher``); every decode step against a teacher-forced
    prefill over the prompt's embeds and the generated tokens' embedding
    rows (``_bf16_vs_truth``: no farther from the fp32 prefill than the bf16
    prefill is, but for 1.25x); warm prefill and decode steps and peak
    memory. Then at full width and 2 layers in fp32:
    a prompt of 256 embeds, one decode step from (B,1,D) embeds and 4 from
    tokens, against the same teacher-forced prefill, elementwise 1e-4."""
    import torch
    from repro_torch.models.config import get_config

    name = _cut_arch(VISION_ARCH, n_layers=VISION_SERVE_LAYERS)
    cfg = get_config(name)
    served, launches = _serve_launcher(name)
    check(served.prompts.dtype == torch.bfloat16 and served.prompts.ndim == 3,
          f"{name}: the prompts are not bf16 embeds")
    out = {"launches": launches, "peak_memory_gb": served.peak_memory_gb,
           **_warm_serving(cfg, served)}
    out["bf16_vs_teacher"] = _bf16_vs_truth(
        served.params, cfg, _feed(served.params, {"embeds": served.prompts},
                                  list(served.tokens.unbind(1))), GEN,
        torch.stack(served.logits, dim=1))
    del served
    gc.collect()
    out["fp32_2_layers_max_abs"] = _fp32_vs_teacher(
        dataclasses.replace(get_config(VISION_ARCH), n_layers=2), 256, 5, 24,
        embeds_first=True)
    print(f"front-end serve ({name}) " + json.dumps(out))
    return out


def phase_frontend_train():
    """hubert-xlarge at full width and depth (48 layers, 16 bidirectional
    heads of 80, a 504-unit head; ~944 M parameters) through
    ``dispatch.build_roundpipe_train_step`` with embeds batches (the
    launcher refuses a front-end arch: its dataset makes tokens): N = 4, the
    auto plan, ``TRAIN_BATCH`` x ``TRAIN_SEQ`` random bf16 frame embeds and
    labels in [0, 504), AdamW (lr 3e-4, fp32 master), prefetch on.
    ``TRAIN_STEPS`` steps on fresh batches, the counts set to 0 just before
    and read just after and held against the plan, finite losses, step ms
    and peak memory; then a fresh state at learning rate 1e-5 on one
    repeated batch for 3 steps, the middle one traced (slot kinds, flash and
    xent device ms): the loss falls. Then the fp32 ring against the single
    program at full width and 4 layers: loss rtol 1e-4, worst relative
    5e-3, the embedding's gradient zero in both."""
    import torch
    from repro_torch.core.dispatch import build_roundpipe_train_step, init_roundpipe_state
    from repro_torch.core.plan import plan_from_config
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.config import get_config
    from repro_torch.optim import OptConfig

    cfg = get_config(AUDIO_ARCH)
    plan = plan_from_config(cfg, TRAIN_WORKERS)
    gen = torch.Generator(device=DEVICE).manual_seed(31)

    def batch():
        return {"embeds": torch.randn((TRAIN_BATCH, TRAIN_SEQ, cfg.d_model), generator=gen,
                                      device=DEVICE).to(torch.bfloat16),
                "labels": torch.randint(0, cfg.vocab_size, (TRAIN_BATCH, TRAIN_SEQ),
                                        generator=gen, device=DEVICE)}

    def build(lr):
        step_cfg = StepConfig(strategy="roundpipe", kv_chunk=min(1024, TRAIN_SEQ),
                              xent_chunk=min(256, TRAIN_SEQ), partition=plan,
                              opt=OptConfig(lr=lr))
        step, _ = build_roundpipe_train_step(cfg, TRAIN_WORKERS, step_cfg, TRAIN_BATCH,
                                             TRAIN_SEQ, plan=plan)
        state = init_roundpipe_state(torch.Generator(device=DEVICE).manual_seed(0), cfg,
                                     step_cfg, n_workers=TRAIN_WORKERS, device=DEVICE)
        return step, {"s": state}

    def run(step, box, b, losses, times):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box["s"], m = step(box["s"], b)
        losses.append(float(m["loss"]))
        times.append(time.perf_counter() - t0)

    counters = _train_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    step, box = build(3e-4)
    batches = [batch() for _ in range(TRAIN_STEPS)]
    for fn in counters.values():
        fn.launches = 0
    losses, step_s = [], []
    for b in batches:
        run(step, box, b, losses, step_s)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    want = {k: v for k, v in _ring_launches(plan, TRAIN_STEPS, False).items() if k in counters}
    print(f"front-end train launches ({AUDIO_ARCH}, plan {plan.describe()}): {launches} (the "
          f"plan predicts {want}), peak memory {peak / 1e9:.2f} GB, losses {losses}, step ms "
          f"{[x * 1e3 for x in step_s]}")
    check(launches == want, f"{AUDIO_ARCH}: training launches {launches} != the plan's {want}")
    check(all(math.isfinite(x) for x in losses), f"{AUDIO_ARCH}: non-finite losses {losses}")
    del box, batches, step
    gc.collect()
    torch.cuda.empty_cache()

    step, box = build(FAMILY_REPEAT_LR)
    b = batch()
    rep_losses, rep_s = [], []
    run(step, box, b, rep_losses, rep_s)
    traced = _trace(lambda: run(step, box, b, rep_losses, rep_s), 1)
    run(step, box, b, rep_losses, rep_s)
    print(f"repeated batch ({AUDIO_ARCH}, lr {FAMILY_REPEAT_LR}): losses {rep_losses}")
    check(all(math.isfinite(x) for x in rep_losses), f"non-finite losses {rep_losses}")
    check(rep_losses[-1] < rep_losses[0],
          f"{AUDIO_ARCH}: the loss does not fall on a repeated batch: {rep_losses}")
    del box, b, step
    gc.collect()
    torch.cuda.empty_cache()

    ring = _ring_vs_single("float32", AUDIO_ARCH, n_layers=4)
    check(ring["loss_rel"] <= 1e-4, f"{AUDIO_ARCH} ring loss disagrees with the single program")
    check(ring["worst_rel"] < 5e-3, f"{AUDIO_ARCH} ring grads disagree with the single program")
    check(ring["embed_grad_zero"], f"{AUDIO_ARCH}: the embedding's gradient is not zero")
    warm = sorted(step_s[1:] + rep_s)
    out = {"launches": launches, "peak_memory_gb": peak / 1e9, "plan": plan.describe(),
           "step_ms": [x * 1e3 for x in step_s], "losses": losses,
           "repeated_batch_losses": rep_losses,
           "repeated_batch_step_ms": [x * 1e3 for x in rep_s],
           "warm_step_ms_median": warm[len(warm) // 2] * 1e3,
           "warm_frames_per_s": TRAIN_BATCH * TRAIN_SEQ / warm[len(warm) // 2],
           "traced_step": traced, "ring_vs_single_fp32_4_layers": ring}
    print(f"front-end train ({AUDIO_ARCH}) " + json.dumps(out))
    return out


def phase_moe_serve():
    """gpt-oss-20b at full width and depth (24 layers, 32 experts top-4,
    ~41.8 GB of bf16 weights) through ``serve.main``: ``BATCH`` x ``PROMPT``
    tokens, ``GEN`` greedy tokens, launches and finite logits
    (``_serve_launcher``); warm prefill and decode steps, peak memory, a
    traced prefill and a traced decode step. At the published capacity
    factor a decode step routes ``BATCH`` tokens into a capacity of 1 an
    expert and drops assignments that the prefill keeps, so decode is held
    against a teacher-forced prefill at full width and 2 layers with the
    capacity factor E/k (no drops; a cut named in PERF.md §4): bf16 over
    ``GEN`` steps after a ``PROMPT``-token prompt (``_bf16_vs_truth``), fp32
    over 4 steps after 256 tokens (elementwise 1e-4)."""
    import torch
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models import transformer as T
    from repro_torch.models.config import get_config

    cfg = get_config(MOE_ARCH)
    served, launches = _serve_launcher(MOE_ARCH)
    out = {"launches": launches, "peak_memory_gb": served.peak_memory_gb,
           **_warm_serving(cfg, served)}
    prefill = build_prefill_step(cfg, PROMPT + GEN)
    decode = build_decode_step(cfg)
    batch = {"tokens": served.prompts}
    out["traced_prefill"] = _trace(lambda: prefill(served.params, batch), 1)
    logits, cache = prefill(served.params, batch)
    state = {"tok": logits.argmax(-1), "cache": cache}

    def step():
        lg, state["cache"] = decode(served.params, state["cache"], state["tok"])
        state["tok"] = lg.argmax(-1)

    out["traced_decode_step"] = _trace(step, 4)
    del served, state, cache, logits
    gc.collect()
    torch.cuda.empty_cache()

    cfg2 = _no_drop(dataclasses.replace(cfg, n_layers=2))
    gen = torch.Generator(device=DEVICE).manual_seed(25)
    p16 = T.init_params(cfg2, gen, device=DEVICE)
    toks = torch.randint(0, cfg2.vocab_size, (BATCH, PROMPT), generator=gen, device=DEVICE)
    got, fed = _serve_and_feed(p16, cfg2, {"tokens": toks}, GEN)
    out["bf16_vs_teacher_2_layers"] = _bf16_vs_truth(p16, cfg2, fed, GEN, got)
    del p16, got
    out["fp32_2_layers_max_abs"] = _fp32_vs_teacher(cfg2, 256, 4, 26)
    print(f"MoE serve ({MOE_ARCH}) " + json.dumps(out))
    return out


def phase_moe_lora_train():
    """gpt-oss-20b at full width and ``MOE_LORA_LAYERS`` of its 24 layers (a
    depth cut) through the launcher: LoRA rank 8 over the attention
    (``--lora-targets attn``: the experts and the router stay frozen, as
    ``applicable_targets`` has it), one round, prefetch on, the counts set
    to 0 just before and read just after and held against the plan, finite
    losses, the base bit-identical to its seeded initial weights, every
    adapter B moved. Then 3 steps on one repeated batch from the final state
    (lr 3e-4), the middle one traced (slot kinds, the untied head's dense
    copy): the loss falls. Then the fp32 LoRA ring against the single
    program on the merged weights at full width and 2 layers with the
    capacity factor E/k: capacity follows the micro-batch, so with drops the
    ring and the single program route differently by design (loss rtol
    1e-4, worst relative 5e-3)."""
    import torch
    from repro_torch.core.dispatch import build_roundpipe_train_step, pad_pool
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch import train
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models import transformer as T
    from repro_torch.models.config import get_config
    from repro_torch.models.lora import at_path, target_leaf_paths
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adam import tree_leaves

    name = _cut_arch(MOE_ARCH, n_layers=MOE_LORA_LAYERS)
    cfg = get_config(name)
    lcfg = _lora_cfg(cfg)
    counters = _train_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    out = train.main(["--arch", name, "--strategy", "roundpipe", "--mesh", f"1x{TRAIN_WORKERS}",
                      "--partition", "auto", "--batch", str(TRAIN_BATCH), "--seq",
                      str(TRAIN_SEQ), "--lora-rank", str(LORA_RANK), "--lora-targets",
                      ",".join(lcfg.target_modules), "--steps", str(TRAIN_STEPS),
                      "--log-every", "1", "--device", DEVICE])
    launches = {k: fn.launches for k, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    plan = out["plan"]
    want = {k: v for k, v in _ring_launches(plan, TRAIN_STEPS, False).items() if k in counters}
    print(f"MoE LoRA train ({name}, r={LORA_RANK}, targets {lcfg.target_modules}, plan "
          f"{plan.describe()}) launches: {launches} (the plan predicts {want}), peak memory "
          f"{peak / 1e9:.2f} GB, step ms {[x * 1e3 for x in out['step_s']]}")
    check(launches == want, f"{name}: training launches {launches} != the plan's {want}")
    check(all(math.isfinite(x) for x in out["losses"]), f"non-finite losses {out['losses']}")

    state = out.pop("state")
    gen = torch.Generator(device=DEVICE).manual_seed(0)   # the launcher's seed: base first
    init = pad_pool(T.init_params(cfg, gen, device=DEVICE), cfg, TRAIN_WORKERS)
    params = state["params"]
    base_same = all(torch.equal(a, b) for key in ("layers", "embed", "final_norm", "lm_head")
                    for a, b in zip(tree_leaves(init[key]), tree_leaves(params[key])))
    del init
    check(base_same, f"{name}: the frozen base changed under LoRA training")
    paths = target_leaf_paths(params["layers"], lcfg)
    check(all(p.startswith("attn.") for p in paths), f"{name}: LoRA targets {paths}")
    b_moved = all(bool(at_path(row, path)["B"].any())
                  for row in params["lora"][:plan.n_layers] for path in paths)
    check(b_moved, f"{name}: an adapter B did not move off its zero init")

    step_cfg = StepConfig(strategy="roundpipe", kv_chunk=min(1024, TRAIN_SEQ),
                          xent_chunk=min(256, TRAIN_SEQ), partition=plan, lora=lcfg,
                          opt=OptConfig(lr=3e-4))
    step, _ = build_roundpipe_train_step(cfg, TRAIN_WORKERS, step_cfg, TRAIN_BATCH, TRAIN_SEQ,
                                         plan=plan)
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=9))
    batch = {k: torch.from_numpy(v).to(DEVICE) for k, v in data.batch(0).items()}
    box = {"s": state}
    del state, params
    rep_losses, rep_s = [], []

    def one():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        box["s"], m = step(box["s"], batch)
        rep_losses.append(float(m["loss"]))
        rep_s.append(time.perf_counter() - t0)

    one()
    traced = _trace(one, 1)
    one()
    print(f"repeated batch ({name}, LoRA r={LORA_RANK}, lr 3e-4): losses {rep_losses}")
    check(all(math.isfinite(x) for x in rep_losses), f"non-finite losses {rep_losses}")
    check(rep_losses[-1] < rep_losses[0],
          f"{name}: the loss does not fall on a repeated batch: {rep_losses}")
    del box, step
    gc.collect()
    torch.cuda.empty_cache()

    ring = _lora_ring_vs_single("float32", MOE_ARCH,
                                capacity_factor=_no_drop(get_config(MOE_ARCH)).capacity_factor)
    check(ring["loss_rel"] <= 1e-4, f"{MOE_ARCH} LoRA ring loss disagrees with the single "
                                    "program (fp32)")
    check(ring["worst_rel"] < 5e-3, f"{MOE_ARCH} LoRA ring grads disagree with the single "
                                    "program (fp32)")
    report = {"launches": launches, "peak_memory_gb": peak / 1e9, "plan": plan.describe(),
              "step_ms": [x * 1e3 for x in out["step_s"]], "losses": out["losses"],
              "repeated_batch_losses": rep_losses,
              "repeated_batch_step_ms": [x * 1e3 for x in rep_s], "traced_step": traced,
              "base_bit_identical": base_same, "adapter_b_moved": b_moved,
              "ring_vs_single_fp32_2_layers": ring}
    print(f"MoE LoRA train ({name}) " + json.dumps(report))
    return report


def phase_family_timings(errs, launches):
    """The instances this slice's paths run that no earlier path did, bf16,
    beside their bounds, their plain versions and a PyTorch call (a
    yardstick only: the port never calls it): the flash forward and backward
    at hubert-xlarge's training shape (one ring worker's B=2, S=1024, 16
    bidirectional heads of 80, padded to 128; SDPA's forward, and its
    backward alone queued behind a sleep kernel), the cross-entropy forward
    at its head (T=2048, D=1280, V=504, untied; ``F.cross_entropy(x @ W)``)
    and flash-decode at the group-8 serving caches of internvl2-76b (D 128)
    and gpt-oss-20b (D 64), B=4, S=1056. Rows of the ``kernels`` line named
    ``<kernel>@<arch>``; launches are those of that arch's runs."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention, flash_attention_bwd
    from repro_torch.kernels.fused_xent import fused_xent
    from repro_torch.models.config import get_config
    gen = torch.Generator(device=DEVICE).manual_seed(41)
    bf16, elem = torch.bfloat16, 2
    gqa = _sdpa_gqa()
    kw = {"enable_gqa": True} if gqa else {}
    rows = []

    def row(kernel, arch, source, replaces, shape, ms, plain_ms, lib_ms, nbytes, flops,
            **extra):
        name = f"{kernel}@{arch}"
        r = _row(name, source, replaces, launches,
                 {name: errs[f"{kernel}@{arch}:worst"],
                  f"{name}@main": errs[f"{kernel}@{arch}"]},
                 ms, plain_ms, lib_ms, nbytes, flops, "bfloat16")
        r.update({"shape": shape, **extra})
        rows.append(r)

    # hubert-xlarge: the bidirectional forward and backward at D 80
    a = _attn(AUDIO_ARCH)
    h, kh, d = a["h"], a["kh"], a["d"]
    bw, s = TRAIN_BATCH // TRAIN_WORKERS, TRAIN_SEQ
    shape = f"B={bw}, S={s}, H={h}, KH={kh}, D={d}, bidirectional, bf16"
    sets = [_flash_inputs(bw, s, h, kh, d, d, bf16, "bshd", gen) for _ in range(4)]
    kern = lambda q, k, v: flash_attention(q, k, v, causal=False)   # noqa: E731
    lib_sets = [tuple(t.transpose(1, 2).contiguous() for t in st) for st in sets]
    sdpa = lambda q, k, v: F.scaled_dot_product_attention(q, k, v)   # noqa: E731
    device_ms = _graph_ms(kern, sets, 5)
    flops = 2 * bw * h * s * s * (d + d)
    row("flash_attention", AUDIO_ARCH, "src/repro_torch/kernels/csrc/flash_attention.cu",
        "src/repro/kernels/flash_attention.py:78", shape, _time_ms(kern, sets, 10),
        _time_ms(lambda q, k, v: ref.flash_attention_ref(q, k, v, causal=False), sets[:2], 3),
        _time_ms(sdpa, lib_sets, 10), (2 * bw * s * h * d + 2 * bw * s * kh * d) * elem, flops,
        device_ms=device_ms, library_device_ms=_graph_ms(sdpa, lib_sets, 5),
        tflops=flops / (device_ms * 1e-3) / 1e12)
    bwd_sets, sdpa_sets = [], []
    for q, k, v in sets:
        o, lse = flash_attention(q, k, v, causal=False, return_lse=True)
        bwd_sets.append((q, k, v, o, lse, _rand(o.shape, bf16, gen)))
    for q, k, v, o, lse, do in bwd_sets:
        qt, kt, vt = (t.transpose(1, 2).contiguous().requires_grad_() for t in (q, k, v))
        with torch.enable_grad():
            ot = F.scaled_dot_product_attention(qt, kt, vt)
        sdpa_sets.append((ot, (qt, kt, vt), do.transpose(1, 2).contiguous()))
    bwd = lambda q, k, v, o, lse, do: flash_attention_bwd(q, k, v, o, lse, do,  # noqa: E731
                                                          causal=False)
    sdpa_bwd = lambda ot, leaves, dot: torch.autograd.grad(ot, leaves, dot,  # noqa: E731
                                                           retain_graph=True)
    queued = _queued_ms(bwd, bwd_sets, 10)
    flops = 5 * 2 * bw * h * s * s * d
    row("flash_attention_bwd", AUDIO_ARCH, "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
        "none (the reference differentiates jnp chunked_attention, "
        "src/repro/models/layers.py:76)", shape, _time_ms(bwd, bwd_sets, 10),
        _time_ms(lambda *t: ref.flash_attention_bwd_ref(*t, causal=False), bwd_sets[:2], 3),
        _time_ms(sdpa_bwd, sdpa_sets, 10),
        (4 * bw * s * h * d + 4 * bw * s * kh * d) * elem + bw * h * s * 4, flops,
        device_ms=_graph_ms(bwd, bwd_sets, 5), device_queued_ms=queued,
        library_device_queued_ms=_queued_ms(sdpa_bwd, sdpa_sets, 10),
        library_note="SDPA's backward alone", tflops=flops / (queued * 1e-3) / 1e12)
    del sets, lib_sets, bwd_sets, sdpa_sets

    # the cross-entropy forward at hubert-xlarge's untied 504-unit head
    cfg = get_config(AUDIO_ARCH)
    t, dm, vocab = bw * s, cfg.d_model, cfg.vocab_size
    xs = [_xent_inputs(t, dm, vocab, bf16, "dense", 4, gen) for _ in range(4)]
    kern = lambda x, w, lab: fused_xent(x, w, lab)   # noqa: E731
    lib = lambda x, w, lab: F.cross_entropy(x @ w, lab, reduction="none")   # noqa: E731
    row("fused_xent", AUDIO_ARCH, "src/repro_torch/kernels/csrc/fused_xent.cu",
        "src/repro/kernels/fused_xent.py:85", f"T={t}, D={dm}, V={vocab}, untied, bf16",
        _time_ms(kern, xs, 10), _time_ms(lambda x, w, lab: ref.fused_xent_ref(x, w, lab), xs, 3),
        _time_ms(lib, xs, 10), (t * dm + vocab * dm) * elem + t * 8 + 2 * t * 4,
        2 * t * dm * vocab, device_ms=_graph_ms(kern, xs, 5),
        library_device_ms=_graph_ms(lib, xs, 5))
    del xs

    # flash-decode at the group-8 serving caches
    w = PROMPT + GEN
    nv = torch.full((BATCH,), w, dtype=torch.int32, device=DEVICE)
    for arch in (VISION_ARCH, MOE_ARCH):
        a = _attn(arch)
        h, kh, d = a["h"], a["kh"], a["d"]
        sets = [_decode_inputs(BATCH, w, h, kh, d, d, bf16, "dense", gen) for _ in range(8)]
        kern = lambda q, k, v: decode_attention(q, k, v, nv)   # noqa: E731
        lib_sets = [(q[:, :, None, :], k.transpose(1, 2).contiguous(),
                     v.transpose(1, 2).contiguous()) for q, k, v in sets]
        if not gqa:
            lib_sets = [(q, k.repeat_interleave(h // kh, 1), v.repeat_interleave(h // kh, 1))
                        for q, k, v in lib_sets]
        sdpa = lambda q, k, v: F.scaled_dot_product_attention(q, k, v, **kw)  # noqa: E731
        row("decode_attention", arch, "src/repro_torch/kernels/csrc/decode_attention.cu",
            "src/repro/kernels/decode_attention.py:55",
            f"B={BATCH}, S={w}, H={h}, KH={kh}, D={d}, n_valid {w}, bf16",
            _time_ms(kern, sets, 20),
            _time_ms(lambda q, k, v: ref.decode_attention_ref(q, k, v, nv), sets, 5),
            _time_ms(sdpa, lib_sets, 20),
            (2 * BATCH * h * d + 2 * BATCH * w * kh * d) * elem + 4 * BATCH,
            2 * BATCH * h * w * (d + d), device_ms=_graph_ms(kern, sets, 20),
            library_device_ms=_graph_ms(sdpa, lib_sets, 20))
        del sets, lib_sets
    torch.cuda.empty_cache()
    print("front end and MoE kernel timings " + json.dumps(rows))
    return rows


TRACED_KERNELS = {"decode_attention": ("decode_mma_kernel", "decode_wide_kernel",
                                       "decode_f32_kernel", "decode_combine_kernel"),
                  "flash_attention": ("flash_fwd_wgmma_kernel", "flash_fwd_kernel"),
                  "flash_attention_bwd": ("flash_bwd_wgmma_kernel", "flash_bwd_wide_kernel",
                                          "bwd_f32_kernel", "bwd_dot_kernel", "cast_dq_kernel",
                                          "cast_f32_kernel"),
                  "fused_xent": ("xent_wgmma_kernel", "xent_f32_kernel", "xent_combine_kernel"),
                  "rwkv_scan_bwd": ("rwkv_bwd_local_kernel", "rwkv_bwd_carry_kernel",
                                    "rwkv_bwd_walk_kernel", "rwkv_bwd_du_kernel"),
                  "ssm_scan_bwd": ("ssm_bwd_local_kernel", "ssm_bwd_carry_kernel",
                                   "ssm_bwd_walk_kernel", "ssm_bwd_combine_kernel")}


def _trace(fn, calls):
    """Per call: host wall time under the profiler; the device's busy time
    (the sum of its kernel and copy events) and share of that wall time; the
    six kernels that took longest; and, per slot kind of the training ring
    (the driver's ``roundpipe.F``, ``.FB``, ``.B`` and ``.apply_updates``
    ranges, which the trace also lays on the device's timeline), the summed
    time of the device events that start inside that kind's ranges."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the raw Kineto events: ``prof.events()`` builds the CPU call tree too,
    # which takes ~36 s for a traced chained call of two full-width steps
    # (365,000 events) where these take ~3
    device = [(e.name(), e.start_ns(), e.duration_ns())
              for e in prof.profiler.kineto_results.events()
              if e.device_type() == torch.autograd.DeviceType.CUDA]
    ranges = sorted((t0_ns, t0_ns + d, name.removeprefix("roundpipe."))
                    for name, t0_ns, d in device if name.startswith("roundpipe."))
    # the cross-entropy's dense copy of an untied head, a named range too
    head_rows = [d for name, _, d in device if name == "fused_xent.head_rows"]
    events = [e for e in device if not e[0].startswith(("roundpipe.", "fused_xent."))]
    if not events:
        return "not measured: the trace holds no CUDA events"
    busy = sum(d for _, _, d in events) / 1e6
    by_kind, by_name = {}, {}
    starts = [r[0] for r in ranges]
    for name, t0_ns, d in events:
        us = d / 1e3
        by_name[name] = by_name.get(name, 0.0) + us
        i = bisect.bisect_right(starts, t0_ns) - 1
        kind = ranges[i][2] if i >= 0 and t0_ns < ranges[i][1] else "outside"
        by_kind[kind] = by_kind.get(kind, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"wall_ms": wall * 1e3 / calls, "device_busy_ms": busy / calls,
           "busy_share": busy / (wall * 1e3), "device_events": len(events) / calls,
           "top_ms": {name[:60]: us / 1e3 / calls for name, us in top}}
    if head_rows:
        out["xent_head_rows_ms"] = sum(head_rows) / 1e6 / calls
        out["xent_head_rows_calls"] = len(head_rows) / calls
    dequant = sum(us for name, us in by_name.items() if "dequant_kernel" in name)
    if dequant:
        out["dequant_ms"] = dequant / 1e3 / calls
    scans = {k: sum(us for name, us in by_name.items() if f"{k}_kernel" in name)
             for k in ("rwkv_scan", "ssm_scan")}
    out.update({f"{k}_ms": us / 1e3 / calls for k, us in scans.items() if us})
    attention = {k: sum(us for name, us in by_name.items() if any(p in name for p in parts))
                 for k, parts in TRACED_KERNELS.items()}
    out.update({f"{k}_ms": us / 1e3 / calls for k, us in attention.items() if us})
    if ranges:
        out["slot_kinds_ms"] = {k: us / 1e3 / calls for k, us in sorted(by_kind.items())}
    return out


def _row(name, source, replaces, launches, errs, ms, plain_ms, lib_ms, nbytes, flops, dtype):
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    return {"name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[name], "max_abs_err": errs[name], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(t_bytes, t_ops),
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": lib_ms, "main_shape_err": errs[f"{name}@main"]}


def _timed_phase(name, fn, seconds: list, held: list):
    """``fn`` that appends (its name, its seconds) to ``seconds`` and (its
    name, the device GB still allocated as it ends and after a
    ``gc.collect()``) to ``held``. The collection frees device tensors that
    only reference cycles still hold, which would otherwise count toward the
    peak memory of a later phase whenever Python's collector happens not to
    have run."""
    import torch

    def run(*args, **kwargs):
        t0 = time.perf_counter()
        try:
            return fn(*args, **kwargs)
        finally:
            seconds.append((name, round(time.perf_counter() - t0, 1)))
            ended = torch.cuda.memory_allocated()
            gc.collect()
            held.append((name, round(ended / 1e9, 3),
                         round(torch.cuda.memory_allocated() / 1e9, 3)))
    return run


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script runs only on a card",
              file=sys.stderr)
        return 1
    sys.path.insert(0, str(ROOT / "src"))
    import repro_torch  # noqa: F401  (fails here when run outside the repository)

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")

    seconds = []          # every phase's host seconds, printed before the card's line
    held = []             # the device memory each phase leaves allocated
    for name, fn in list(globals().items()):
        if name.startswith("phase_"):
            globals()[name] = _timed_phase(name, fn, seconds, held)
    smi = phase_device()
    phase_build()
    errs = phase_kernels()
    errs.update(phase_train_kernels())
    errs.update(phase_dequant_kernel())
    errs.update(phase_scan_kernels())
    errs.update(phase_scan_bwd_kernels())
    served, launches = phase_serve()
    rows = phase_timings(served, errs, launches)
    del served
    recurrent = {}
    for arch, prompt in ((RWKV_ARCH, RWKV_PROMPT), (HYBRID_ARCH, HYBRID_PROMPT)):
        run_launches, recurrent[arch] = phase_serve_recurrent(arch, prompt)
        for name, n in run_launches.items():
            launches[name] = launches.get(name, 0) + n
    recurrent_train, run_launches = phase_recurrent_train()
    for name, n in run_launches.items():
        launches[name] = launches.get(name, 0) + n
    scan_rows = phase_scan_timings(errs, launches, recurrent)
    scan_rows += phase_scan_bwd_timings(errs, launches)
    phase_hybrid_attention_timings(rows, errs)
    out, train_launches, peak = phase_train()
    losses, times, traced = phase_repeated_batch(out)
    ring = phase_ring_vs_single()
    bit_identity = phase_ring_bit_identity()
    quant = {pool: phase_quant_train(pool, compress)
             for pool, compress in (("none", "none"), ("int8", "int8"), ("int4", "int8"))}
    lora = {"lora_r8": phase_lora_train(),
            "lora_r8_int4_R2": phase_lora_train("int4", "int8", QUANT_MICRO)}
    lora_ring = phase_lora_ring_vs_single()
    chained = {"dense_K4": phase_async_train(),
               "lora_r8_K4": phase_async_train(lora=True),
               "int8_ef_R2_K2": phase_async_train(k=2, steps=4, pool_dtype="int8",
                                                  grad_compress="int8",
                                                  microbatches=QUANT_MICRO)}
    chained_vs_oracle = phase_async_vs_staleness1()
    host_async = phase_host_async()
    resume = phase_resume()
    chaos = phase_chaos()
    supervised = phase_supervised_launcher()
    rotation = phase_rotation_trace()
    wide = {arch: phase_wide_serve(arch) for arch in WIDE_SERVE_ARCHS}
    wide["train"] = phase_wide_train()
    wide["ring_vs_single"] = phase_wide_ring_vs_single()
    wide_launches = {}                       # the wide instances: each arch's runs
    for arch, run in [(arch, wide[arch]) for arch in WIDE_SERVE_ARCHS] + [(WIDE_ARCH,
                                                                            wide["train"])]:
        for name, n in run["launches"].items():
            wide_launches[f"{name}@{arch}"] = wide_launches.get(f"{name}@{arch}", 0) + n
    for name, n in train_launches.items():   # launches over every main-path run
        launches[name] = launches.get(name, 0) + n
    for q in [*quant.values(), *lora.values(), *chained.values(), chaos,
              *supervised.values()]:
        for name, n in q["launches"].items():
            launches[name] = launches.get(name, 0) + n
    for row in rows:
        row["launches"] = launches[row["name"]]
    rows += phase_train_timings(errs, launches)
    rows.append(phase_dequant_timings(errs, launches))
    rows += scan_rows
    rows += phase_wide_timings(errs, wide_launches)
    family = {"frontend_serve": phase_frontend_serve(), "frontend_train": phase_frontend_train(),
              "moe_serve": phase_moe_serve(), "moe_lora_train": phase_moe_lora_train()}
    family_launches = {}                     # the instances: each arch's runs
    for arch, run in ((VISION_ARCH, family["frontend_serve"]),
                      (AUDIO_ARCH, family["frontend_train"]), (MOE_ARCH, family["moe_serve"]),
                      (MOE_ARCH, family["moe_lora_train"])):
        for name, n in run["launches"].items():
            family_launches[f"{name}@{arch}"] = family_launches.get(f"{name}@{arch}", 0) + n
    rows += phase_family_timings(errs, family_launches)
    tokens = TRAIN_BATCH * TRAIN_SEQ
    warm = sorted(out["step_s"][1:] + times)
    timings = {"train_run_step_ms": [x * 1e3 for x in out["step_s"]],
               "repeated_batch_step_ms": [x * 1e3 for x in times],
               "warm_step_ms_median": warm[len(warm) // 2] * 1e3,
               "warm_tok_per_s": tokens / warm[len(warm) // 2],
               "peak_memory_gb": peak / 1e9, "losses": out["losses"],
               "repeated_batch_losses": losses, "ring_vs_single": ring,
               "traced_step": traced}
    print("train timings " + json.dumps(timings))
    print("quantized train timings " + json.dumps(
        {"ring_bit_identity": bit_identity,
         **{f"pool_{pool}_R{QUANT_MICRO // TRAIN_WORKERS}": q for pool, q in quant.items()}}))
    dense_warm = sorted(out["step_s"][1:])
    print("lora train timings " + json.dumps(
        {**lora, "ring_vs_single": lora_ring,
         "dense_one_round": {"warm_step_ms_median": dense_warm[len(dense_warm) // 2] * 1e3,
                             "peak_memory_gb": peak / 1e9, "traced_step": traced}}))
    print("async train timings " + json.dumps(
        {**chained, "vs_staleness1": chained_vs_oracle, "host_resident": host_async,
         "resume": resume,
         "dense_sync_one_round": {"warm_step_ms_median": dense_warm[len(dense_warm) // 2] * 1e3,
                                  "peak_memory_gb": peak / 1e9, "traced_step": traced}}))
    print("supervisor timings " + json.dumps(
        {"chaos": chaos, "supervised_launcher": supervised, "rotation_traced_step": rotation,
         "dense_sync_one_round": {"traced_step": traced}}))
    print("wide timings " + json.dumps(wide))
    print("front end and MoE timings " + json.dumps(family))
    print("recurrent train timings " + json.dumps(recurrent_train))
    print("phase seconds " + json.dumps(seconds))
    print("device GB held after each phase (as it ended, after gc.collect) "
          + json.dumps(held))
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
