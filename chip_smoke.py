#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero at once:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every kernel from ``src/repro_torch/kernels/csrc`` (four
     libraries: flash attention forward and backward, flash-decode, fused
     LM-head cross-entropy);
  3. hold each kernel against its plain PyTorch version on the card: the
     serving kernels at the serving shapes and over an edge sweep, at the
     tolerances of ``tests/test_kernels.py`` (fp32 2e-5, bf16 2e-2); the
     training kernels at the training shapes and over an edge sweep, the
     flash backward against ``ref.flash_attention_bwd_ref`` and against
     autograd of ``ref.flash_attention_ref``, the cross-entropy forward
     against ``ref.fused_xent_ref`` and the entry's gradients against its
     autograd (forwards fp32 2e-5 / bf16 2e-2, backwards fp32 1e-4 / bf16
     2e-2 on the relative norm);
  4. serve full-width qwen3-1.7b (bf16, random weights from a seeded
     ``torch.Generator`` on the card; batch 4, prompt 1024, 32 greedy tokens)
     through ``repro_torch.launch.serve.main`` with the kernels' launch counts
     set to 0 just before and read just after; check the counts, that the
     logits are finite, and that a decode step's logits match a prefill of the
     same prefix one token longer (bf16 and, at two layers, fp32);
  5. time the serving steps, and the serving kernels beside their plain
     versions, their bounds and ``scaled_dot_product_attention`` (a
     yardstick only: the port never calls it);
  6. train full-width qwen3-1.7b through ``repro_torch.launch.train`` (bf16
     weights, fp32 master, ``--mesh 1x4 --partition auto --batch 8 --seq
     1024 --steps 3``) with the counts set to 0 just before and read just
     after; check the counts against the plan, that every loss is finite,
     that the loss falls over 3 steps on one repeated batch (a fresh state,
     learning rate 1e-5), and that the
     ring's grads (kernels) match the single program's (plain versions) at
     full width, 2 layers, fp32 (loss rtol 1e-4, worst relative 5e-3);
  7. time the training step (host clock, peak memory, a ``torch.profiler``
     trace with the device time of each slot kind), and the training kernels
     beside their plain versions, their bounds and a library yardstick
     (SDPA's backward; ``F.cross_entropy(x @ W^T)``);
  8. print the card's line, the ``kernels`` JSON line, then the result line.
It exits non-zero without a result when no card is present.
"""
from __future__ import annotations

import bisect
import dataclasses
import json
import math
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "qwen3-1.7b"
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


def phase_build():
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    logs = _build.build()
    print(f"build: {time.perf_counter() - t0:.1f} s ({', '.join(logs) or 'cached'})")
    for name, log in logs.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


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
    cases = [("serving", BATCH, PROMPT, 16, 8, 128, 128, True, None, bf16, "bshd"),
             ("serving-f32", BATCH, PROMPT, 16, 8, 128, 128, True, None, f32, "bshd")]
    for dtype in (f32, bf16):       # the sweep of tests/test_kernels.py
        for s, h, kh, d in [(128, 4, 4, 32), (256, 8, 2, 16), (192, 4, 1, 64),
                            (128, 2, 2, 48)]:
            cases.append((f"sweep-s{s}-h{h}-kh{kh}-d{d}", 2, s, h, kh, d, d, True, None,
                          dtype, "bshd"))
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
    return cases


def _flash_inputs(b, s, h, kh, dh, dv, dtype, layout, gen):
    q = _rand((b, s, h, dh), dtype, gen)
    k = _rand((b, s, kh, dh), dtype, gen)
    v = _rand((b, s, kh, dv), dtype, gen)
    if layout == "bhsd":   # same values, stored head-major: strided (B,S,H,D) views
        q, k, v = (t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v))
    return q, k, v


def decode_cases():
    """(label, B, S, H, KH, Dh, Dv, n_valid, dtype, layout)."""
    import torch
    f32, bf16 = torch.float32, torch.bfloat16
    s_srv = PROMPT + GEN
    cases = [("serving", BATCH, s_srv, 16, 8, 128, 128, [s_srv, s_srv - 31, 1, 517][:BATCH], bf16,
              "dense"),
             ("serving-f32", BATCH, s_srv, 16, 8, 128, 128, [s_srv, 700, 1, 2][:BATCH], f32,
              "dense")]
    for dtype in (f32, bf16):       # the sweep of tests/test_kernels.py
        for s, h, kh, d in [(512, 8, 2, 32), (1024, 4, 4, 64), (384, 8, 1, 16)]:
            cases.append((f"sweep-s{s}-h{h}-kh{kh}-d{d}", 2, s, h, kh, d, d, [s, s // 3],
                          dtype, "dense"))
    cases += [("single-valid", 1, 256, 4, 2, 32, 32, 1, f32, "dense"),
              ("dv-ne-dh", 2, 300, 8, 2, 40, 32, [300, 7], f32, "dense"),
              ("g16", 2, 300, 16, 1, 128, 128, [299, 150], f32, "dense"),
              ("none-and-over", 2, 64, 4, 2, 32, 32, [0, 1000], f32, "dense"),
              ("strided", 2, 200, 16, 8, 128, 128, [200, 33], bf16, "sliced")]
    return cases


def _decode_inputs(b, s, h, kh, dh, dv, dtype, layout, gen):
    if layout == "sliced":  # views into wider tensors: non-packed strides
        q = _rand((b, h, 2 * dh), dtype, gen)[..., :dh]
        k = _rand((b, s, kh, 2 * dh), dtype, gen)[..., :dh]
        v = _rand((b, s, kh, 2 * dv), dtype, gen)[..., :dv]
        return q, k, v
    return (_rand((b, h, dh), dtype, gen), _rand((b, s, kh, dh), dtype, gen),
            _rand((b, s, kh, dv), dtype, gen))


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
    for label, b, s, h, kh, dh, dv, nv, dtype, layout in decode_cases():
        q, k, v = _decode_inputs(b, s, h, kh, dh, dv, dtype, layout, gen)
        n_valid = nv if isinstance(nv, int) else torch.tensor(nv, dtype=torch.int32,
                                                               device=DEVICE)
        got = decode_attention(q, k, v, n_valid)
        want = ref.decode_attention_ref(q, k, v, n_valid)
        errs[("decode_attention", label)] = _compare(f"decode_attention[{label}]", got, want,
                                                     dtype)
    worst = {}
    for (name, label), e in errs.items():
        worst[name] = max(worst.get(name, 0.0), e)
    print("kernels vs plain: " + ", ".join(
        f"{name} {len([1 for n, _ in errs if n == name])} cases, serving err "
        f"{errs[(name, 'serving')]:.3e}, worst {worst[name]:.3e}" for name in worst))
    return {name: errs[(name, "serving")] for name in worst}


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
    training shapes (one worker's group of the ring), the sweep of
    tests/test_kernels.py, and the edges."""
    import torch
    from repro_torch.models.config import get_config
    cfg = get_config(ARCH)
    f32, bf16 = torch.float32, torch.bfloat16
    bw = TRAIN_BATCH // TRAIN_WORKERS
    shape = (bw, TRAIN_SEQ, cfg.n_heads, cfg.n_kv_heads, cfg.d_head, cfg.d_head, True, None)
    cases = [("training", *shape, bf16, "bshd"), ("training-f32", *shape, f32, "bshd")]
    for dtype in (f32, bf16):
        for s, h, kh, d in [(128, 4, 4, 32), (256, 8, 2, 16), (192, 4, 1, 64), (128, 2, 2, 48)]:
            cases.append((f"sweep-s{s}-h{h}-kh{kh}-d{d}", 2, s, h, kh, d, d, True, None,
                          dtype, "bshd"))
    cases += [("window-100", 1, 300, 4, 2, 64, 64, True, 100, f32, "bshd"),
              ("window-bf16", 1, 300, 4, 2, 64, 64, True, 100, bf16, "bshd"),
              ("bidirectional", 2, 130, 4, 4, 32, 32, False, None, f32, "bshd"),
              ("dv-ne-dh", 1, 128, 4, 4, 40, 32, True, None, f32, "bshd"),
              ("ragged-mqa", 2, 77, 8, 1, 64, 64, True, None, f32, "bshd"),
              ("ragged-training", 2, 1000, 16, 8, 128, 128, True, None, bf16, "bshd"),
              ("strided-bhsd", 2, 200, 8, 2, 128, 128, True, 64, bf16, "bhsd")]
    return cases


def xent_cases():
    """(label, T, D, V, dtype, layout, ignored share): the training shapes
    with the tied (V,D) head, the sweep of tests/test_kernels.py with a
    dense (D,V) head, and ragged T and V."""
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
    errs = {}
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
        errs[("flash_attention_bwd", label)] = err
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
    return {name: errs[(name, "training")] for name in ("flash_attention_bwd", "fused_xent")}


# ---------------------------------------------------------------------------
# Phase 4: the main path
# ---------------------------------------------------------------------------

def phase_serve():
    import torch
    from repro_torch.kernels.decode_attention import decode_attention
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.launch import serve
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models import transformer as T
    from repro_torch.models.config import get_config

    cfg = get_config(ARCH)
    torch.cuda.reset_peak_memory_stats()
    flash_attention.launches = 0
    decode_attention.launches = 0
    served = serve.main(["--arch", ARCH, "--batch", str(BATCH), "--prompt-len", str(PROMPT),
                         "--gen", str(GEN), "--device", DEVICE])
    launches = {"flash_attention": flash_attention.launches,
                "decode_attention": decode_attention.launches}
    print(f"main path launches: {launches}, peak memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    check(launches["flash_attention"] == cfg.n_layers,
          f"flash launches {launches['flash_attention']} != {cfg.n_layers}")
    check(launches["decode_attention"] == cfg.n_layers * GEN,
          f"decode launches {launches['decode_attention']} != {cfg.n_layers * GEN}")
    check(all(bool(torch.isfinite(lg).all()) for lg in served.logits), "non-finite logits")
    check(tuple(served.tokens.shape) == (BATCH, GEN), f"tokens {tuple(served.tokens.shape)}")

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
    truth, _ = build_prefill_step(cfg, PROMPT + 1)(_cast(served.params, torch.float32),
                                                   {"tokens": prefix})

    def rel(a, b):
        return ((a - b).norm() / b.norm()).item()

    print(f"decode vs prefill, bf16, {cfg.n_layers} layers, relative error: decode vs "
          f"fp32 {rel(got, truth):.3e}, prefill vs fp32 {rel(want, truth):.3e}, decode vs "
          f"prefill {rel(got, want):.3e} (max abs {(got - want).abs().max().item():.3e}, "
          f"logits max abs {truth.abs().max().item():.2f}); argmax agrees with fp32: decode "
          f"{(got.argmax(-1) == truth.argmax(-1)).float().mean().item():.2f}, prefill "
          f"{(want.argmax(-1) == truth.argmax(-1)).float().mean().item():.2f}")
    check(rel(got, want) <= 2e-2, "bf16 decode logits disagree with the prefill of the "
                                  "same prefix")
    check(rel(got, truth) <= 2e-2 and rel(want, truth) <= 2e-2,
          "bf16 serving logits are off the fp32 prefill of the same prefix")
    del truth

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
    print(f"decode vs prefill, fp32, 2 layers: max abs err {f32_err:.3e}")
    check(torch.allclose(step_logits, want32, rtol=1e-4, atol=1e-4),
          "fp32 decode logits disagree with the prefill of the same prefix")
    del p32, cache
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
    lib_ms = _time_ms(lambda q, k, v: F.scaled_dot_product_attention(q, k, v, is_causal=True,
                                                                     **kw), lib_sets, 10)
    elem = 2
    nbytes = (2 * BATCH * PROMPT * h * d + 2 * BATCH * PROMPT * kh * d) * elem
    pairs = PROMPT * (PROMPT + 1) // 2
    flops = 2 * BATCH * h * pairs * (d + d)
    out.append(_row("flash_attention", "src/repro_torch/kernels/csrc/flash_attention.cu",
                    "src/repro/kernels/flash_attention.py:78", launches, errs, ms, plain_ms,
                    lib_ms, nbytes, flops, "bfloat16"))
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
    lib_ms = _time_ms(lambda q, k, v: F.scaled_dot_product_attention(q, k, v, **kw),
                      lib_sets, 20)
    nbytes = (2 * BATCH * h * d + 2 * BATCH * w * kh * d) * elem + 4 * BATCH
    flops = 2 * BATCH * h * w * (d + d)
    out.append(_row("decode_attention", "src/repro_torch/kernels/csrc/decode_attention.cu",
                    "src/repro/kernels/decode_attention.py:55", launches, errs, ms, plain_ms,
                    lib_ms, nbytes, flops, "bfloat16"))
    del sets, lib_sets

    # serving steps, warm, timed on the host around a synchronise
    prefill = build_prefill_step(cfg, w)
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
    timings = {
        "serve_run": {"prefill_ms": served.t_prefill * 1e3,
                      "decode_ms_per_token": served.t_decode * 1e3 / GEN},
        "warm": {"prefill_ms": sorted(t_pre)[1] * 1e3,
                 "prefill_tok_per_s": BATCH * PROMPT / sorted(t_pre)[1],
                 "decode_ms_per_token": t_dec * 1e3 / GEN,
                 "decode_tok_per_s": BATCH * GEN / t_dec},
    }
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


def phase_train():
    import torch
    from repro_torch.launch import train

    counters = _train_counters()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    for fn in counters.values():
        fn.launches = 0
    argv = ["--arch", ARCH, "--strategy", "roundpipe", "--mesh", f"1x{TRAIN_WORKERS}",
            "--partition", "auto", "--batch", str(TRAIN_BATCH), "--seq", str(TRAIN_SEQ),
            "--steps", str(TRAIN_STEPS), "--log-every", "1", "--device", DEVICE]
    out = train.main(argv)
    launches = {name: fn.launches for name, fn in counters.items()}
    peak = torch.cuda.max_memory_allocated()
    plan = out["plan"]
    n, layers, f = TRAIN_WORKERS, plan.n_layers, plan.fused.size
    want = {"flash_attention": TRAIN_STEPS * n * (2 * layers - f),
            "flash_attention_bwd": TRAIN_STEPS * n * layers,
            "fused_xent": TRAIN_STEPS * n}
    print(f"train launches: {launches} (the plan predicts {want}; L={layers}, fused body "
          f"layers f={f}), peak memory {peak / 1e9:.2f} GB")
    check(launches == want, f"training launches {launches} != the plan's {want}")
    check(all(math.isfinite(x) for x in out["losses"]), f"non-finite losses {out['losses']}")
    return out, launches, peak


def phase_repeated_batch(out):
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
    cfg = get_config(ARCH)
    step_cfg = StepConfig(strategy="roundpipe", kv_chunk=min(1024, TRAIN_SEQ),
                          xent_chunk=min(256, TRAIN_SEQ), partition=out["plan"],
                          opt=OptConfig(lr=1e-5))
    step, _ = build_roundpipe_train_step(cfg, TRAIN_WORKERS, step_cfg, TRAIN_BATCH, TRAIN_SEQ,
                                         plan=out["plan"])
    gen = torch.Generator(device=DEVICE).manual_seed(0)
    state = {"s": init_roundpipe_state(gen, cfg, step_cfg, n_workers=TRAIN_WORKERS,
                                       device=DEVICE)}
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, TRAIN_SEQ, TRAIN_BATCH, seed=7))
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
    print(f"repeated batch (lr 1e-5): losses {losses}, step s {times}")
    check(all(math.isfinite(x) for x in losses), f"non-finite losses {losses}")
    check(losses[-1] < losses[0], f"loss does not fall on a repeated batch: {losses}")
    del state
    torch.cuda.empty_cache()
    return losses, times, traced


def phase_ring_vs_single():
    """Ring grads (kernels) against the single program's grads (the plain
    versions, called directly) at full width, 2 layers, fp32."""
    import torch
    from repro_torch.core.dispatch import build_roundpipe_grads_fn
    from repro_torch.core.plan import plan_from_config, uniform_partition
    from repro_torch.kernels import ops, ref
    from repro_torch.models import transformer as T
    from repro_torch.models.config import get_config
    from repro_torch.optim.adam import tree_leaves

    cfg = dataclasses.replace(get_config(ARCH), n_layers=2)
    # one layer per slot, so the check runs an F, the fused FB and a B slot
    plan = plan_from_config(cfg, TRAIN_WORKERS, partition=uniform_partition(2))
    gen = torch.Generator(device=DEVICE).manual_seed(5)
    params = T.init_params(cfg, gen, dtype=torch.float32, device=DEVICE)
    tokens = torch.randint(0, cfg.vocab_size, (TRAIN_WORKERS, 256), generator=gen, device=DEVICE)
    labels = torch.randint(0, cfg.vocab_size, (TRAIN_WORKERS, 256), generator=gen, device=DEVICE)
    labels[:, ::5] = -100
    batch = {"tokens": tokens, "labels": labels}
    counters = _train_counters()
    before = {k: fn.launches for k, fn in counters.items()}
    grads, loss, _ = build_roundpipe_grads_fn(cfg, TRAIN_WORKERS, plan)(params, batch)
    ring = {k: fn.launches for k, fn in counters.items()}
    check(all(ring[k] > before[k] for k in counters),
          "the ring did not run through every training kernel")

    plain = {"flash_attention": ops.flash_attention, "fused_xent": ops.fused_xent}
    ops.flash_attention = ref.flash_attention_ref
    ops.fused_xent = lambda x, w, lab, ignore_index=-100: ref.fused_xent_ref(
        x, w, lab, ignore_index=ignore_index)
    try:
        leaves = tree_leaves(params)
        for x in leaves:
            x.requires_grad_()
        want_loss = T.loss_fn(params, batch, cfg, remat=False)
        want = torch.autograd.grad(want_loss, leaves)
    finally:
        ops.flash_attention, ops.fused_xent = plain["flash_attention"], plain["fused_xent"]
    check({k: fn.launches for k, fn in counters.items()} == ring,
          "the single-program oracle launched a kernel")
    got = tree_leaves(grads)
    check(len(got) == len(want), "ring grads and single-program grads differ in structure")
    worst = max(((g - w).abs().max() / (w.abs().max() + 1e-6)).item() for g, w in zip(got, want))
    want_loss = want_loss.item()
    rel_loss = abs(float(loss) - want_loss) / abs(want_loss)
    print(f"ring vs single program, fp32, full width, 2 layers, plan {plan.describe()}: loss "
          f"{float(loss):.6f} vs {want_loss:.6f} (rel {rel_loss:.2e}), worst relative "
          f"grad error {worst:.3e} over {len(got)} leaves")
    check(rel_loss <= 1e-4, "ring loss disagrees with the single program")
    check(worst < 5e-3, "ring grads disagree with the single program")
    return {"loss_rel": rel_loss, "worst_rel": worst}


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
    lib_ms = _time_ms(lambda ot, leaves, dot: torch.autograd.grad(ot, leaves, dot,
                                                                  retain_graph=True), lib, 10)
    elem = 2
    # read q, k, v, o, dO and lse once; write dq, dk and dv once
    nbytes = (4 * bw * s * h * d + 4 * bw * s * kh * d) * elem + bw * h * s * 4
    pairs = s * (s + 1) // 2
    flops = 5 * 2 * bw * h * pairs * d
    out.append(_row("flash_attention_bwd", "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
                    "none (the reference differentiates jnp chunked_attention, "
                    "src/repro/models/layers.py:76)", launches, errs, ms, plain_ms, lib_ms,
                    nbytes, flops, "bfloat16"))
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
    out.append(_row("fused_xent", "src/repro_torch/kernels/csrc/fused_xent.cu",
                    "src/repro/kernels/fused_xent.py:85", launches, errs, ms, plain_ms, lib_ms,
                    nbytes, flops, "bfloat16"))
    return out


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
    device = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    ranges = sorted((e.time_range.start, e.time_range.end, e.name.removeprefix("roundpipe."))
                    for e in device if e.name.startswith("roundpipe."))
    events = [e for e in device if not e.name.startswith("roundpipe.")]
    if not events:
        return "not measured: the trace holds no CUDA events"
    busy = sum(e.time_range.elapsed_us() for e in events) / 1e3
    by_kind, by_name = {}, {}
    starts = [r[0] for r in ranges]
    for e in events:
        us = e.time_range.elapsed_us()
        by_name[e.name] = by_name.get(e.name, 0.0) + us
        i = bisect.bisect_right(starts, e.time_range.start) - 1
        kind = ranges[i][2] if i >= 0 and e.time_range.start < ranges[i][1] else "outside"
        by_kind[kind] = by_kind.get(kind, 0.0) + us
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:6]
    out = {"wall_ms": wall * 1e3 / calls, "device_busy_ms": busy / calls,
           "busy_share": busy / (wall * 1e3), "device_events": len(events) / calls,
           "top_ms": {name[:60]: us / 1e3 / calls for name, us in top}}
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
            "library_ms": lib_ms}


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

    smi = phase_device()
    phase_build()
    errs = phase_kernels()
    errs.update(phase_train_kernels())
    served, launches = phase_serve()
    rows = phase_timings(served, errs, launches)
    del served
    out, train_launches, peak = phase_train()
    losses, times, traced = phase_repeated_batch(out)
    ring = phase_ring_vs_single()
    for name, n in train_launches.items():   # launches over the two main-path runs
        launches[name] = launches.get(name, 0) + n
    for row in rows:
        row["launches"] = launches[row["name"]]
    rows += phase_train_timings(errs, launches)
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
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
