#!/usr/bin/env python3
"""Chip smoke of the PyTorch/H100 port (``src/repro_torch``).

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases, in order; any failure exits non-zero at once:
  1. the card's name and power limit, torch and CUDA versions;
  2. build every kernel of the serving path from ``src/repro_torch/kernels/csrc``;
  3. hold each kernel against its plain PyTorch version on the card, at the
     serving shapes and over an edge sweep, at the tolerances of
     ``tests/test_kernels.py`` (fp32 2e-5, bf16 2e-2);
  4. serve full-width qwen3-1.7b (bf16, random weights from a seeded
     ``torch.Generator`` on the card; batch 4, prompt 1024, 32 greedy tokens)
     through ``repro_torch.launch.serve.main`` with the kernels' launch counts
     set to 0 just before and read just after; check the counts, that the
     logits are finite, and that a decode step's logits match a prefill of the
     same prefix one token longer (bf16 and, at two layers, fp32);
  5. time the serving steps, and each kernel beside its plain version, its
     bound and ``torch.nn.functional.scaled_dot_product_attention`` (a
     yardstick only: the port never calls it);
  6. print the ``kernels`` JSON line, then the result line.
It exits non-zero without a result when no card is present.
"""
from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ARCH = "qwen3-1.7b"
DEVICE = "cuda"
BATCH, PROMPT, GEN = 4, 1024, 32
TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
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


def _trace(fn, calls):
    """Per call: host wall time under the profiler, the device's busy time
    (sum of its CUDA kernel and copy events), their count, and the four
    kernels that took longest."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    events = [e for e in prof.events() if e.device_type == torch.autograd.DeviceType.CUDA]
    if not events:
        return "not measured: the trace holds no CUDA events"
    by_name = {}
    for e in events:
        by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us()
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    return {"wall_ms": wall * 1e3 / calls,
            "device_busy_ms": sum(by_name.values()) / 1e3 / calls,
            "device_events": len(events) / calls,
            "top_ms": {name[:60]: us / 1e3 / calls for name, us in top}}


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
    served, launches = phase_serve()
    rows = phase_timings(served, errs, launches)
    print(smi)
    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
