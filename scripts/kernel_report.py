#!/usr/bin/env python3
"""What the compiler made of the port's CUDA kernels, and flash-decode's
device time over split sizes.

Run from the repository root on a machine with the CUDA toolkit and a card:

    python3 scripts/kernel_report.py [NAME ...] [--dump DIR] [--sweep]

For each library NAME of ``repro_torch.kernels._build.KERNELS`` (default:
``decode_attention flash_attention``) it builds the library afresh, prints
ptxas's register, shared-memory and spill report for each of its kernels and
the counts of the SASS opcodes that say how it moves data and multiplies:
``LDG``/``LDGSTS``/``UTMALDG`` (global loads: plain, ``cp.async``, TMA),
``LDL``/``STL`` (local memory: spills), ``HMMA``/``HGMMA`` (``mma.sync``,
``wgmma``), ``SHFL``, ``MUFU`` (exponentials), ``BAR``/``SYNCS`` (barriers).
``--dump DIR`` writes each library's whole ``cuobjdump -sass`` listing to
``DIR/NAME.sass``. ``--sweep`` times flash-decode (summed kernel durations in
a ``torch.profiler`` trace) at the decode shapes of qwen3-1.7b (B=4, 1056
slots, H=16, KH=8, D=128) and hymba-1.5b (B=4, ring of 1024, H=25, KH=5,
D=64) over split sizes of 64-256 slots and over n_valid. Checks against the
plain versions and the timings beside SDPA are ``chip_smoke.py``'s.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
OPS = ("LDG", "LDGSTS", "UTMALDG", "LDS", "LDSM", "STS", "LDL", "STL", "HMMA", "HGMMA",
       "SHFL", "MUFU", "BAR", "SYNCS")


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
    """Flash-decode's device time at both decode shapes over split sizes and
    over n_valid (the plan's split size)."""
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
        for chunk in (64, 128, 192, 256):
            mod.decode_plan = lambda s_, b_, kh_, sms_, c=chunk: (-(-s_ // c), c)
            out[f"{label}_chunk{chunk}"] = _kernel_ms(
                lambda q, k, v: mod.decode_attention(q, k, v, nv), sets, 10)
        mod.decode_plan = plan
        for n in (1, s // 4, s // 2, s):
            nv_n = torch.full((b,), n, dtype=torch.int32, device="cuda")
            out[f"{label}_nvalid{n}"] = _kernel_ms(
                lambda q, k, v: mod.decode_attention(q, k, v, nv_n), sets, 10)
    print("decode chunk sweep " + json.dumps(out))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("names", nargs="*", default=["decode_attention", "flash_attention"])
    ap.add_argument("--dump", default=None)
    ap.add_argument("--sweep", action="store_true")
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    report(args.names, args.dump)
    if args.sweep:
        print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             check=True).stdout.strip())
        sweep_chunks()
    return 0


if __name__ == "__main__":
    sys.exit(main())
