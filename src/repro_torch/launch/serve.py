"""Serving launcher of the port: prefill a batch of prompts, then decode
greedily with batched steps. Runs on the card unless ``--device cpu``. A
front-end arch (``cfg.frontend``: internvl2-76b) prefills random bf16
embeds from the seeded generator in place of prompt tokens, then decodes
tokens, as the reference does; an encoder-only arch (hubert-xlarge) has no
decode path and is refused.

  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b \\
      --batch 4 --prompt-len 1024 --gen 32
  PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-1.7b --smoke --device cpu
"""
from __future__ import annotations

import argparse
import dataclasses
import time

import torch


@dataclasses.dataclass
class Served:
    """What one run served: its inputs (prompt tokens (B, S), or (B, S, D)
    embeds for a front-end arch), the greedy tokens (B, gen), the logits of
    the prefill and of every decode step, and host times in seconds that end
    on a device synchronise."""
    params: dict
    prompts: torch.Tensor
    tokens: torch.Tensor
    logits: list
    t_prefill: float
    t_decode: float


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def main(argv=None) -> Served:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=32)
    ap.add_argument("--gen", type=int, default=16)
    ap.add_argument("--mesh", default="1x1")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="accepted as in the reference; decoding is greedy")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    if args.mesh != "1x1":
        raise SystemExit(f"--mesh {args.mesh}: multi-card serving is not ported yet; "
                         "the port serves on one device (--mesh 1x1)")
    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the port serves on the card; "
                         "pass --device cpu to run its plain versions on the CPU")

    from repro_torch.configs import smoke_config
    from repro_torch.launch.steps import build_decode_step, build_prefill_step
    from repro_torch.models import transformer as T
    from repro_torch.models.config import get_config

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    if cfg.encoder_only:
        raise SystemExit("encoder-only arch has no decode path")
    max_len = args.prompt_len + args.gen

    gen = torch.Generator(device=device).manual_seed(0)
    params = T.init_params(cfg, gen, device=device)
    if cfg.frontend:
        prompts = torch.randn((args.batch, args.prompt_len, cfg.d_model), generator=gen,
                              device=device).to(torch.bfloat16)
    else:
        prompts = torch.randint(0, cfg.vocab_size, (args.batch, args.prompt_len),
                                generator=gen, device=device)
    prefill = build_prefill_step(cfg, max_len)
    decode = build_decode_step(cfg)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(params, {"embeds" if cfg.frontend else "tokens": prompts})
    _sync(device)
    t_prefill = time.perf_counter() - t0
    all_logits = [logits]
    out_tokens = []
    tok = logits.argmax(dim=-1)
    t0 = time.perf_counter()
    for _ in range(args.gen):
        out_tokens.append(tok)
        logits, cache = decode(params, cache, tok)
        all_logits.append(logits)
        tok = logits.argmax(dim=-1)
    _sync(device)
    t_decode = time.perf_counter() - t0
    tokens = torch.stack(out_tokens, dim=1)
    print(f"prefill: {args.batch}x{args.prompt_len} in {t_prefill * 1e3:.0f} ms "
          f"({args.batch * args.prompt_len / t_prefill:.0f} tok/s)")
    print(f"decode: {args.gen} steps in {t_decode * 1e3:.0f} ms "
          f"({args.batch * args.gen / max(t_decode, 1e-9):.0f} tok/s)")
    print("generated token ids (first sequence):", tokens[0].tolist())
    return Served(params, prompts, tokens, all_logits, t_prefill, t_decode)


if __name__ == "__main__":
    main()
