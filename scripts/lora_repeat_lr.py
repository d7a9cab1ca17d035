#!/usr/bin/env python3
"""Repeated-batch loss curves of a LoRA run at several learning rates.

Run from the repository root on a machine with the CUDA toolkit and a card:

    python3 scripts/lora_repeat_lr.py [--arch deepseek-v2-236b] [--layers 4]
        [--partition uniform] [--steps 6]

It trains ``--arch`` at full width and ``--layers`` of its layers through the
training launcher as ``chip_smoke.py``'s ``_lora_train`` does (LoRA rank 8
over the attention, one round on a ring of 4 logical workers, batch 8 x 1024,
3 steps at the launcher's lr 3e-4), then, from the launcher's final weights,
takes ``--steps`` steps on the repeated batch that ``_lora_train`` uses, once
for each pair of a learning rate and an optimizer state: the launcher's
AdamW moments carried on, or a fresh AdamW state. The adapters and the
optimizer state are restored between pairs; the frozen base is shared. It
prints the card's name and power limit and one ``repeat`` JSON line per pair.
"""
from __future__ import annotations

import argparse
import gc
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]

PAIRS = (("carried", 3e-4), ("carried", 1e-4), ("carried", 3e-5),
         ("fresh", 3e-4), ("fresh", 1e-4), ("fresh", 3e-5))


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--arch", default="deepseek-v2-236b")
    ap.add_argument("--layers", type=int, default=4)
    ap.add_argument("--partition", default="uniform")
    ap.add_argument("--steps", type=int, default=6)
    args = ap.parse_args()
    sys.path[:0] = [str(ROOT / "src"), str(ROOT)]
    import torch

    import chip_smoke as C
    from repro_torch.core.dispatch import build_roundpipe_train_step
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.kernels import _build
    from repro_torch.launch import train
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.config import get_config
    from repro_torch.models.lora import param_mask
    from repro_torch.optim import OptConfig
    from repro_torch.optim.adam import init_opt_state, trainable_leaves, tree_map

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, check=True).stdout.strip())
    _build.build(("flash_attention", "flash_attention_bwd", "fused_xent"))
    name = C._cut_arch(args.arch, n_layers=args.layers)
    cfg = get_config(name)
    lcfg = C._lora_cfg(cfg)
    out = train.main(["--arch", name, "--strategy", "roundpipe", "--mesh",
                      f"1x{C.TRAIN_WORKERS}", "--partition", args.partition, "--batch",
                      str(C.TRAIN_BATCH), "--seq", str(C.TRAIN_SEQ), "--lora-rank",
                      str(C.LORA_RANK), "--lora-targets", ",".join(lcfg.target_modules),
                      "--steps", str(C.TRAIN_STEPS), "--log-every", "1"])
    state, plan = out.pop("state"), out["plan"]
    params = state["params"]
    lora0 = tree_map(torch.clone, params["lora"])
    opt0 = tree_map(torch.clone, state["opt"])
    del state
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, C.TRAIN_SEQ, C.TRAIN_BATCH, seed=9))
    batch = {k: torch.from_numpy(v).to("cuda") for k, v in data.batch(0).items()}
    print("launcher " + json.dumps({"arch": name, "plan": plan.describe(),
                                    "losses": out["losses"]}))
    for kind, lr in PAIRS:
        step_cfg = StepConfig(strategy="roundpipe", kv_chunk=min(1024, C.TRAIN_SEQ),
                              xent_chunk=min(256, C.TRAIN_SEQ), partition=plan, lora=lcfg,
                              opt=OptConfig(lr=lr))
        step, _ = build_roundpipe_train_step(cfg, C.TRAIN_WORKERS, step_cfg, C.TRAIN_BATCH,
                                             C.TRAIN_SEQ, plan=plan)
        cur = {**params, "lora": tree_map(torch.clone, lora0)}
        opt = (init_opt_state(trainable_leaves(cur, param_mask(cur)), step_cfg.opt)
               if kind == "fresh" else tree_map(torch.clone, opt0))
        s, losses = {"params": cur, "opt": opt}, []
        for _ in range(args.steps):
            s, m = step(s, batch)
            losses.append(float(m["loss"]))
        print("repeat " + json.dumps({"opt_state": kind, "lr": lr, "losses": losses}),
              flush=True)
        del s, cur, opt, step
        gc.collect()
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
