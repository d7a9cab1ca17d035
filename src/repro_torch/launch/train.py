"""Training launcher of the port: the synchronous RoundPipe step on one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --strategy roundpipe --mesh 1x4 --batch 8 --seq 1024 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --strategy roundpipe --mesh 1x4 --batch 8 --seq 1024 --microbatches 8 \\
      --pool-dtype int8 --grad-compress int8 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --strategy roundpipe --mesh 1x4 --batch 8 --seq 1024 --lora-rank 8 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
      --strategy roundpipe --mesh 1x4 --steps 2 --device cpu

The flags are those of ``repro.launch.train`` (``docs/cli.md``) and
``--device``. ``--mesh 1xN`` runs N logical ring workers on the one device,
with the chunked standby prefetch; ``--microbatches M`` runs R = M/N rounds
per step from round-major batches; ``--pool-dtype`` streams the pool as int8
or int4 codes; ``--grad-compress int8`` makes the deposits error-feedback
int8; ``--lora-rank r`` fine-tunes rank-r adapters over a frozen base
(``--lora-alpha``, ``--lora-targets``). What the port does not run yet is
refused by name: a data axis, ``gspmd``, ``--async-opt``, ``--elastic``,
``--async-ckpt``, ``--schedule searched``, checkpoints (``--ckpt-dir``,
``--ckpt-every``) and training of the rwkv6 and hybrid families (their scan kernels are forward
only; ``launch.serve`` serves both). Runs on the card unless ``--device cpu``.
"""
from __future__ import annotations

import argparse
import time


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True)
    ap.add_argument("--smoke", action="store_true",
                    help="use the reduced same-family config")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=128)
    ap.add_argument("--mesh", default="1x1",
                    help="DATAxMODEL; 1xN runs N logical ring workers on one device")
    ap.add_argument("--strategy", default="gspmd", choices=["gspmd", "roundpipe"],
                    help="the port runs roundpipe only")
    ap.add_argument("--partition", default="auto", choices=["auto", "uniform"],
                    help="roundpipe stage split: cost-model auto-partition or the "
                         "1-layer-per-stage split")
    ap.add_argument("--microbatches", type=int, default=0,
                    help="micro-batches per step M = R*N: R > 1 stitches R rounds back to "
                         "back per optimizer step, accumulating gradients across rounds; "
                         "0 -> one round (M = N)")
    ap.add_argument("--lora-rank", type=int, default=0,
                    help=">0 enables frozen-base LoRA fine-tuning at this adapter rank")
    ap.add_argument("--lora-alpha", type=float, default=16.0)
    ap.add_argument("--lora-targets", default="attn,mlp",
                    help="comma-separated module paths the adapters decorate")
    ap.add_argument("--pool-dtype", default="none", choices=["none", "int8", "int4"],
                    help="stream the resident pool quantized (blockwise-absmax codes + fp32 "
                         "scales, dequantized by the kernel at promote time); the master "
                         "weights stay full precision")
    ap.add_argument("--grad-compress", default="none", choices=["none", "int8"],
                    help="int8 error-feedback compressed gradient deposits; the residual "
                         "rides in the optimizer state")
    ap.add_argument("--schedule", default="hand", choices=["hand", "searched"],
                    help="'searched' is not ported yet")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="not ported yet: the port writes no checkpoints")
    ap.add_argument("--ckpt-every", "--save-every", type=int, default=None, dest="ckpt_every",
                    help="not ported yet: the port writes no checkpoints")
    ap.add_argument("--async-opt", action="store_true", help="not ported yet")
    ap.add_argument("--async-steps", type=int, default=4, help="not ported yet")
    ap.add_argument("--elastic", action="store_true", help="not ported yet")
    ap.add_argument("--async-ckpt", action="store_true", help="not ported yet")
    ap.add_argument("--straggler-factor", type=float, default=2.0, help="not ported yet")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="the device of the whole run; cpu runs the kernels' plain versions")
    return ap


def _refusals(args, n_data: int) -> list[str]:
    from repro_torch.models.config import get_config
    later = {
        "training of the rwkv6/hybrid families (the scans' backward kernels)":
            get_config(args.arch).block_kind in ("rwkv6", "hybrid"),
        "--strategy gspmd": args.strategy != "roundpipe",
        f"a data axis of {n_data} (--mesh)": n_data != 1,
        "--async-opt": args.async_opt,
        "--elastic": args.elastic,
        "--async-ckpt": args.async_ckpt,
        "--schedule searched": args.schedule != "hand",
        "--ckpt-dir (checkpoints)": args.ckpt_dir is not None,
        "--ckpt-every (checkpoints)": args.ckpt_every is not None,
    }
    return [name for name, hit in later.items() if hit]


def run_training(args) -> dict:
    """The launcher body: build everything from ``args`` and train.

    Returns ``{"state", "losses", "steps", "step_s", "plan"}``: the final
    train state, the loss of every step, the step count, each step's host
    seconds (ending on a device synchronise) and the executed plan."""
    n_data, n_model = (int(x) for x in args.mesh.split("x"))
    refused = _refusals(args, n_data)
    if refused:
        raise SystemExit("not ported yet (ROADMAP.md, Queue 1): " + ", ".join(refused)
                         + "; the port runs the synchronous roundpipe step on one "
                           "device (--strategy roundpipe --mesh 1xN)")

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the port trains on the card; "
                         "pass --device cpu to run its plain versions on the CPU")

    from repro_torch.configs import smoke_config
    from repro_torch.core.dispatch import build_roundpipe_train_step, init_roundpipe_state
    from repro_torch.core.plan import plan_from_config, uniform_partition
    from repro_torch.core.simulator import simulate_plan
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.config import get_config
    from repro_torch.models.lora import LoraConfig, adapter_params_per_layer
    from repro_torch.optim import OptConfig

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    lora_cfg = None
    if args.lora_rank > 0:
        lora_cfg = LoraConfig(rank=args.lora_rank, alpha=args.lora_alpha,
                              target_modules=tuple(t.strip() for t in args.lora_targets.split(",")
                                                   if t.strip()))
    partition = uniform_partition(cfg.n_layers) if args.partition == "uniform" else None
    plan = plan_from_config(cfg, n_model, partition=partition, lora=lora_cfg,
                            pool_dtype=args.pool_dtype)
    microbatches = args.microbatches or None
    m_sim = microbatches or n_model
    r_sim = plan.rounds_for(m_sim)
    sim = simulate_plan(plan, m_sim, round_size=n_model)
    print(plan.describe())
    print(f"simulated bubble ratio ({r_sim} round{'s' if r_sim != 1 else ''}, M={m_sim}): "
          f"{sim.bubble_ratio:.4f}")
    if lora_cfg is not None:
        full = plan_from_config(cfg, n_model, partition=plan.partition)
        up = sum(plan.stage_bytes) * r_sim
        down = sum(plan.stage_download_bytes) * r_sim
        full_down = sum(full.stage_download_bytes) * r_sim
        n_train = adapter_params_per_layer(cfg, lora_cfg) * cfg.n_layers
        print(f"LoRA r={lora_cfg.rank}: {n_train} trainable parameters; upload "
              f"{up / 2**20:.1f} MiB/step, grad download {down / 2**20:.3f} MiB/step (full "
              f"fine-tune would download {full_down / 2**20:.1f} MiB)")
    if args.pool_dtype != "none":
        dense = plan_from_config(cfg, n_model, partition=plan.partition, lora=lora_cfg)
        q_up = sum(plan.stage_bytes) * r_sim
        d_up = sum(dense.stage_bytes) * r_sim
        print(f"quantized pool ({args.pool_dtype}): upload {q_up / 2**20:.1f} MiB/step "
              f"({q_up / d_up:.3f}x of the dense {d_up / 2**20:.1f} MiB)")
    step_cfg = StepConfig(strategy="roundpipe", grad_accum=1, async_optimizer=False,
                          sequence_parallel=n_model > 1, kv_chunk=min(1024, args.seq),
                          xent_chunk=min(256, args.seq), partition=plan,
                          lora=lora_cfg, n_microbatches=microbatches,
                          pool_dtype=args.pool_dtype,
                          grad_compress=args.grad_compress, opt=OptConfig(lr=args.lr))
    # round-major pipeline: multi-round steps take (R, B/R, S) batches
    # straight from the dataset, with no reshape in the step
    rounds_data = plan.rounds_for(microbatches) if microbatches else 0
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                         rounds=rounds_data))
    step, plan = build_roundpipe_train_step(cfg, n_model, step_cfg, args.batch, args.seq,
                                            plan=plan, round_major=rounds_data > 0)
    gen = torch.Generator(device=device).manual_seed(0)
    state = init_roundpipe_state(gen, cfg, step_cfg, n_workers=n_model, device=device)

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)

    losses, step_s = [], []
    t_start = time.perf_counter()
    for s in range(args.steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in data.batch(s).items()}
        sync()
        t0 = time.perf_counter()
        state, metrics = step(state, batch)
        sync()
        dt = time.perf_counter() - t0
        step_s.append(dt)
        losses.append(float(metrics["loss"]))
        if s % args.log_every == 0 or s == args.steps - 1:
            print(f"step {s:5d} loss {losses[-1]:.4f} gnorm {float(metrics['grad_norm']):.3f} "
                  f"{dt * 1e3:7.1f} ms/step {args.batch * args.seq / dt:9.0f} tok/s", flush=True)
    dt = time.perf_counter() - t_start
    if losses:
        print(f"done: {args.steps} steps in {dt:.1f}s; loss {losses[0]:.4f} -> {losses[-1]:.4f}")
    else:
        print(f"done: {args.steps} steps")
    return {"state": state, "losses": losses, "steps": args.steps, "step_s": step_s,
            "plan": plan}


def main(argv=None) -> dict:
    return run_training(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
