"""Training launcher of the port: the synchronous RoundPipe step on one card.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --strategy roundpipe --mesh 1x4 --batch 8 --seq 1024 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
      --strategy roundpipe --mesh 1x4 --steps 2 --device cpu

The flags are those of ``repro.launch.train`` (``docs/cli.md``) and
``--device``. ``--mesh 1xN`` runs N logical ring workers on the one device.
What this slice does not run yet is refused by name: a data axis, ``gspmd``,
``--async-opt``, ``--elastic``, ``--async-ckpt``, ``--lora-rank``,
``--pool-dtype``, ``--grad-compress``, ``--microbatches``, ``--schedule
searched``, and checkpoints (``--ckpt-dir``, ``--ckpt-every``). Runs on the
card unless ``--device cpu``.
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
                    help="not ported yet: one round per step")
    ap.add_argument("--lora-rank", type=int, default=0, help="not ported yet")
    ap.add_argument("--lora-alpha", type=float, default=16.0, help="not ported yet")
    ap.add_argument("--lora-targets", default="attn,mlp", help="not ported yet")
    ap.add_argument("--pool-dtype", default="none", choices=["none", "int8", "int4"],
                    help="not ported yet")
    ap.add_argument("--grad-compress", default="none", choices=["none", "int8"],
                    help="not ported yet")
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
    later = {
        "--strategy gspmd": args.strategy != "roundpipe",
        f"a data axis of {n_data} (--mesh)": n_data != 1,
        "--async-opt": args.async_opt,
        "--elastic": args.elastic,
        "--async-ckpt": args.async_ckpt,
        "--lora-rank": args.lora_rank > 0,
        "--pool-dtype": args.pool_dtype != "none",
        "--grad-compress": args.grad_compress != "none",
        "--microbatches": args.microbatches != 0,
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
    from repro_torch.optim import OptConfig

    cfg = get_config(args.arch)
    if args.smoke:
        cfg = smoke_config(cfg)
    partition = uniform_partition(cfg.n_layers) if args.partition == "uniform" else None
    plan = plan_from_config(cfg, n_model, partition=partition)
    sim = simulate_plan(plan, n_model, round_size=n_model)
    print(plan.describe())
    print(f"simulated bubble ratio (1 round, M={n_model}): {sim.bubble_ratio:.4f}")
    step_cfg = StepConfig(strategy="roundpipe", grad_accum=1, async_optimizer=False,
                          sequence_parallel=n_model > 1, kv_chunk=min(1024, args.seq),
                          xent_chunk=min(256, args.seq), partition=plan,
                          opt=OptConfig(lr=args.lr))
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, args.seq, args.batch))
    step, plan = build_roundpipe_train_step(cfg, n_model, step_cfg, args.batch, args.seq,
                                            plan=plan)
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
