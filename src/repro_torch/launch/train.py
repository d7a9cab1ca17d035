"""Training launcher of the port: the RoundPipe ring on one card,
synchronous or chained staleness-1, checkpointed and restartable.

  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --strategy roundpipe --mesh 1x4 --batch 8 --seq 1024 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --strategy roundpipe --mesh 1x4 --batch 8 --seq 1024 --microbatches 8 \\
      --pool-dtype int8 --grad-compress int8 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --strategy roundpipe --mesh 1x4 --batch 8 --seq 1024 --lora-rank 8 --steps 3
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b \\
      --strategy roundpipe --mesh 1x4 --batch 8 --seq 1024 --async-opt --async-steps 4 --steps 8
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
      --strategy roundpipe --mesh 1x4 --steps 4 --ckpt-dir D --ckpt-every 2 --device cpu

The flags are those of ``repro.launch.train`` (``docs/cli.md``) and
``--device``. ``--mesh 1xN`` runs N logical ring workers on the one device,
with the chunked standby prefetch; ``--microbatches M`` runs R = M/N rounds
per step from round-major batches; ``--pool-dtype`` streams the pool as int8
or int4 codes; ``--grad-compress int8`` makes the deposits error-feedback
int8; ``--lora-rank r`` fine-tunes rank-r adapters over a frozen base
(``--lora-alpha``, ``--lora-targets``); ``--async-opt --async-steps K`` chains
K optimizer steps in one staleness-1 ring program (``--steps`` a multiple of
K); ``--schedule searched`` runs the searched schedule (a rotated winner is
refused). Steps run under ``runtime.FaultTolerantLoop``: with ``--ckpt-dir``
the state is saved every ``--ckpt-every`` optimizer steps (at chain ends
under ``--async-opt``) and a run resumes from the newest checkpoint there.
Unlike the reference, which defaults to ``/tmp/repro_ckpt``, ``--ckpt-dir``
defaults to none: no checkpoint is written or read unless asked for (a
full-width train state is ~24 GB). What the port does not run yet is
refused by name: a data axis, ``gspmd``, ``--elastic``, ``--async-ckpt`` and
training of the rwkv6 and hybrid families (their scan kernels are forward
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
                    help="tick-program selector: 'hand' runs plan.tick_program; 'searched' "
                         "scores the schedule family with simulate_plan and runs the certified "
                         "winner (a winner that rotates the ring is refused)")
    ap.add_argument("--lr", type=float, default=3e-4)
    ap.add_argument("--ckpt-dir", default=None,
                    help="save atomic checkpoints here and resume from the newest one; none "
                         "by default (the reference defaults to /tmp/repro_ckpt)")
    ap.add_argument("--ckpt-every", "--save-every", type=int, default=50, dest="ckpt_every",
                    help="with --ckpt-dir: save every K optimizer steps")
    ap.add_argument("--async-opt", action="store_true",
                    help="staleness-1 optimizer: --async-steps optimizer steps chain back to "
                         "back in one ring program (fill/drain paid once per chain)")
    ap.add_argument("--async-steps", type=int, default=4,
                    help="with --async-opt: optimizer steps chained per program call; must "
                         "divide --steps")
    ap.add_argument("--elastic", action="store_true", help="not ported yet")
    ap.add_argument("--async-ckpt", action="store_true", help="not ported yet")
    ap.add_argument("--straggler-factor", type=float, default=2.0,
                    help="a step slower than FACTOR x the trailing median is counted a "
                         "straggler")
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
        "--elastic (item 11)": args.elastic,
        "--async-ckpt (item 11)": args.async_ckpt,
    }
    return [name for name, hit in later.items() if hit]


class _NoCheckpoints:
    """The checkpoint manager of a run without ``--ckpt-dir``."""

    def restore_or_init(self, init_fn, like, device=None):
        return init_fn(), 0

    def maybe_save(self, step, state) -> bool:
        return False


def run_training(args) -> dict:
    """The launcher body: build everything from ``args`` and train.

    Returns ``{"state", "losses", "steps", "resumed_from", "step_s", "plan",
    "loop"}``: the final train state, the loss of every optimizer step run,
    the optimizer-step count reached, the checkpoint step resumed from (or
    None), each optimizer step's host seconds (a chained call's seconds,
    ending on a device synchronise, split evenly over its steps), the
    executed plan and the ``FaultTolerantLoop``."""
    n_data, n_model = (int(x) for x in args.mesh.split("x"))
    refused = _refusals(args, n_data)
    if refused:
        raise SystemExit("not ported yet (ROADMAP.md, Queue 1): " + ", ".join(refused)
                         + "; the port runs the roundpipe ring on one device "
                           "(--strategy roundpipe --mesh 1xN)")
    k_chain = args.async_steps if args.async_opt else 1
    if args.async_opt and args.async_steps < 1:
        raise SystemExit("--async-steps must be >= 1")
    if args.async_opt and args.steps % args.async_steps:
        lo = args.steps - args.steps % args.async_steps or args.async_steps
        hi = (args.steps // args.async_steps + 1) * args.async_steps
        raise SystemExit(f"--steps {args.steps} must be a multiple of --async-steps "
                         f"{args.async_steps}: the chained program executes whole chains; "
                         f"choose e.g. {lo} or {hi}")

    import torch

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise SystemExit("CUDA is not available: the port trains on the card; "
                         "pass --device cpu to run its plain versions on the CPU")

    from repro_torch.checkpoint import CheckpointManager, latest_step, save_checkpoint
    from repro_torch.configs import smoke_config
    from repro_torch.core.dispatch import (build_roundpipe_async_train_step,
                                           build_roundpipe_train_step, init_roundpipe_state)
    from repro_torch.core.plan import plan_from_config, uniform_partition
    from repro_torch.core.simulator import search_schedule, simulate_plan
    from repro_torch.data import DataConfig, SyntheticLMDataset
    from repro_torch.launch.steps import StepConfig
    from repro_torch.models.config import get_config
    from repro_torch.models.lora import LoraConfig, adapter_params_per_layer
    from repro_torch.optim import OptConfig
    from repro_torch.runtime import FaultTolerantLoop, StragglerPolicy

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
    if args.schedule == "searched":
        sr = search_schedule(plan, m_sim, round_size=n_model, iterations=k_chain)
        print(f"searched schedule: '{sr.choice.name}' over {len(sr.scored)} candidates, "
              f"simulated bubble {sr.bubble:.4f} (hand {sr.hand_bubble:.4f})")
    if args.async_opt:
        sim_async = simulate_plan(plan, m_sim, round_size=n_model, iterations=k_chain)
        print(f"simulated cross-step bubble ({k_chain} chained steps, staleness-1): "
              f"{sim_async.bubble_ratio:.4f}")
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
    step_cfg = StepConfig(strategy="roundpipe", grad_accum=1, async_optimizer=args.async_opt,
                          sequence_parallel=n_model > 1, kv_chunk=min(1024, args.seq),
                          xent_chunk=min(256, args.seq), partition=plan,
                          lora=lora_cfg, n_microbatches=microbatches,
                          pool_dtype=args.pool_dtype, grad_compress=args.grad_compress,
                          schedule=args.schedule, opt=OptConfig(lr=args.lr))
    # round-major pipeline: synchronous multi-round steps take (R, B/R, S)
    # batches straight from the dataset, with no reshape in the step
    rounds_data = plan.rounds_for(microbatches) if microbatches and not args.async_opt else 0
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                         rounds=rounds_data))
    if args.async_opt:
        step, plan = build_roundpipe_async_train_step(cfg, n_model, step_cfg, args.batch,
                                                      args.seq, steps_per_call=k_chain,
                                                      plan=plan)
    else:
        step, plan = build_roundpipe_train_step(cfg, n_model, step_cfg, args.batch, args.seq,
                                                plan=plan, round_major=rounds_data > 0)

    def init():
        gen = torch.Generator(device=device).manual_seed(0)
        return init_roundpipe_state(gen, cfg, step_cfg, n_workers=n_model, device=device)

    # the state's structure and shapes, on the meta device, for a restore
    like = init_roundpipe_state(torch.Generator(), cfg, step_cfg, n_workers=n_model,
                                device="meta")
    resumed_from = latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if resumed_from is not None:
        print(f"resuming from checkpoint step {resumed_from} in {args.ckpt_dir}")
    mgr = (CheckpointManager(args.ckpt_dir, save_every=args.ckpt_every) if args.ckpt_dir
           else _NoCheckpoints())

    class _Batches:
        """The dataset's batches on the device; under --async-opt, K
        consecutive global batches stacked on a leading step axis, one
        chained-program call each."""

        def batch(self, call):
            bs = [data.batch(call * k_chain + j) for j in range(k_chain)]
            if not args.async_opt:
                return {k: torch.from_numpy(v).to(device) for k, v in bs[0].items()}
            return {k: torch.stack([torch.from_numpy(b[k]) for b in bs]).to(device)
                    for k in bs[0]}

    class _OptStepCkpt:
        """Keep the checkpoint counter in optimizer-step units while the loop
        counts chained calls: call c's checkpoint step is its last optimizer
        step (c+1)*K - 1, so sync and async runs share a --ckpt-dir."""

        def restore_or_init(self, init_fn, like, device=None):
            state, start_opt = mgr.restore_or_init(init_fn, like, device)
            calls, rem = divmod(start_opt, k_chain)
            if rem:
                # flooring to a chain boundary would apply the trailing rem
                # updates twice
                raise SystemExit(
                    f"checkpoint in {args.ckpt_dir} holds {start_opt} optimizer steps, not a "
                    f"multiple of --async-steps {k_chain}: resuming the chained program here "
                    f"would apply {rem} update(s) twice. Resume synchronously (drop "
                    f"--async-opt): synchronous checkpoints do not land on chain boundaries")
            return state, calls

        def maybe_save(self, call, state) -> bool:
            if not args.ckpt_dir or call % max(1, args.ckpt_every // k_chain):
                return False
            save_checkpoint(args.ckpt_dir, (call + 1) * k_chain - 1, state, keep=mgr.keep)
            return True

    losses, step_s = [], []
    n_calls = args.steps // k_chain

    def metrics_cb(call, m, dt):
        ls = [float(x) for x in m["loss"].reshape(-1)]
        losses.extend(ls)
        step_s.extend([dt / len(ls)] * len(ls))
        if call % args.log_every == 0 or call == n_calls - 1:
            gn = float(m["grad_norm"].reshape(-1)[-1])
            # label the chain's last optimizer step, whose loss is printed
            step_no = (call + 1) * len(ls) - 1
            print(f"step {step_no:5d} loss {ls[-1]:.4f} gnorm {gn:.3f} "
                  f"{dt * 1e3 / len(ls):7.1f} ms/step "
                  f"{len(ls) * args.batch * args.seq / dt:9.0f} tok/s", flush=True)

    loop = FaultTolerantLoop(step, _OptStepCkpt() if args.async_opt else mgr, _Batches(),
                             straggler=StragglerPolicy(factor=args.straggler_factor),
                             step_timeout_s=600.0)
    t_start = time.perf_counter()
    state, final = loop.run(init, like, n_calls, device=device, metrics_cb=metrics_cb)
    final *= k_chain
    dt = time.perf_counter() - t_start
    if losses:
        print(f"done: {final} steps in {dt:.1f}s; loss {losses[0]:.4f} -> {losses[-1]:.4f}; "
              f"stragglers={len(loop.stragglers)} restarts={loop.restarts}")
    else:
        print(f"done: {final} steps (all restored from checkpoint)")
    return {"state": state, "losses": losses, "steps": final, "resumed_from": resumed_from,
            "step_s": step_s, "plan": plan, "loop": loop}


def main(argv=None) -> dict:
    return run_training(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
