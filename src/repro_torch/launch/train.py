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
  PYTHONPATH=src python -m repro_torch.launch.train --arch qwen3-1.7b --smoke \\
      --strategy roundpipe --mesh 1x4 --steps 4 --ckpt-dir D --ckpt-every 2 \\
      --elastic --async-ckpt --device cpu

The flags are those of ``repro.launch.train`` (``docs/cli.md``) and
``--device``. ``--mesh 1xN`` runs N logical ring workers on the one device,
with the chunked standby prefetch; ``--microbatches M`` runs R = M/N rounds
per step from round-major batches; ``--pool-dtype`` streams the pool as int8
or int4 codes; ``--grad-compress int8`` makes the deposits error-feedback
int8; ``--lora-rank r`` fine-tunes rank-r adapters over a frozen base
(``--lora-alpha``, ``--lora-targets``); ``--async-opt --async-steps K`` chains
K optimizer steps in one staleness-1 ring program (``--steps`` a multiple of
K); ``--schedule searched`` runs the searched schedule (its winner may
rotate the ring). Steps run under ``runtime.FaultTolerantLoop``: with
``--ckpt-dir`` the state is saved every ``--ckpt-every`` optimizer steps (at
chain ends under ``--async-opt``) and a run resumes from the newest
checkpoint there. Unlike the reference, which defaults to
``/tmp/repro_ckpt``, ``--ckpt-dir`` defaults to none: no checkpoint is
written or read unless asked for (a full-width train state is ~24 GB).
``--elastic`` and ``--async-ckpt`` run the steps under the goodput
supervisor (``runtime.Supervisor``) instead, which needs ``--ckpt-dir``: a
persistent straggler (``--straggler-factor``) rotates the ring, a dead
worker re-plans the ring for the survivors and resumes from the newest
checkpoint re-padded to the new pool depth, and ``--async-ckpt`` writes the
checkpoints on a background thread; both drive the synchronous step, from
flat batches. The recurrent families (rwkv6-7b, hymba-1.5b) train like the
dense ones: their scans run through the forward and backward scan kernels
on the card. What the port does not run yet is refused by name: a data axis
and ``gspmd``. Runs on the card unless ``--device cpu``.
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
                         "winner, which may rotate the ring's injection point (g0)")
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
    ap.add_argument("--elastic", action="store_true",
                    help="goodput supervisor: on a dead worker, re-plan the ring for the "
                         "survivors and resume from the newest checkpoint (needs --ckpt-dir)")
    ap.add_argument("--async-ckpt", action="store_true",
                    help="goodput supervisor with checkpoints written on a background "
                         "thread; the step pays only the device-to-host snapshot "
                         "(needs --ckpt-dir)")
    ap.add_argument("--straggler-factor", type=float, default=2.0,
                    help="a step slower than FACTOR x the trailing median is counted a "
                         "straggler; under the supervisor a worker that slow rotates the "
                         "ring")
    ap.add_argument("--log-every", type=int, default=10)
    ap.add_argument("--device", default="cuda",
                    help="the device of the whole run; cpu runs the kernels' plain versions")
    return ap


def _refusals(args, n_data: int) -> list[str]:
    later = {
        "--strategy gspmd": args.strategy != "roundpipe",
        f"a data axis of {n_data} (--mesh)": n_data != 1,
    }
    return [name for name, hit in later.items() if hit]


def _refuse_frontend(arch: str) -> None:
    """A front-end arch trains from (B,S,D) embeds, and the launcher's
    dataset makes token batches, as the reference launcher's does (which
    feeds them to a ring step built for embeds batches, so it cannot train
    such an arch either): refused by name."""
    from repro_torch.models.config import get_config
    frontend = get_config(arch).frontend
    if frontend:
        raise SystemExit(f"--arch {arch}: the {frontend} front-end arch trains from embeds "
                         "batches, which the launcher's token dataset does not make; train it "
                         "through core.dispatch.build_roundpipe_train_step with an embeds "
                         "batch")


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
    use_supervisor = args.elastic or args.async_ckpt
    if args.elastic and args.strategy != "roundpipe":
        raise SystemExit("--elastic requires --strategy roundpipe: elastic re-planning re-runs "
                         "the plan compiler for the surviving workers")
    if use_supervisor and args.async_opt:
        raise SystemExit("--elastic/--async-ckpt drive the synchronous step: drop --async-opt")
    if use_supervisor and not args.ckpt_dir:
        raise SystemExit("--elastic/--async-ckpt need --ckpt-dir: the supervisor restores "
                         "from and writes its checkpoints to a directory")
    _refuse_frontend(args.arch)
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
    # batches straight from the dataset, with no reshape in the step. The
    # supervisor keeps flat batches: a replay after an elastic re-plan must
    # feed the smaller ring the same samples a step
    rounds_data = (plan.rounds_for(microbatches)
                   if microbatches and not args.async_opt and not use_supervisor else 0)
    data = SyntheticLMDataset(DataConfig(cfg.vocab_size, args.seq, args.batch,
                                         rounds=rounds_data))
    resumed_from = latest_step(args.ckpt_dir) if args.ckpt_dir else None
    if resumed_from is not None:
        print(f"resuming from checkpoint step {resumed_from} in {args.ckpt_dir}")
    if use_supervisor:
        return _run_supervised(args, cfg, step_cfg, data, plan, n_model, device,
                               resumed_from)
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


def _run_supervised(args, cfg, step_cfg, data, plan, n_model: int, device,
                    resumed_from) -> dict:
    """The --elastic / --async-ckpt path: the goodput supervisor drives the
    synchronous train step through a runtime factory. A worker death rebuilds
    the ring for the survivors (the plan of ``replan_for_survivors``, its
    micro-batch count, the same device) and resumes through the elastic
    restore (``reshape_pooled_state``); a persistent straggler rebuilds the
    step with the rotated ``g0`` that the schedule search picks under the
    measured slowdown. Checkpoints go through the background writer with
    --async-ckpt."""
    import dataclasses

    import torch

    from repro_torch.core.dispatch import (build_roundpipe_train_step, init_roundpipe_state,
                                           reshape_pooled_state)
    from repro_torch.core.plan import replan_for_survivors
    from repro_torch.core.simulator import search_schedule
    from repro_torch.optim.adam import tree_map
    from repro_torch.runtime import StragglerPolicy, Supervisor

    losses, step_s = [], []
    plans = {n_model: (plan, step_cfg.n_microbatches)}     # ring size -> (plan, M)

    def make_runtime(*, n_workers, g0, use_async, replan=None):
        del use_async          # the launcher wires the synchronous step only
        if replan is not None:
            if args.batch % replan.n_microbatches:
                raise SystemExit(
                    f"elastic re-plan chose M={replan.n_microbatches} micro-batches for "
                    f"N={n_workers} survivors but --batch {args.batch} is not divisible by "
                    f"it: pick a global batch divisible by every worker count you intend "
                    f"to survive on")
            plans[n_workers] = (replan.plan, replan.n_microbatches)
        rt_plan, m = plans[n_workers]
        scfg = dataclasses.replace(step_cfg, partition=rt_plan, n_microbatches=m, g0=g0)
        step, _ = build_roundpipe_train_step(cfg, n_workers, scfg, args.batch, args.seq,
                                             plan=rt_plan)

        class _Runtime:
            like = init_roundpipe_state(torch.Generator(), cfg, scfg, n_workers=n_workers,
                                        device="meta")

            @staticmethod
            def init_state():
                gen = torch.Generator(device=device).manual_seed(0)
                return init_roundpipe_state(gen, cfg, scfg, n_workers=n_workers,
                                            device=device)

            @staticmethod
            def batch_for(i):
                return i, {k: torch.from_numpy(v).to(device) for k, v in data.batch(i).items()}

            @staticmethod
            def step_fn(state, step_batch):
                i, batch = step_batch
                t0 = time.perf_counter()
                state, metrics = step(state, batch)
                loss = float(metrics["loss"])
                dt = time.perf_counter() - t0
                losses.append(loss)
                step_s.append(dt)
                if i % args.log_every == 0:
                    print(f"step {i:5d} loss {loss:.4f} gnorm "
                          f"{float(metrics['grad_norm']):.3f} {dt * 1e3:7.1f} ms/step on "
                          f"N={n_workers} g0={g0}", flush=True)
                return state, metrics

            @staticmethod
            def adapt_state(host_state):
                return tree_map(lambda t: t.to(device),
                                reshape_pooled_state(host_state, cfg, n_workers))

            @staticmethod
            def rescore(scales):
                # the rotation family re-scored under the measured slowdown; the
                # winner's g0 is the next step's injection worker
                return search_schedule(rt_plan, m or n_workers, round_size=n_workers,
                                       device_scale=list(scales)).choice.g0

        return _Runtime()

    replan_fn = None
    if args.elastic:
        def replan_fn(n_surviving):
            return replan_for_survivors(cfg, n_surviving,
                                        n_microbatches=step_cfg.n_microbatches,
                                        lora=step_cfg.lora, pool_dtype=args.pool_dtype)

    sup = Supervisor(make_runtime, args.ckpt_dir, n_workers=n_model, replan_fn=replan_fn,
                     straggler=StragglerPolicy(factor=args.straggler_factor),
                     save_every=args.ckpt_every, async_ckpt=args.async_ckpt,
                     step_timeout_s=600.0)
    t0 = time.perf_counter()
    state, final = sup.run(args.steps)
    dt = time.perf_counter() - t0
    rep = sup.meter.report()
    print(f"done: {final} steps in {dt:.1f}s on N={sup.n_workers}; "
          f"goodput {rep['goodput']:.3f} (ckpt {rep['ckpt_s']:.2f}s replan "
          f"{rep['replan_s']:.2f}s replay {rep['replay_s']:.2f}s); "
          f"events={[e.kind for e in sup.events]}")
    if sup.ckpt_io:
        io = sup.ckpt_io
        print(f"async checkpoints: {io['written']} written; snapshot {io['snapshot_s']:.2f}s "
              f"on the caller, write {io['write_s']:.2f}s in the background")
    return {"state": state, "losses": losses, "steps": final, "resumed_from": resumed_from,
            "step_s": step_s, "plan": plan, "goodput": rep, "events": sup.events,
            "n_workers": sup.n_workers, "supervisor": sup}


def main(argv=None) -> dict:
    return run_training(build_parser().parse_args(argv))


if __name__ == "__main__":
    main()
