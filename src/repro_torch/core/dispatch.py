"""RoundPipe's synchronous training step on one card: the slot ring driver,
its builders and the train state.

The PyTorch counterpart of the sync dense path of ``repro/core/dispatch.py``
(``roundpipe_forward_backward`` at one round with whole-block injection,
``build_roundpipe_grads_fn``, ``build_roundpipe_train_step``,
``init_roundpipe_state``, ``resolve_plan``, ``pool_rows``, ``pad_pool``).

N logical workers run in one process on one device. Each owns its
micro-batch group, its activation, a stash of the L+1 layer boundaries, its
carried activation gradient and its shard of the pool (``plan.pool_layout``).
At tick t, worker w runs stitched slot t - w of the generated
``TickProgram``:

  * F slots fold their block over the worker's activation under
    ``torch.no_grad()``, stashing each layer's input;
  * the fused FB slot runs the deepest body block, the final norm and the
    LM-head loss under autograd and differentiates the loss with respect to
    the block, the final norm, the head and its input;
  * B slots recompute their block from the stashed boundary under autograd
    and take ``torch.autograd.grad`` with the carried gradient (the analogue
    of ``jax.vjp``).

A gradient buffer travels with each block; worker 0 adds first, then 1, up
to N-1, and the tail deposits the reduced rows to their owners, so the sums
run in the reference's order. Embedding gradients are scattered with
``index_add_``; a tied head adds its gradient, transposed, into ``embed``.
Returned grads hold exactly ``n_layers`` layers: there is no pad-then-slice.

Not ported yet, and refused by name: LoRA, the quantized pool and
compressed deposits, more than one round, prefetch, and ``g0 != 0``.
"""
from __future__ import annotations

import torch
from torch.profiler import record_function

from repro_torch.core.ring import (OneCardTransport, RingMachine, StepAccum, block_row,
                                   gbuf_add, zeros_block)
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.optim.adam import apply_updates, init_opt_state, tree_leaves, tree_map

_LATER = "is not ported yet (ROADMAP.md, Queue 1: {})"


def _refuse(what: str, item: str):
    raise NotImplementedError(f"{what} " + _LATER.format(item))


def _check_options(*, prefetch_program=None, lora=None, rounds=None, pool_dtype="none",
                   grad_compress="none", g0=0):
    if lora is not None:
        _refuse("LoRA (lora)", "LoRA")
    if pool_dtype != "none":
        _refuse(f"the quantized pool (pool_dtype={pool_dtype!r})",
                "the quantized pool and EF deposits")
    if grad_compress != "none":
        _refuse(f"compressed deposits (grad_compress={grad_compress!r})",
                "the quantized pool and EF deposits")
    if rounds is not None and rounds != 1:
        _refuse(f"rounds={rounds}", "prefetch and multi-round")
    if prefetch_program is not None:
        _refuse("prefetch (chunked standby injection)", "prefetch and multi-round")
    if g0 != 0:
        _refuse(f"ring rotation g0={g0}", "supervisor")


def _leaf(tree):
    """Detached copies that require grad (views, no data copied), so a slot
    differentiates with respect to them alone."""
    return tree_map(lambda a: a.detach().requires_grad_(), tree)


def _unflatten(tree, flat):
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


def roundpipe_forward_backward(params, batch, *, cfg: ModelConfig, plan, n_workers: int,
                               l_pad: int, xent_chunk: int = 256, kv_chunk: int = 1024,
                               ring_grad_dtype=torch.float32, prefetch_program=None, lora=None,
                               rounds=None, pool_dtype: str = "none",
                               grad_compress: str = "none", g0: int = 0, transport=None):
    """Run one step's slot ring over the global batch and return (grads,
    mean loss, token count).

    ``params['layers']`` is the pool as a list of per-layer dicts, padded
    to ``l_pad`` rows or not (only rows below ``n_layers`` are read).
    ``batch`` holds the global ``tokens`` and ``labels`` (B,S); worker w's
    micro-batch group is rows [w B/N, (w+1) B/N). ``transport`` moves blocks
    between the logical workers (``OneCardTransport`` by default)."""
    _check_options(prefetch_program=prefetch_program, lora=lora, rounds=rounds,
                   pool_dtype=pool_dtype, grad_compress=grad_compress, g0=g0)
    program = plan.tick_program(1)
    if "embeds" in batch:
        T.embed_inputs(params, batch, cfg)      # raises: the frontend is a later slice
    n = n_workers
    l_total = cfg.n_layers
    slots = plan.stages
    sf = plan.n_fwd
    s_total = plan.n_slots
    del kv_chunk                        # the flash kernel tiles by itself
    rm = RingMachine(cfg=cfg, plan=plan, n_workers=n, l_pad=l_pad,
                     transport=transport or OneCardTransport(n), xent_chunk=xent_chunk)
    pool = rm.shards(params["layers"])
    A = StepAccum
    head_w = T.lm_head_weights(params, cfg)
    tokens, labels = batch["tokens"], batch["labels"]
    if tokens.shape[0] % n:
        raise ValueError(f"global batch {tokens.shape[0]} does not divide over {n} workers")
    bw = tokens.shape[0] // n
    tok_w = [tokens[w * bw:(w + 1) * bw] for w in range(n)]
    lab_w = [labels[w * bw:(w + 1) * bw] for w in range(n)]
    dev = head_w.device

    # ---- per-worker state ----------------------------------------------------
    with torch.no_grad():
        x_emb = [T.embed_inputs(params, {"tokens": tok_w[w]}, cfg) for w in range(n)]
    act = [None] * n
    stash = [[None] * (l_total + 1) for _ in range(n)]
    grad_carry = [None] * n
    ring = [None] * n                   # traveling blocks
    gbuf = [None] * n                   # their traveling gradient buffers
    grad_shards = [[None] * rm.per for _ in range(n)]
    loss_sum = A.zeros((), torch.float32, dev)
    tok_count = A.zeros((), torch.int64, dev)
    embed_grad = A.zeros(params["embed"].shape, torch.float32, dev)
    head_grad = A.zeros(head_w.shape, torch.float32, dev)
    fnorm_grad = A.tree_zeros(params["final_norm"], torch.float32)

    def do_plain(w, spec, blk, fb):
        with torch.no_grad():
            x = x_emb[w] if fb == 0 else act[w]
            for k, lw in enumerate(blk):
                stash[w][spec.layers[k]] = x
                x = T.layer_forward(x, lw, cfg)
            act[w] = x

    def do_fused(w, spec, blk, fb):
        x_in = x_emb[w] if fb == 0 else act[w]          # fb == 0: Sf == 0 edge
        with torch.enable_grad():
            blk_l, fn_l = _leaf(blk), _leaf(params["final_norm"])
            hw_l, x_l = head_w.detach().requires_grad_(), x_in.detach().requires_grad_()
            tot, cnt = rm.fused_loss(blk_l, fn_l, hw_l, x_l, lab_w[w])
            wrt = tree_leaves(blk_l) + tree_leaves(fn_l) + [hw_l, x_l]
            grads = torch.autograd.grad(tot, wrt)
        nb = len(tree_leaves(blk_l))
        gbuf[w] = gbuf_add(gbuf[w], _unflatten(blk_l, grads[:nb]))
        A.tree_add_f32(fnorm_grad, _unflatten(fn_l, grads[nb:-2]))
        A.add_f32(head_grad, grads[-2])
        gx = grads[-1]
        if sf == 0 and spec.layers:
            A.token_add(embed_grad, tok_w[w], gx)
        A.add(loss_sum, tot.detach())
        A.add(tok_count, cnt)
        grad_carry[w] = gx.float()

    def do_bwd(w, spec, blk):
        x_in = stash[w][spec.start]
        with torch.enable_grad():
            blk_l, x_l = _leaf(blk), x_in.detach().requires_grad_()
            y = rm.stage_fwd(blk_l, x_l)
            wrt = tree_leaves(blk_l) + [x_l]
            grads = torch.autograd.grad(y, wrt, grad_outputs=grad_carry[w].to(y.dtype))
        gbuf[w] = gbuf_add(gbuf[w], _unflatten(blk_l, grads[:-1]))
        gx = grads[-1]
        if spec.start == 0 and spec.size > 0:
            A.token_add(embed_grad, tok_w[w], gx)
        grad_carry[w] = gx.float()

    # The driver consumes the generated schedule IR: tick t injects slot
    # entry[1] at worker 0; worker w holds stitched slot t - w.
    for rec in program.records:
        t = rec.t
        ring = rm.shift(ring)
        gbuf = rm.shift(gbuf)
        if rec.entry is not None:
            spec = slots[rec.entry[1]]
            ring[0] = rm.assemble_block(spec, pool)
            gbuf[0] = None if spec.kind == "F" else zeros_block(ring[0], ring_grad_dtype)
        for w in range(n):
            fb = t - w
            if not 0 <= fb < s_total:
                continue
            spec, blk = slots[fb], ring[w]
            # a named range per slot kind: a profiler trace reads each kind's
            # device time from it
            with record_function(f"roundpipe.{spec.kind}"):
                if fb < sf:
                    do_plain(w, spec, blk, fb)
                elif fb == sf:
                    do_fused(w, spec, blk, fb)
                else:
                    do_bwd(w, spec, blk)
        # the slot exiting at worker N-1 deposits its reduced rows
        if rec.deposit is not None:
            for k, lid in enumerate(slots[rec.deposit].layers):
                rm.deposit_plain(grad_shards, block_row(gbuf[n - 1], k), lid)

    layer_grads = [row for shard in grad_shards for row in shard][:l_total]
    if any(g is None for g in layer_grads):
        raise RuntimeError("a layer received no gradient deposit: the plan does not "
                           "cover every layer with a fused or backward slot")
    scale = 1.0 / torch.clamp(tok_count.float(), min=1.0)
    grads = {"embed": embed_grad, "layers": layer_grads, "final_norm": fnorm_grad}
    if "lm_head" in params:
        grads["lm_head"] = head_grad
    else:                                          # tied embeddings
        grads["embed"] = embed_grad.add_(head_grad.T)
    grads = tree_map(lambda g: g.mul_(scale), grads)
    return grads, loss_sum * scale, tok_count


# ---------------------------------------------------------------------------
# Builders
# ---------------------------------------------------------------------------

def resolve_plan(cfg: ModelConfig, step_cfg, n_workers: int):
    """The plan a roundpipe step executes: ``step_cfg.partition`` if set
    (a Partition or an ExecutionPlan), else auto-derived from the
    architecture's cost model (paper §4.4)."""
    from repro_torch.core.plan import ExecutionPlan, plan_from_config

    partition = getattr(step_cfg, "partition", None)
    if isinstance(partition, ExecutionPlan):
        return partition
    return plan_from_config(cfg, n_workers, partition=partition,
                            lora=getattr(step_cfg, "lora", None),
                            pool_dtype=getattr(step_cfg, "pool_dtype", "none"))


def pool_rows(cfg: ModelConfig, n_workers: int) -> int:
    """Pool depth after padding the layer list to a multiple of N
    (``plan.pool_layout``, as the prefetch tables use it)."""
    from repro_torch.core.plan import pool_layout
    return pool_layout(cfg.n_layers, n_workers)[0]


def pad_pool(params, cfg: ModelConfig, n_workers: int):
    """``params`` with the layer list padded by zero layers to ``pool_rows``
    rows, so each worker owns an equal shard. Padding rows are never part of
    a slot, get zero gradients and stay zero under the optimizer."""
    l_pad = pool_rows(cfg, n_workers)
    layers = params["layers"]
    if len(layers) == l_pad:
        return params
    if len(layers) != cfg.n_layers:
        raise ValueError(f"{len(layers)} layers for a model of {cfg.n_layers}")
    return dict(params, layers=list(layers)
                + [tree_map(torch.zeros_like, layers[0]) for _ in range(l_pad - cfg.n_layers)])


def _plan_for(cfg, n_workers, plan):
    if plan.n_workers != n_workers:
        raise ValueError(f"plan compiled for {plan.n_workers} workers, ring has {n_workers}")
    if plan.n_layers != cfg.n_layers:
        raise ValueError(f"plan covers {plan.n_layers} layers, model has {cfg.n_layers}")
    plan.validate()
    return plan


def build_roundpipe_grads_fn(cfg: ModelConfig, n_workers: int, plan, *, xent_chunk: int = 256,
                             kv_chunk: int = 1024, ring_grad_dtype=torch.float32,
                             prefetch_program=None, lora=None, n_microbatches=None,
                             pool_dtype: str = "none", grad_compress: str = "none",
                             g0: int = 0, transport=None):
    """``f(params, batch) -> (grads, loss, tokens)`` executing ``plan`` with
    ``n_workers`` logical workers (where the reference takes a mesh). The
    params' layer list may be padded or not; the grads hold exactly
    ``n_layers`` layers."""
    rounds = None if n_microbatches is None else plan.rounds_for(n_microbatches)
    _check_options(prefetch_program=prefetch_program, lora=lora, rounds=rounds,
                   pool_dtype=pool_dtype, grad_compress=grad_compress, g0=g0)
    plan = _plan_for(cfg, n_workers, plan)
    l_pad = pool_rows(cfg, n_workers)

    def grads_fn(params, batch):
        return roundpipe_forward_backward(
            params, batch, cfg=cfg, plan=plan, n_workers=n_workers, l_pad=l_pad,
            xent_chunk=xent_chunk, kv_chunk=kv_chunk, ring_grad_dtype=ring_grad_dtype,
            transport=transport)

    return grads_fn


def build_roundpipe_train_step(cfg: ModelConfig, n_workers: int, step_cfg, global_batch: int,
                               seq_len: int, *, plan=None, transport=None):
    """The full roundpipe train step for ``plan`` (derived from
    ``step_cfg.partition`` / the cost model when None).

    The train state keeps the pool padded at rest (``init_roundpipe_state``).
    Returns ``(step, plan)``; ``step(state, batch) -> (state, metrics)``
    updates the optimizer state in place and returns fresh parameters."""
    if global_batch % n_workers:
        raise ValueError("global batch must divide over the workers")
    if getattr(step_cfg, "strategy", "roundpipe") != "roundpipe":
        raise NotImplementedError(f"strategy {step_cfg.strategy!r} " + _LATER.format(
            "baselines and tooling"))
    if getattr(step_cfg, "schedule", "hand") != "hand":
        _refuse(f"schedule {step_cfg.schedule!r}", "chained async optimizer")
    if plan is None:
        plan = resolve_plan(cfg, step_cfg, n_workers)
    m_micro = getattr(step_cfg, "n_microbatches", None)
    if getattr(step_cfg, "prefetch", False):
        _refuse("prefetch (chunked standby injection)", "prefetch and multi-round")
    grads_fn = build_roundpipe_grads_fn(
        cfg, n_workers, plan, xent_chunk=step_cfg.xent_chunk, kv_chunk=step_cfg.kv_chunk,
        ring_grad_dtype=step_cfg.accum_dtype, lora=getattr(step_cfg, "lora", None),
        n_microbatches=m_micro, pool_dtype=getattr(step_cfg, "pool_dtype", "none"),
        grad_compress=getattr(step_cfg, "grad_compress", "none"),
        g0=getattr(step_cfg, "g0", 0), transport=transport)

    def train_step(state, batch):
        params = state["params"]
        grads, loss, tokens = grads_fn(params, batch)
        pad = params["layers"][cfg.n_layers:]          # padding rows: zero gradients
        grads["layers"] += [tree_map(torch.zeros_like, p) for p in pad]
        with record_function("roundpipe.apply_updates"):
            new_params, new_opt, metrics = apply_updates(state["opt"], grads, step_cfg.opt,
                                                         param_like=params)
        metrics = dict(metrics, loss=loss, tokens=tokens)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step, plan


def init_roundpipe_state(generator, cfg: ModelConfig, step_cfg, n_workers: int | None = None,
                         *, dtype=torch.bfloat16, device="cuda"):
    """Fresh roundpipe train state from a seeded ``torch.Generator`` on
    ``device``; with ``n_workers`` the pool is padded to shard evenly."""
    if getattr(step_cfg, "lora", None) is not None:
        _refuse("LoRA (lora)", "LoRA")
    if getattr(step_cfg, "grad_compress", "none") != "none":
        _refuse("compressed deposits", "the quantized pool and EF deposits")
    params = T.init_params(cfg, generator, dtype=dtype, device=device)
    if n_workers is not None:
        params = pad_pool(params, cfg, n_workers)
    return {"params": params, "opt": init_opt_state(params, step_cfg.opt)}
