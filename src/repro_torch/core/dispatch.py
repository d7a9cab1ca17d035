"""RoundPipe's synchronous training step on one card: the slot ring driver,
its builders and the train state.

The PyTorch counterpart of the sync path of ``repro/core/dispatch.py``
(``roundpipe_forward_backward``, ``build_roundpipe_grads_fn``,
``build_roundpipe_train_step``, ``init_roundpipe_state``, ``resolve_plan``,
``pool_rows``, ``pad_pool``).

N logical workers run in one process on one device. Each owns its
micro-batch group of every round, its activation, a stash of the L+1 layer
boundaries, its carried activation gradient and its shard of the pool
(``plan.pool_layout``). The step runs R rounds stitched back to back through
the generated ``TickProgram`` (``plan.tick_program(R)``): at tick t, worker w
runs stitched slot t - w, which is slot (t - w) mod S of round (t - w) div S:

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
run in the reference's order. Each round's deposits sum into the same rows,
and the replicated gradients accumulate across rounds, before the one
optimizer step. Embedding gradients are scattered with ``index_add_``; a
tied head adds its gradient, transposed, into ``embed``. Returned grads hold
exactly ``n_layers`` layers: there is no pad-then-slice.

Injection is whole-block (each tick gathers its slot's rows) or, with a
``PrefetchProgram``, the double-buffered standby: slot j+1's chunks stream
into a standby while slot j computes, on a side CUDA stream, and the standby
is promoted to the injection block at slot j+1's tick. The pool is dense, or
quantized once per step (``pool_dtype`` "int8" or "int4") into codes and
scales that the uploads ship and the dequant kernel turns back into a block
at promote time. Deposits are exact fp32, or error-feedback int8
(``grad_compress="int8"``) with the residual beside the optimizer state.

With a ``LoraConfig`` (``lora``) the step runs the frozen-base mode: the
dense ring is read-only and an adapter ring (``params["lora"]``, a list of
per-layer ``{"A", "B"}`` dicts) travels beside it, gathered whole at every
injection even under prefetch. Every slot computes on the merged weights W +
(alpha/r) B@A, formed per layer inside the slot (under ``torch.no_grad()`` in
F slots, under autograd in the FB and B slots), and differentiates with
respect to the adapter block and its input only: the gradient buffer, the
deposits and the optimizer state are adapter-shaped, no gradient of the base,
the embedding, the final norm or the head is formed, and the returned grads
are exactly ``{"lora": ...}``. The quantized codec still quantizes the base
pool once a step; the adapters stay in their own precision.

Not ported yet, and refused by name: ``g0 != 0``.
"""
from __future__ import annotations

import functools

import torch
from torch.profiler import record_function

from repro_torch.core.partition import POOL_DTYPE_BITS
from repro_torch.core.ring import (OneCardTransport, RingMachine, StepAccum, block_row,
                                   gbuf_add, zeros_block)
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.lora import init_adapters, param_mask
from repro_torch.optim.adam import (apply_updates, init_opt_state, merge_trainable,
                                    trainable_leaves, tree_leaves, tree_map)

_LATER = "is not ported yet (ROADMAP.md, Queue 1: {})"


def _refuse(what: str, item: str):
    raise NotImplementedError(f"{what} " + _LATER.format(item))


def _check_options(*, pool_dtype="none", grad_compress="none", g0=0):
    if g0 != 0:
        _refuse(f"ring rotation g0={g0}", "supervisor")
    if pool_dtype not in ("none", *POOL_DTYPE_BITS):
        raise ValueError(f"unknown pool_dtype {pool_dtype!r}; expected "
                         f"none|{'|'.join(POOL_DTYPE_BITS)}")
    if grad_compress not in ("none", "int8"):
        raise ValueError(f"unknown grad_compress {grad_compress!r}; expected none|int8")


def _leaf(tree):
    """Detached copies that require grad (views, no data copied), so a slot
    differentiates with respect to them alone."""
    return tree_map(lambda a: a.detach().requires_grad_(), tree)


def _unflatten(tree, flat):
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


class Standby:
    """The double-buffered standby of the prefetch path.

    ``upload`` fills the next standby through ``fill(zeros)`` and ``promote``
    turns the newest one into an injection block through ``use(standby)``.
    On a CUDA device the uploads run on a side stream, so slot j+1's chunks
    stream while slot j computes, ordered by events both ways: a promote
    waits for the upload it reads, and an upload into a buffer waits for the
    promote that last read that buffer. ``zeros(k)`` makes the buffers of
    parity k: with ``keep`` the two buffers are made once and refilled (the
    quantized codes, dequantized into a fresh block at promote time);
    without it every upload makes a fresh standby, which its promote hands to
    the ring as the block itself (the dense codec). Buffers made on the side
    stream and used on the main one are marked with ``record_stream``, so the
    allocator does not reuse them before the main stream is done with them.
    On the CPU everything runs in order on the calling thread."""

    def __init__(self, device, zeros, fill, use, *, keep: bool):
        self.cuda = device.type == "cuda"
        self.main = torch.cuda.current_stream(device) if self.cuda else None
        self.side = torch.cuda.Stream(device) if self.cuda else None
        self.zeros, self.fill, self.use, self.keep = zeros, fill, use, keep
        self.bufs = [None, None]
        self.uploaded = [None, None]
        self.consumed = [None, None]
        self.k = 1
        if self.cuda:       # the pool (and its codes) as the main stream left them
            self.side.wait_stream(self.main)

    def upload(self, slot_idx: int) -> None:
        k = self.k = 1 - self.k
        if not self.cuda:
            buf = self.bufs[k] if self.keep and self.bufs[k] is not None else self.zeros(slot_idx)
            self.bufs[k] = self.fill(buf, slot_idx)
            return
        with torch.cuda.stream(self.side):
            if self.consumed[k] is not None:
                self.side.wait_event(self.consumed[k])
            buf = self.bufs[k] if self.keep and self.bufs[k] is not None else self.zeros(slot_idx)
            self.bufs[k] = self.fill(buf, slot_idx)
            self.uploaded[k] = torch.cuda.Event()
            self.uploaded[k].record(self.side)

    def promote(self, spec):
        k = self.k
        if not self.cuda:
            return self.use(self.bufs[k], spec)
        self.main.wait_event(self.uploaded[k])
        for x in tree_leaves(list(self.bufs[k])):
            x.record_stream(self.main)
        block = self.use(self.bufs[k], spec)
        self.consumed[k] = torch.cuda.Event()
        self.consumed[k].record(self.main)
        return block

    def finish(self) -> None:
        """The main stream waits for every upload, promoted or not."""
        if self.cuda:
            self.main.wait_stream(self.side)


def roundpipe_forward_backward(params, batch, grad_residual=None, *, cfg: ModelConfig, plan,
                               n_workers: int, l_pad: int, xent_chunk: int = 256,
                               kv_chunk: int = 1024, ring_grad_dtype=torch.float32,
                               prefetch_program=None, lora=None, rounds=None,
                               pool_dtype: str = "none", grad_compress: str = "none",
                               g0: int = 0, transport=None):
    """Run one step's slot ring over the global batch and return (grads,
    mean loss, token count), and with ``grad_compress`` the residual too.

    ``params['layers']`` is the pool as a list of per-layer dicts, padded
    to ``l_pad`` rows or not (only rows below ``n_layers`` are read).
    ``batch`` holds the global ``tokens`` and ``labels``: (B,S) with
    ``rounds=None``, where worker w's group is rows [w B/N, (w+1) B/N); or
    round-major (R, B/R, S) with ``rounds=R``, where worker w's group of
    round r is rows [w B/(RN), (w+1) B/(RN)) of ``batch[...][r]``.
    ``prefetch_program`` switches injection to the chunked double-buffered
    standby; ``pool_dtype`` streams the pool quantized; ``grad_compress``
    ("int8") runs every deposit through the error-feedback codec, with
    ``grad_residual`` (fp32, a list of layer dicts shaped like the pool, or
    like the adapters with ``lora``) as the carried error, updated in place.
    ``lora`` (a ``LoraConfig``) runs the frozen-base mode on
    ``params["lora"]`` and returns ``{"lora": grads}``. ``transport`` moves
    payloads between the logical workers (``OneCardTransport`` by default)."""
    _check_options(pool_dtype=pool_dtype, grad_compress=grad_compress, g0=g0)
    frozen = lora is not None
    compress = grad_compress != "none"
    if compress and grad_residual is None:
        raise ValueError("grad_compress needs the grad_residual tree (init_roundpipe_state "
                         "puts it beside the optimizer state)")
    multi = rounds is not None
    r_total = rounds if multi else 1
    program = plan.tick_program(r_total)
    if "embeds" in batch:
        T.embed_inputs(params, batch, cfg)      # raises: the frontend is a later slice
    n = n_workers
    l_total = cfg.n_layers
    slots = plan.stages
    sf = plan.n_fwd
    s_total = plan.n_slots
    live = r_total * s_total                    # stitched slots each worker runs
    del kv_chunk                        # the flash kernel tiles by itself
    rm = RingMachine(cfg=cfg, plan=plan, n_workers=n, l_pad=l_pad,
                     transport=transport or OneCardTransport(n), xent_chunk=xent_chunk,
                     pool_template=params["layers"][0], prefetch_program=prefetch_program,
                     pool_dtype=pool_dtype, lora=lora)
    pool = rm.shards(params["layers"])
    a_pool = rm.shards(params["lora"]) if frozen else None
    A = StepAccum
    head_w = T.lm_head_weights(params, cfg)
    if frozen:                  # nothing of the base takes part in autograd
        head_w, fnorm = head_w.detach(), tree_map(torch.Tensor.detach, params["final_norm"])
    tokens, labels = batch["tokens"], batch["labels"]
    if not multi:
        tokens, labels = tokens[None], labels[None]
    if tokens.shape[0] != r_total:
        raise ValueError(f"batch of {tokens.shape[0]} rounds for a step of {r_total}")
    if tokens.shape[1] % n:
        raise ValueError(f"a round's batch of {tokens.shape[1]} does not divide over {n} "
                         "workers")
    bw = tokens.shape[1] // n
    tok_w = [[tokens[r, w * bw:(w + 1) * bw] for r in range(r_total)] for w in range(n)]
    lab_w = [[labels[r, w * bw:(w + 1) * bw] for r in range(r_total)] for w in range(n)]
    dev = head_w.device

    # ---- per-worker state ----------------------------------------------------
    with torch.no_grad():
        x_emb = [[T.embed_inputs(params, {"tokens": tok_w[w][r]}, cfg) for r in range(r_total)]
                 for w in range(n)]
    act = [None] * n
    stash = [[None] * (l_total + 1) for _ in range(n)]
    grad_carry = [None] * n
    ring = [None] * n                   # traveling blocks
    a_ring = [None] * n                 # traveling adapter blocks (frozen base)
    gbuf = [None] * n                   # their traveling gradient buffers
    grad_shards = [[None] * rm.per for _ in range(n)]
    res_shards = rm.shards(grad_residual) if compress else None
    loss_sum = A.zeros((), torch.float32, dev)
    tok_count = A.zeros((), torch.int64, dev)
    if not frozen:
        embed_grad = A.zeros(params["embed"].shape, torch.float32, dev)
        head_grad = A.zeros(head_w.shape, torch.float32, dev)
        fnorm_grad = A.tree_zeros(params["final_norm"], torch.float32)

    # ---- codec: one quantization pass per step, and the quant-aware calls ----
    quant = pool_dtype != "none"
    if quant:
        with torch.no_grad():
            qpool = rm.quantize_pool(pool)

    def _upload(stand, slot_idx):
        if quant:
            return rm.upload_slot_q(stand, slot_idx, qpool)
        return rm.upload_slot(stand, slot_idx, pool)

    def _zeros(slot_idx):
        return rm.zeros_standby_q(qpool) if quant else rm.zeros_standby(slots[slot_idx].size)

    def _assemble(spec):
        return rm.assemble_block_q(spec, qpool) if quant else rm.assemble_block(spec, pool)

    def _promote(stand, spec):
        return rm.dequant_block(*stand, spec) if quant else rm.promote_standby(stand, spec)

    def do_plain(w, spec, blk, ablk, slot_i, ri):
        with torch.no_grad():
            x = x_emb[w][ri] if slot_i == 0 else act[w]
            for k, lw in enumerate(blk):
                stash[w][spec.layers[k]] = x
                x = rm.layer_fwd(x, lw, None if ablk is None else ablk[k])
            act[w] = x

    def do_fused_frozen(w, blk, ablk, slot_i, ri):
        """The FB slot on the merged weights, differentiated with respect to
        the adapter block and the slot's input only."""
        x_in = x_emb[w][ri] if slot_i == 0 else act[w]      # slot_i == 0: Sf == 0 edge
        base = [tree_map(torch.Tensor.detach, lw) for lw in blk]
        with torch.enable_grad():
            ablk_l, x_l = _leaf(ablk), x_in.detach().requires_grad_()
            tot, cnt = rm.fused_loss(base, fnorm, head_w, x_l, lab_w[w][ri], ablk_l)
            grads = torch.autograd.grad(tot, tree_leaves(ablk_l) + [x_l])
        gbuf[w] = gbuf_add(gbuf[w], _unflatten(ablk_l, grads[:-1]))
        A.add(loss_sum, tot.detach())
        A.add(tok_count, cnt)
        grad_carry[w] = grads[-1].float()

    def do_bwd_frozen(w, spec, blk, ablk):
        """A B slot recomputed from the stash on the merged weights; grads
        with respect to the adapter block and the block's input."""
        base = [tree_map(torch.Tensor.detach, lw) for lw in blk]
        with torch.enable_grad():
            ablk_l, x_l = _leaf(ablk), stash[w][spec.start].detach().requires_grad_()
            y = rm.stage_fwd(base, x_l, ablk_l)
            grads = torch.autograd.grad(y, tree_leaves(ablk_l) + [x_l],
                                        grad_outputs=grad_carry[w].to(y.dtype))
        gbuf[w] = gbuf_add(gbuf[w], _unflatten(ablk_l, grads[:-1]))
        grad_carry[w] = grads[-1].float()

    def do_fused(w, spec, blk, slot_i, ri):
        x_in = x_emb[w][ri] if slot_i == 0 else act[w]      # slot_i == 0: Sf == 0 edge
        with torch.enable_grad():
            blk_l, fn_l = _leaf(blk), _leaf(params["final_norm"])
            hw_l, x_l = head_w.detach().requires_grad_(), x_in.detach().requires_grad_()
            tot, cnt = rm.fused_loss(blk_l, fn_l, hw_l, x_l, lab_w[w][ri])
            wrt = tree_leaves(blk_l) + tree_leaves(fn_l) + [hw_l, x_l]
            grads = torch.autograd.grad(tot, wrt)
        nb = len(tree_leaves(blk_l))
        gbuf[w] = gbuf_add(gbuf[w], _unflatten(blk_l, grads[:nb]))
        A.tree_add_f32(fnorm_grad, _unflatten(fn_l, grads[nb:-2]))
        A.add_f32(head_grad, grads[-2])
        gx = grads[-1]
        if sf == 0 and spec.layers:
            A.token_add(embed_grad, tok_w[w][ri], gx)
        A.add(loss_sum, tot.detach())
        A.add(tok_count, cnt)
        grad_carry[w] = gx.float()

    def do_bwd(w, spec, blk, ri):
        x_in = stash[w][spec.start]
        with torch.enable_grad():
            blk_l, x_l = _leaf(blk), x_in.detach().requires_grad_()
            y = rm.stage_fwd(blk_l, x_l)
            wrt = tree_leaves(blk_l) + [x_l]
            grads = torch.autograd.grad(y, wrt, grad_outputs=grad_carry[w].to(y.dtype))
        gbuf[w] = gbuf_add(gbuf[w], _unflatten(blk_l, grads[:-1]))
        gx = grads[-1]
        if spec.start == 0 and spec.size > 0:
            A.token_add(embed_grad, tok_w[w][ri], gx)
        grad_carry[w] = gx.float()

    standby = None
    if prefetch_program is not None:
        # fill prologue: slot 0 has no earlier compute to hide behind
        standby = Standby(dev, _zeros, _upload, _promote, keep=quant)
        standby.upload(0)

    # The driver consumes the generated schedule IR: tick t injects slot
    # entry[1] of round entry[0] at worker 0; worker w holds stitched slot
    # t - w. The N-1 drain ticks are paid once per step, not once per round.
    for rec in program.records:
        t = rec.t
        ring = rm.shift(ring)
        gbuf = rm.shift(gbuf)
        if frozen:
            a_ring = rm.shift(a_ring)
        if rec.entry is not None:
            spec = slots[rec.entry[1]]
            if standby is not None:
                ring[0] = standby.promote(spec) if spec.size else []
                # double-buffer swap: the next tick's slot streams into the
                # other standby while this tick computes; each round replays
                # the per-slot chunk tables
                if rec.upload is not None:
                    standby.upload(rec.upload[0])
            else:
                ring[0] = _assemble(spec)
            if frozen:
                # adapters are ~100-1000x smaller than the block: gathered
                # whole at injection, even under prefetch
                a_ring[0] = rm.assemble_block(spec, a_pool)
            gbuf[0] = None if spec.kind == "F" else zeros_block(
                a_ring[0] if frozen else ring[0], ring_grad_dtype)
        for w in range(n):
            fb = t - w
            if not 0 <= fb < live:
                continue
            ri, slot_i = divmod(fb, s_total)
            spec, blk, ablk = slots[slot_i], ring[w], a_ring[w]
            # a named range per slot kind: a profiler trace reads each kind's
            # device time from it
            with record_function(f"roundpipe.{spec.kind}"):
                if slot_i < sf:
                    do_plain(w, spec, blk, ablk, slot_i, ri)
                elif frozen:
                    if slot_i == sf:
                        do_fused_frozen(w, blk, ablk, slot_i, ri)
                    else:
                        do_bwd_frozen(w, spec, blk, ablk)
                elif slot_i == sf:
                    do_fused(w, spec, blk, slot_i, ri)
                else:
                    do_bwd(w, spec, blk, ri)
        # the slot exiting at worker N-1 deposits its reduced rows; each
        # round's wave sums into the same rows
        if rec.deposit is not None:
            for k, lid in enumerate(slots[rec.deposit].layers):
                if compress:
                    rm.deposit_ef(grad_shards, res_shards, block_row(gbuf[n - 1], k), lid)
                else:
                    rm.deposit_plain(grad_shards, block_row(gbuf[n - 1], k), lid)
    if standby is not None:
        standby.finish()

    layer_grads = [row for shard in grad_shards for row in shard][:l_total]
    if any(g is None for g in layer_grads):
        raise RuntimeError("a layer received no gradient deposit: the plan does not "
                           "cover every layer with a fused or backward slot")
    scale = 1.0 / torch.clamp(tok_count.float(), min=1.0)
    if frozen:      # exactly the adapters: no base gradient was ever formed
        grads = {"lora": layer_grads}
    else:
        grads = {"embed": embed_grad, "layers": layer_grads, "final_norm": fnorm_grad}
        if "lm_head" in params:
            grads["lm_head"] = head_grad
        else:                                      # tied embeddings
            grads["embed"] = embed_grad.add_(head_grad.T)
    grads = tree_map(lambda g: g.mul_(scale), grads)
    if compress:
        return grads, loss_sum * scale, tok_count, grad_residual
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
    """``params`` with the layer list (and the adapter list ``"lora"``, when
    present) padded by zero rows to ``pool_rows`` rows, so each worker owns
    an equal shard. Padding rows are never part of a slot, get zero
    gradients and stay zero under the optimizer."""
    l_pad = pool_rows(cfg, n_workers)
    out = dict(params)
    for key in ("layers", "lora"):
        rows = params.get(key)
        if rows is None or len(rows) == l_pad:
            continue
        if len(rows) != cfg.n_layers:
            raise ValueError(f"{len(rows)} {key} rows for a model of {cfg.n_layers} layers")
        out[key] = list(rows) + [tree_map(torch.zeros_like, rows[0])
                                 for _ in range(l_pad - cfg.n_layers)]
    return out


def _plan_for(cfg, n_workers, plan):
    if plan.n_workers != n_workers:
        raise ValueError(f"plan compiled for {plan.n_workers} workers, ring has {n_workers}")
    if plan.n_layers != cfg.n_layers:
        raise ValueError(f"plan covers {plan.n_layers} layers, model has {cfg.n_layers}")
    plan.validate()
    return plan


def _split_rounds(batch, rounds: int, n_microbatches: int):
    """Flat (B, ...) batch leaves -> round-major (R, B/R, ...): round r owns
    micro-batch groups r*N..(r+1)*N-1 of the step."""
    def split(x):
        if x.shape[0] % n_microbatches:
            raise ValueError(f"global batch {x.shape[0]} not divisible by n_microbatches "
                             f"{n_microbatches}")
        return x.reshape(rounds, x.shape[0] // rounds, *x.shape[1:])
    return {k: split(v) for k, v in batch.items()}


def _ring_fn(cfg, n_workers, plan, rounds, **kw):
    """``f(params, batch, residual)`` running ``roundpipe_forward_backward``
    for ``plan`` (validated, with its prefetch program) over batches whose
    leaves are round-major when ``rounds`` is set."""
    _check_options(pool_dtype=kw["pool_dtype"], grad_compress=kw["grad_compress"],
                   g0=kw.pop("g0", 0))
    plan = _plan_for(cfg, n_workers, plan)
    if kw["prefetch_program"] is not None:
        kw["prefetch_program"].validate(plan)
    return functools.partial(roundpipe_forward_backward, cfg=cfg, plan=plan,
                             n_workers=n_workers, l_pad=pool_rows(cfg, n_workers),
                             rounds=rounds, **kw)


def build_roundpipe_grads_fn(cfg: ModelConfig, n_workers: int, plan, *, xent_chunk: int = 256,
                             kv_chunk: int = 1024, ring_grad_dtype=torch.float32,
                             prefetch_program=None, lora=None, n_microbatches=None,
                             pool_dtype: str = "none", grad_compress: str = "none",
                             g0: int = 0, transport=None):
    """``f(params, batch) -> (grads, loss, tokens)`` executing ``plan`` with
    ``n_workers`` logical workers (where the reference takes a mesh). The
    params' layer list may be padded or not; the grads hold exactly
    ``n_layers`` layers. ``n_microbatches`` (M = R*N) runs R rounds: the flat
    batch splits into R leading round groups, and the grads accumulate over
    all M micro-batches. ``prefetch_program`` selects the chunked standby
    injection, ``pool_dtype`` the quantized pool; ``lora`` the frozen-base
    mode (params carry ``"lora"``, padded or not; the grads are ``{"lora":
    ...}`` with ``n_layers`` rows). With ``grad_compress="int8"``
    the call is ``f(params, batch, residual) -> (grads, loss, tokens,
    residual)``, the residual updated in place."""
    rounds = None if n_microbatches is None else plan.rounds_for(n_microbatches)
    ring = _ring_fn(cfg, n_workers, plan, rounds, xent_chunk=xent_chunk, kv_chunk=kv_chunk,
                    ring_grad_dtype=ring_grad_dtype, prefetch_program=prefetch_program,
                    lora=lora, pool_dtype=pool_dtype, grad_compress=grad_compress, g0=g0,
                    transport=transport)

    def grads_fn(params, batch, grad_residual=None):
        if rounds is not None:
            batch = _split_rounds(batch, rounds, n_microbatches)
        return ring(params, batch, grad_residual)

    return grads_fn


def build_roundpipe_train_step(cfg: ModelConfig, n_workers: int, step_cfg, global_batch: int,
                               seq_len: int, *, plan=None, round_major: bool = False,
                               transport=None):
    """The full roundpipe train step for ``plan`` (derived from
    ``step_cfg.partition`` / the cost model when None).

    ``step_cfg.prefetch`` selects the chunked double-buffered standby
    (``plan.prefetch_program(chunk_limit=step_cfg.prefetch_chunk_limit)``);
    ``step_cfg.n_microbatches`` (M = R*N) runs R rounds per step with one
    optimizer update; ``round_major=True`` takes the data pipeline's (R, B/R,
    ...) batches as they are, where the default reshapes flat (B, ...) ones.
    ``step_cfg.pool_dtype`` streams the pool quantized; ``step_cfg.grad_compress``
    runs the deposits through the error-feedback codec with the residual in
    ``state["opt"]["grad_residual"]``. ``step_cfg.lora`` trains the adapters
    only: the optimizer updates ``trainable_leaves(params, param_mask(params))``
    and the frozen base passes through untouched (the same tensors).

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
    rounds = None
    if m_micro is not None:
        rounds = plan.rounds_for(m_micro)
        if global_batch % m_micro:
            raise ValueError(f"global batch {global_batch} must be divisible by "
                             f"n_microbatches {m_micro} (micro-batch size = global_batch / M)")
    if round_major and rounds is None:
        raise ValueError("round_major=True requires the multi-round path "
                         "(set step_cfg.n_microbatches)")
    program = None
    if getattr(step_cfg, "prefetch", True):
        program = plan.prefetch_program(
            chunk_limit=getattr(step_cfg, "prefetch_chunk_limit", None))
    compress = getattr(step_cfg, "grad_compress", "none") != "none"
    lora = getattr(step_cfg, "lora", None)
    pool_key = "layers" if lora is None else "lora"     # the pool that gets gradients
    ring = _ring_fn(cfg, n_workers, plan, rounds, xent_chunk=step_cfg.xent_chunk,
                    kv_chunk=step_cfg.kv_chunk, ring_grad_dtype=step_cfg.accum_dtype,
                    prefetch_program=program, lora=lora,
                    pool_dtype=getattr(step_cfg, "pool_dtype", "none"),
                    grad_compress=getattr(step_cfg, "grad_compress", "none"),
                    g0=getattr(step_cfg, "g0", 0), transport=transport)

    def train_step(state, batch):
        if rounds is not None and not round_major:
            batch = _split_rounds(batch, rounds, m_micro)
        params = state["params"]
        opt_in = dict(state["opt"])
        residual = opt_in.pop("grad_residual", None)
        out = ring(params, batch, residual)
        grads, loss, tokens = out[:3]
        pad = params[pool_key][cfg.n_layers:]          # padding rows: zero gradients
        grads[pool_key] += [tree_map(torch.zeros_like, p) for p in pad]
        with record_function("roundpipe.apply_updates"):
            if lora is None:
                new_params, new_opt, metrics = apply_updates(opt_in, grads, step_cfg.opt,
                                                             param_like=params)
            else:       # the adapters only; the frozen base passes through
                mask = param_mask(params)
                new_tr, new_opt, metrics = apply_updates(
                    opt_in, grads, step_cfg.opt, param_like=trainable_leaves(params, mask))
                new_params = merge_trainable(params, new_tr, mask)
        if compress:
            new_opt = dict(new_opt, grad_residual=out[3])
        metrics = dict(metrics, loss=loss, tokens=tokens)
        return {"params": new_params, "opt": new_opt}, metrics

    return train_step, plan

def init_roundpipe_state(generator, cfg: ModelConfig, step_cfg, n_workers: int | None = None,
                         *, dtype=torch.bfloat16, device="cuda"):
    """Fresh roundpipe train state from a seeded ``torch.Generator`` on
    ``device``; with ``n_workers`` the pool is padded to shard evenly. With
    ``step_cfg.lora`` the params gain fresh adapters (``"lora"``, zero B, so
    the first step computes exactly the base model), drawn from the same
    generator after the base, and the optimizer state covers the adapters
    only. With ``step_cfg.grad_compress`` the optimizer state carries the
    error-feedback residual ``opt["grad_residual"]``: fp32 zeros shaped like
    the (padded) pool that gets gradients, the adapters' under LoRA."""
    lora = getattr(step_cfg, "lora", None)
    params = T.init_params(cfg, generator, dtype=dtype, device=device)
    if lora is not None:
        params["lora"] = init_adapters(generator, params["layers"], lora)
    if n_workers is not None:
        params = pad_pool(params, cfg, n_workers)
    if lora is None:
        opt = init_opt_state(params, step_cfg.opt)
    else:
        opt = init_opt_state(trainable_leaves(params, param_mask(params)), step_cfg.opt)
    if getattr(step_cfg, "grad_compress", "none") != "none":
        pool = params["layers" if lora is None else "lora"]
        opt["grad_residual"] = [tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32,
                                                               device=a.device), p)
                                for p in pool]
    return {"params": params, "opt": opt}
