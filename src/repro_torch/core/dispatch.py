"""RoundPipe's synchronous training step on one card: the slot ring driver,
its builders and the train state.

The PyTorch counterpart of the sync path of ``repro/core/dispatch.py``
(``roundpipe_forward_backward``, ``build_roundpipe_grads_fn``,
``build_roundpipe_train_step``, ``init_roundpipe_state``, ``resolve_plan``,
``pool_rows``, ``pad_pool``, ``reshape_pooled_state``).

N logical workers run in one process on one device. Each owns its
micro-batch group of every round, its activation, a stash of the L+1 layer
boundaries, its carried activation gradient and its shard of the pool
(``plan.pool_layout``). The step runs R rounds stitched back to back through
the generated ``TickProgram`` (``plan.tick_program(R)``): at tick t, logical
worker w runs stitched slot t - w, which is slot (t - w) mod S of round (t -
w) div S:

  * F slots fold their block over the worker's activation under
    ``torch.no_grad()``, stashing each layer's input;
  * the fused FB slot runs the deepest body block, the final norm and the
    LM-head loss under autograd and differentiates the loss with respect to
    the block, the final norm, the head and its input;
  * B slots recompute their block from the stashed boundary under autograd
    and take ``torch.autograd.grad`` with the carried gradient (the analogue
    of ``jax.vjp``).

A gradient buffer travels with each block; logical worker 0 adds first, then
1, up to N-1, and the tail deposits the reduced rows to their owners, so the
sums run in the reference's order. The program's ``g0`` rotates the ring
(``core.ring``): logical w is physical ``(w + g0) mod N``, which holds the
ring entries, the per-worker state and its own micro-batch group, and names
the endpoints of every transport call; ``g0 = 0`` is the unrotated ring.
Each round's deposits sum into the same rows, and the replicated gradients
accumulate across rounds, before the one optimizer step. Embedding gradients
are scattered with ``index_add_``; a tied head adds its gradient,
transposed, into ``embed``. Returned grads hold exactly ``n_layers`` layers:
there is no pad-then-slice.

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

``reshape_pooled_state`` re-pads a train state written under one worker
count to another's pool depth: the elastic restore of the goodput supervisor
(``runtime.supervisor``), after a worker dies.

The chained staleness-1 program (``roundpipe_async_forward_backward``,
``build_roundpipe_async_train_step``; paper §4.3, DESIGN.md §6) runs I
optimizer steps through the same driver in ``I*R*S + N - 1`` ticks of one
``plan.tick_program(R, I)``: step T's injections and its traced work read
version ``v_{T-1}`` (``v_0`` for steps 0 and 1), and at step k's
deposit-complete tick ``D_k`` the optimizer runs on step k's drained
gradients and publishes ``v_{k+1}``. Each worker's step at each tick is a
Python int here, so versions and per-step accumulators are kept by step and
freed when their last reader retires, where the reference keeps 2-deep
parity buffers indexed by a traced step: at most two versions live at once,
and ``v_{k+1}`` is written into the buffers of ``v_{k-1}``, whose last
reader (step k) retired at ``D_k``.
"""
from __future__ import annotations

import functools

import torch
from torch.profiler import record_function

from repro_torch.checkpoint.store import POOLED_KEYS
from repro_torch.core.partition import POOL_DTYPE_BITS
from repro_torch.core.ring import (OneCardTransport, RingMachine, StepAccum, block_row,
                                   gbuf_add, zeros_block)
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.lora import init_adapters, param_mask
from repro_torch.optim.adam import (apply_updates, init_opt_state, merge_trainable,
                                    trainable_leaves, tree_leaves, tree_map)

_LATER = "is not ported yet (ROADMAP.md, Queue 1: {})"


def _check_options(*, pool_dtype="none", grad_compress="none"):
    if pool_dtype not in ("none", *POOL_DTYPE_BITS):
        raise ValueError(f"unknown pool_dtype {pool_dtype!r}; expected "
                         f"none|{'|'.join(POOL_DTYPE_BITS)}")
    if grad_compress not in ("none", "int8"):
        raise ValueError(f"unknown grad_compress {grad_compress!r}; expected none|int8")


def _check_program(program, plan, rounds: int, iterations: int):
    """Validate an externally supplied tick program against the plan before
    a driver unrolls it: the shape fields must match and the injection order
    must be exactly the plan's round-stitched tick_table, and its rotation
    stamp ``g0`` one of the plan's workers."""
    if (program.n_workers != plan.n_workers or program.n_slots != plan.n_slots
            or program.rounds != rounds or program.iterations != iterations):
        raise ValueError(
            f"tick program shaped (N={program.n_workers}, S={program.n_slots}, "
            f"R={program.rounds}, I={program.iterations}) does not match plan "
            f"(N={plan.n_workers}, S={plan.n_slots}) at R={rounds}, I={iterations}")
    if program.entries != plan.tick_table(rounds, iterations):
        raise ValueError("tick program injection order does not match the plan's "
                         "round-stitched tick_table")
    _check_g0(program.g0, plan.n_workers)
    return program


def _check_g0(g0: int, n_workers: int) -> None:
    if not 0 <= g0 < n_workers:
        raise ValueError(f"ring rotation g0={g0} out of range for {n_workers} workers")


def _leaf(tree):
    """Detached copies that require grad (views, no data copied), so a slot
    differentiates with respect to them alone."""
    return tree_map(lambda a: a.detach().requires_grad_(), tree)


def _unflatten(tree, flat):
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


class Standby:
    """The double-buffered standby of the prefetch path.

    ``upload`` fills the next standby through ``fill(zeros, slot, step)`` and
    ``promote`` turns the newest one into an injection block through
    ``use(standby)``. On a CUDA device the uploads run on a side stream, so
    slot j+1's chunks stream while slot j computes, ordered by events both
    ways: a promote waits for the upload it reads, and an upload into a
    buffer waits for the promote that last read that buffer; ``follow``
    makes later uploads wait for what the main stream has queued so far (a
    parameter version the optimizer just wrote). ``zeros(slot, step)`` makes
    the buffers of parity k: with ``keep`` the two buffers are made once and
    refilled (the quantized codes, dequantized into a fresh block at promote
    time); without it every upload makes a fresh standby, which its promote
    hands to the ring as the block itself (the dense codec). Buffers made on
    the side stream and used on the main one are marked with
    ``record_stream``, so the allocator does not reuse them before the main
    stream is done with them. On the CPU everything runs in order on the
    calling thread."""

    def __init__(self, device, zeros, fill, use, *, keep: bool):
        self.cuda = device.type == "cuda"
        self.main = torch.cuda.current_stream(device) if self.cuda else None
        self.side = torch.cuda.Stream(device) if self.cuda else None
        self.zeros, self.fill, self.use, self.keep = zeros, fill, use, keep
        self.bufs = [None, None]
        self.uploaded = [None, None]
        self.consumed = [None, None]
        self.k = 1
        self.follow()       # the pool (and its codes) as the main stream left them

    def follow(self) -> None:
        if self.cuda:
            self.side.wait_stream(self.main)

    def upload(self, slot_idx: int, step: int = 0) -> None:
        k = self.k = 1 - self.k
        if not self.cuda:
            buf = (self.bufs[k] if self.keep and self.bufs[k] is not None
                   else self.zeros(slot_idx, step))
            self.bufs[k] = self.fill(buf, slot_idx, step)
            return
        with torch.cuda.stream(self.side):
            if self.consumed[k] is not None:
                self.side.wait_event(self.consumed[k])
            buf = (self.bufs[k] if self.keep and self.bufs[k] is not None
                   else self.zeros(slot_idx, step))
            self.bufs[k] = self.fill(buf, slot_idx, step)
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


class _Step:
    """What the work of one optimizer step reads and sums: the shards of the
    parameter version it injects, its replicated weights and embeddings
    (of that version), its batch cut by physical worker and round, and its
    accumulators, made at first use (on deep plans a step's first fused
    slot comes after the previous step's deposit-complete tick, so only one
    step's accumulators ever live). A batch of ``embeds`` (the stubbed
    audio / vision front end) takes the place of the token lookup: it is
    cut as tokens are and cast to the embedding table's dtype, and with no
    tokens (``tok_w`` None) no embedding gradient is scattered, so the
    returned one is zeros, as in the reference."""

    def __init__(self, rm: RingMachine, params, qpool, batch, *, cfg, n: int, r_total: int,
                 frozen: bool):
        self.pool = rm.shards(params["layers"])
        self.a_pool = rm.shards(params["lora"]) if frozen else None
        self.qpool = qpool
        head_w = T.lm_head_weights(params, cfg)
        fnorm = params["final_norm"]
        if frozen:              # nothing of the base takes part in autograd
            head_w, fnorm = head_w.detach(), tree_map(torch.Tensor.detach, fnorm)
        self.head_w, self.fnorm = head_w, fnorm
        feed = "embeds" if "embeds" in batch else "tokens"
        inputs, labels = batch[feed], batch["labels"]
        if inputs.shape[0] != r_total:
            raise ValueError(f"batch of {inputs.shape[0]} rounds for a step of {r_total}")
        if inputs.shape[1] % n:
            raise ValueError(f"a round's batch of {inputs.shape[1]} does not divide over {n} "
                             "workers")
        bw = inputs.shape[1] // n

        def cut(x):
            return [[x[r, w * bw:(w + 1) * bw] for r in range(r_total)] for w in range(n)]

        in_w = cut(inputs)
        self.tok_w = in_w if feed == "tokens" else None
        self.lab_w = cut(labels)
        with torch.no_grad():
            self.x_emb = [[T.embed_inputs(params, {feed: x}, cfg) for x in row] for row in in_w]
        self._params, self._frozen = params, frozen
        self._acc = None

    def acc(self) -> dict:
        if self._acc is None:
            A, dev, p = StepAccum, self.head_w.device, self._params
            self._acc = {"loss": A.zeros((), torch.float32, dev),
                         "tokens": A.zeros((), torch.int64, dev)}
            if not self._frozen:
                self._acc.update(embed=A.zeros(p["embed"].shape, torch.float32, dev),
                                 head=A.zeros(self.head_w.shape, torch.float32, dev),
                                 fnorm=A.tree_zeros(p["final_norm"], torch.float32))
        return self._acc


def _drive(params, batches, grad_residual, update, *, cfg: ModelConfig, plan, program,
           n_workers: int, l_pad: int, xent_chunk: int, ring_grad_dtype, prefetch_program,
           lora, pool_dtype: str, grad_compress: str, transport):
    """Run ``program`` (I steps of R rounds each) over the slot ring.

    ``batches[k]`` is step k's batch, round-major ``(R, B/R, ...)``; the
    program's ``g0`` rotates the ring (module docstring). Step T
    reads version ``v_{max(0, T-1)}`` (``v_0 = params``). At step k's
    deposit-complete tick ``D_k`` the driver calls ``update(k, grads, loss,
    tokens, retired)``: ``grads`` are step k's (exactly ``n_layers`` pool
    rows), ``retired`` is ``v_{k-1}``, whose last reader has just finished
    (None for k = 0), and the return value, if not None, is published as
    ``v_{k+1}``. Returns the versions still held (``v_{I-1}``, ``v_I``)."""
    frozen = lora is not None
    compress = grad_compress != "none"
    quant = pool_dtype != "none"
    n = n_workers
    l_total = cfg.n_layers
    slots = plan.stages
    sf = plan.n_fwd
    s_total = plan.n_slots
    r_total, steps = program.rounds, program.iterations
    live = steps * r_total * s_total            # stitched slots each worker runs
    rm = RingMachine(cfg=cfg, plan=plan, n_workers=n, l_pad=l_pad,
                     transport=transport or OneCardTransport(n), xent_chunk=xent_chunk,
                     pool_template=params["layers"][0], prefetch_program=prefetch_program,
                     pool_dtype=pool_dtype, lora=lora, g0=program.g0)
    A = StepAccum
    dev = params["embed"].device
    versions = {0: params}
    qpools = {}                 # version -> its quantized image (frozen base: v_0's only)

    def qpool_of(v):
        if v not in qpools:
            with torch.no_grad():
                qpools[v] = rm.quantize_pool(rm.shards(versions[v]["layers"]))
        return qpools[v]

    open_steps = {}

    def step_of(k) -> _Step:
        st = open_steps.get(k)
        if st is None:
            v = max(0, k - 1)
            if v not in versions:
                raise RuntimeError(f"step {k} reads version {v}, which is not published yet")
            st = open_steps[k] = _Step(rm, versions[v], qpool_of(0 if frozen else v)
                                       if quant else None, batches[k], cfg=cfg, n=n,
                                       r_total=r_total, frozen=frozen)
        return st

    # ---- per-worker state, indexed by physical worker --------------------------
    act = [None] * n
    stash = [[None] * (l_total + 1) for _ in range(n)]
    grad_carry = [None] * n
    ring = [None] * n                   # traveling blocks
    a_ring = [None] * n                 # traveling adapter blocks (frozen base)
    gbuf = [None] * n                   # their traveling gradient buffers
    grad_shards = [[None] * rm.per for _ in range(n)]
    res_shards = rm.shards(grad_residual) if compress else None
    step_of(0)

    # ---- codec: the quant-aware calls ----------------------------------------
    def _upload(stand, slot_idx, k):
        st = step_of(k)
        if quant:
            return rm.upload_slot_q(stand, slot_idx, st.qpool)
        return rm.upload_slot(stand, slot_idx, st.pool)

    def _zeros(slot_idx, k):
        return rm.zeros_standby_q(step_of(k).qpool) if quant else rm.zeros_standby(
            slots[slot_idx].size)

    def _assemble(spec, st):
        return rm.assemble_block_q(spec, st.qpool) if quant else rm.assemble_block(spec, st.pool)

    def _promote(stand, spec):
        return rm.dequant_block(*stand, spec) if quant else rm.promote_standby(stand, spec)

    def do_plain(w, spec, blk, ablk, slot_i, ri, st):
        with torch.no_grad():
            x = st.x_emb[w][ri] if slot_i == 0 else act[w]
            for k, lw in enumerate(blk):
                stash[w][spec.layers[k]] = x
                x = rm.layer_fwd(x, lw, None if ablk is None else ablk[k])
            act[w] = x

    def do_fused_frozen(w, blk, ablk, slot_i, ri, st):
        """The FB slot on the merged weights, differentiated with respect to
        the adapter block and the slot's input only."""
        acc = st.acc()
        x_in = st.x_emb[w][ri] if slot_i == 0 else act[w]      # slot_i == 0: Sf == 0 edge
        base = [tree_map(torch.Tensor.detach, lw) for lw in blk]
        with torch.enable_grad():
            ablk_l, x_l = _leaf(ablk), x_in.detach().requires_grad_()
            tot, cnt = rm.fused_loss(base, st.fnorm, st.head_w, x_l, st.lab_w[w][ri], ablk_l)
            grads = torch.autograd.grad(tot, tree_leaves(ablk_l) + [x_l])
        gbuf[w] = gbuf_add(gbuf[w], _unflatten(ablk_l, grads[:-1]))
        A.add(acc["loss"], tot.detach())
        A.add(acc["tokens"], cnt)
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

    def do_fused(w, spec, blk, slot_i, ri, st):
        acc = st.acc()
        x_in = st.x_emb[w][ri] if slot_i == 0 else act[w]      # slot_i == 0: Sf == 0 edge
        with torch.enable_grad():
            blk_l, fn_l = _leaf(blk), _leaf(st.fnorm)
            hw_l, x_l = st.head_w.detach().requires_grad_(), x_in.detach().requires_grad_()
            tot, cnt = rm.fused_loss(blk_l, fn_l, hw_l, x_l, st.lab_w[w][ri])
            wrt = tree_leaves(blk_l) + tree_leaves(fn_l) + [hw_l, x_l]
            grads = torch.autograd.grad(tot, wrt)
        nb = len(tree_leaves(blk_l))
        gbuf[w] = gbuf_add(gbuf[w], _unflatten(blk_l, grads[:nb]))
        A.tree_add_f32(acc["fnorm"], _unflatten(fn_l, grads[nb:-2]))
        A.add_f32(acc["head"], grads[-2])
        gx = grads[-1]
        if sf == 0 and spec.layers and st.tok_w is not None:
            A.token_add(acc["embed"], st.tok_w[w][ri], gx)
        A.add(acc["loss"], tot.detach())
        A.add(acc["tokens"], cnt)
        grad_carry[w] = gx.float()

    def do_bwd(w, spec, blk, ri, st):
        x_in = stash[w][spec.start]
        with torch.enable_grad():
            blk_l, x_l = _leaf(blk), x_in.detach().requires_grad_()
            y = rm.stage_fwd(blk_l, x_l)
            wrt = tree_leaves(blk_l) + [x_l]
            grads = torch.autograd.grad(y, wrt, grad_outputs=grad_carry[w].to(y.dtype))
        gbuf[w] = gbuf_add(gbuf[w], _unflatten(blk_l, grads[:-1]))
        gx = grads[-1]
        if spec.start == 0 and spec.size > 0 and st.tok_w is not None:
            A.token_add(st.acc()["embed"], st.tok_w[w][ri], gx)
        grad_carry[w] = gx.float()

    def drained(k):
        """Step k's gradients, mean loss and token count, off its accumulators."""
        st = open_steps.pop(k)
        acc = st.acc()
        layer_grads = [row for shard in grad_shards for row in shard][:l_total]
        if any(g is None for g in layer_grads):
            raise RuntimeError("a layer received no gradient deposit: the plan does not "
                               "cover every layer with a fused or backward slot")
        scale = 1.0 / torch.clamp(acc["tokens"].float(), min=1.0)
        if frozen:      # exactly the adapters: no base gradient was ever formed
            grads = {"lora": layer_grads}
        else:
            grads = {"embed": acc["embed"], "layers": layer_grads, "final_norm": acc["fnorm"]}
            if "lm_head" in params:
                grads["lm_head"] = acc["head"]
            else:                                      # tied embeddings
                grads["embed"] = acc["embed"].add_(acc["head"].T)
        grads = tree_map(lambda g: g.mul_(scale), grads)
        return grads, acc["loss"] * scale, acc["tokens"]

    standby = None
    if prefetch_program is not None:
        # fill prologue: slot 0 has no earlier compute to hide behind
        standby = Standby(dev, _zeros, _upload, _promote, keep=quant)
        standby.upload(0, 0)

    # The driver consumes the generated schedule IR: tick t injects slot
    # entry[1] of global round entry[0] at logical worker 0 (physical inj);
    # logical worker w holds stitched slot t - w. The N-1 drain ticks are paid
    # once per call, not once per round or step.
    inj, tail = rm.inj, rm.tail
    for rec in program.records:
        t = rec.t
        ring = rm.shift(ring)
        gbuf = rm.shift(gbuf)
        if frozen:
            a_ring = rm.shift(a_ring)
        upload = rec.upload if standby is not None else None
        if rec.entry is not None:
            spec = slots[rec.entry[1]]
            st = step_of(rec.inject_step)
            if standby is not None:
                ring[inj] = standby.promote(spec) if spec.size else []
                # double-buffer swap: the next tick's slot streams into the
                # other standby while this tick computes, as soon as the
                # version it reads exists (else after this tick's update)
                if upload is not None and (max(0, upload[1] - 1) in versions
                                           or upload[1] in open_steps):
                    standby.upload(*upload)
                    upload = None
            else:
                ring[inj] = _assemble(spec, st)
            if frozen:
                # adapters are ~100-1000x smaller than the block: gathered
                # whole at injection, even under prefetch
                a_ring[inj] = rm.assemble_block(spec, st.a_pool)
            gbuf[inj] = None if spec.kind == "F" else zeros_block(
                a_ring[inj] if frozen else ring[inj], ring_grad_dtype)
        for w in range(n):
            fb = t - w
            if not 0 <= fb < live:
                continue
            g_round, slot_i = divmod(fb, s_total)
            k, ri = divmod(g_round, r_total)
            st = open_steps[k]
            p = rm.phys(w)
            spec, blk, ablk = slots[slot_i], ring[p], a_ring[p]
            # a named range per slot kind: a profiler trace reads each kind's
            # device time from it
            with record_function(f"roundpipe.{spec.kind}"):
                if slot_i < sf:
                    do_plain(p, spec, blk, ablk, slot_i, ri, st)
                elif frozen:
                    if slot_i == sf:
                        do_fused_frozen(p, blk, ablk, slot_i, ri, st)
                    else:
                        do_bwd_frozen(p, spec, blk, ablk)
                elif slot_i == sf:
                    do_fused(p, spec, blk, slot_i, ri, st)
                else:
                    do_bwd(p, spec, blk, ri, st)
        # the slot exiting at logical worker N-1 deposits its reduced rows;
        # each round's wave sums into the same rows
        if rec.deposit is not None:
            for k, lid in enumerate(slots[rec.deposit].layers):
                if compress:
                    rm.deposit_ef(grad_shards, res_shards, block_row(gbuf[tail], k), lid)
                else:
                    rm.deposit_plain(grad_shards, block_row(gbuf[tail], k), lid)
        # D_k: step k's gradients have all reached their owners
        if rec.update_step is not None:
            k = rec.update_step
            grads, loss, tokens = drained(k)
            grad_shards = [[None] * rm.per for _ in range(n)]
            ring[tail] = gbuf[tail] = a_ring[tail] = None    # step k's last block
            # v_{k-1}'s last reader, step k, is done: its buffers take v_{k+1}
            retired = versions.pop(k - 1) if k >= 1 else None
            if not frozen:
                qpools.pop(k - 1, None)
            with record_function("roundpipe.apply_updates"):
                new = update(k, grads, loss, tokens, retired)
                if new is not None:
                    versions[k + 1] = new
                    if quant and not frozen and k + 2 < steps:
                        qpool_of(k + 1)     # the one quantize pass of v_{k+1}
            del grads, retired
            if standby is not None:
                standby.follow()
        if upload is not None:
            standby.upload(*upload)
    if standby is not None:
        standby.finish()
    return versions


def roundpipe_forward_backward(params, batch, grad_residual=None, *, cfg: ModelConfig, plan,
                               n_workers: int, l_pad: int, xent_chunk: int = 256,
                               kv_chunk: int = 1024, ring_grad_dtype=torch.float32,
                               prefetch_program=None, lora=None, rounds=None,
                               pool_dtype: str = "none", grad_compress: str = "none",
                               tick_program=None, g0: int = 0, transport=None):
    """Run one step's slot ring over the global batch and return (grads,
    mean loss, token count), and with ``grad_compress`` the residual too.

    ``params['layers']`` is the pool as a list of per-layer dicts, padded
    to ``l_pad`` rows or not (only rows below ``n_layers`` are read).
    ``batch`` holds the global ``tokens`` (or front-end ``embeds``, (B,S,D))
    and ``labels``: (B,S) with ``rounds=None``, where worker w's group is
    rows [w B/N, (w+1) B/N); or round-major (R, B/R, S) with ``rounds=R``,
    where worker w's group of round r is rows [w B/(RN), (w+1) B/(RN)) of
    ``batch[...][r]``.
    ``prefetch_program`` switches injection to the chunked double-buffered
    standby; ``pool_dtype`` streams the pool quantized; ``grad_compress``
    ("int8") runs every deposit through the error-feedback codec, with
    ``grad_residual`` (fp32, a list of layer dicts shaped like the pool, or
    like the adapters with ``lora``) as the carried error, updated in place.
    ``lora`` (a ``LoraConfig``) runs the frozen-base mode on
    ``params["lora"]`` and returns ``{"lora": grads}``. ``tick_program``
    supplies the generated schedule IR (validated against the plan);
    ``transport`` moves payloads between the workers (``OneCardTransport`` by
    default). ``g0`` rotates the ring (module docstring); a supplied
    ``tick_program``'s own ``g0`` stamp governs."""
    _check_options(pool_dtype=pool_dtype, grad_compress=grad_compress)
    if grad_compress != "none" and grad_residual is None:
        raise ValueError("grad_compress needs the grad_residual tree (init_roundpipe_state "
                         "puts it beside the optimizer state)")
    r_total = rounds or 1
    program = (_check_program(tick_program, plan, r_total, 1) if tick_program is not None
               else plan.tick_program(r_total, g0=g0))
    del kv_chunk                        # the flash kernel tiles by itself
    if rounds is None:
        batch = {k: v[None] for k, v in batch.items()}
    out = {}

    def update(k, grads, loss, tokens, retired):
        out.update(grads=grads, loss=loss, tokens=tokens)

    _drive(params, [batch], grad_residual, update, cfg=cfg,
           plan=plan, program=program, n_workers=n_workers, l_pad=l_pad, xent_chunk=xent_chunk,
           ring_grad_dtype=ring_grad_dtype, prefetch_program=prefetch_program, lora=lora,
           pool_dtype=pool_dtype, grad_compress=grad_compress, transport=transport)
    if grad_compress != "none":
        return out["grads"], out["loss"], out["tokens"], grad_residual
    return out["grads"], out["loss"], out["tokens"]


def roundpipe_async_forward_backward(params, opt_state, batches, *, cfg: ModelConfig, plan,
                                     n_workers: int, l_pad: int, steps: int, rounds: int,
                                     opt_cfg, xent_chunk: int = 256, kv_chunk: int = 1024,
                                     ring_grad_dtype=torch.float32, prefetch_program=None,
                                     lora=None, pool_dtype: str = "none",
                                     grad_compress: str = "none", tick_program=None,
                                     g0: int = 0, transport=None):
    """The cross-step chained body (paper §4.3, DESIGN.md §6): ``steps``
    optimizer iterations back to back in one ring program of ``I*R*S + N -
    1`` ticks. Step T's injections and traced work read ``v_{T-1}``; at step
    k's deposit-complete tick ``D_k`` the optimizer (``apply_updates`` on
    ``opt_state``, in place) consumes step k's drained gradients and
    publishes ``v_{k+1}``; the last update is applied before returning (the
    flush), so the result matches ``core.consistency.reference_staleness1``
    over ``steps`` iterations.

    ``batches`` leaves are ``(I, R, B/R, ...)``. Returns ``(params,
    opt_state, metrics)`` with ``metrics["loss"/"tokens"/"grad_norm"]`` of
    shape ``(I,)``. The call takes the parameter tensors of ``params`` as
    its own, as the reference's compiled step donates them: ``v_2`` is
    written into them, and a caller that still needs ``v_0`` keeps a copy.

    ``lora`` selects the frozen-base mode: the dense pool is read-only (and
    comes back as the same tensors) and only the adapters version; the
    optimizer state covers the adapters only. ``pool_dtype`` injects each
    version quantized: ``v_{k+1}`` is quantized inside ``D_k`` when a later
    step reads it (one pass per version read; a frozen base is quantized
    once). ``grad_compress="int8"`` runs the deposits through the
    error-feedback codec with the residual ``opt_state["grad_residual"]``
    threading across the chained steps. ``g0`` rotates the ring as in the
    synchronous driver (a supplied ``tick_program``'s stamp governs); the
    staleness-1 protocol is logical and so rotation-invariant."""
    _check_options(pool_dtype=pool_dtype, grad_compress=grad_compress)
    program = (_check_program(tick_program, plan, rounds, steps) if tick_program is not None
               else plan.tick_program(rounds, steps, g0=g0))
    del kv_chunk
    frozen = lora is not None
    opt = dict(opt_state)
    residual = opt.pop("grad_residual", None)
    if grad_compress != "none" and residual is None:
        raise ValueError("grad_compress needs opt_state['grad_residual']")
    pool_key = "lora" if frozen else "layers"
    pad = params[pool_key][cfg.n_layers:]          # padding rows: zero gradients
    mask = param_mask(params) if frozen else None
    losses, toks, gnorms = [], [], []

    def update(k, grads, loss, tokens, retired):
        grads[pool_key] += [tree_map(torch.zeros_like, p) for p in pad]
        if frozen:
            out = trainable_leaves(retired, mask) if retired is not None else None
            new_tr, _, m = apply_updates(opt, grads, opt_cfg,
                                         param_like=trainable_leaves(params, mask), out=out)
            new = merge_trainable(params, new_tr, mask)
        else:
            new, _, m = apply_updates(opt, grads, opt_cfg, param_like=params, out=retired)
        losses.append(loss)
        toks.append(tokens)
        gnorms.append(m["grad_norm"])
        return new

    batch_list = [{key: v[i] for key, v in batches.items()} for i in range(steps)]
    versions = _drive(params, batch_list, residual, update, cfg=cfg, plan=plan,
                      program=program, n_workers=n_workers, l_pad=l_pad,
                      xent_chunk=xent_chunk, ring_grad_dtype=ring_grad_dtype,
                      prefetch_program=prefetch_program, lora=lora, pool_dtype=pool_dtype,
                      grad_compress=grad_compress, transport=transport)
    if residual is not None:
        opt["grad_residual"] = residual
    metrics = {"loss": torch.stack(losses), "tokens": torch.stack(toks),
               "grad_norm": torch.stack(gnorms), "step": opt["step"]}
    return versions[steps], opt, metrics


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
    _check_options(pool_dtype=kw["pool_dtype"], grad_compress=kw["grad_compress"])
    _check_g0(kw.get("g0", 0), n_workers)
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
    ...}`` with ``n_layers`` rows). ``g0`` rotates the ring's endpoints
    (the supervisor's straggler rotation). With ``grad_compress="int8"``
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


def _select_schedule(step_cfg, plan, rounds: int, iterations: int):
    """Resolve ``step_cfg.schedule`` into the tick program the driver runs.

    ``"hand"`` (default) returns None: the driver generates the canonical
    ``plan.tick_program``. ``"searched"`` runs
    ``core.simulator.search_schedule`` over the schedule family (under
    ``step_cfg.device_scale``) and returns the certified winner's program,
    whose ``g0`` stamp (a rotation of the ring, where it wins) governs the
    run."""
    sel = getattr(step_cfg, "schedule", "hand")
    if sel == "hand":
        return None
    if sel == "searched":
        from repro_torch.core.simulator import search_schedule
        result = search_schedule(plan, rounds * plan.n_workers, iterations=iterations,
                                 device_scale=getattr(step_cfg, "device_scale", None))
        return result.program
    raise ValueError(f"unknown schedule selector {sel!r}: expected 'hand' or 'searched'")


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
    ``step_cfg.schedule="searched"`` runs the searched schedule's program
    (``_select_schedule``); otherwise ``step_cfg.g0`` rotates the ring.

    The train state keeps the pool padded at rest (``init_roundpipe_state``).
    Returns ``(step, plan)``; ``step(state, batch) -> (state, metrics)``
    updates the optimizer state in place and returns fresh parameters."""
    if global_batch % n_workers:
        raise ValueError("global batch must divide over the workers")
    if getattr(step_cfg, "strategy", "roundpipe") != "roundpipe":
        raise NotImplementedError(f"strategy {step_cfg.strategy!r} " + _LATER.format(
            "baselines and tooling"))
    if plan is None:
        plan = resolve_plan(cfg, step_cfg, n_workers)
    m_micro = getattr(step_cfg, "n_microbatches", None)
    rounds = None
    if m_micro is not None:
        rounds = plan.rounds_for(m_micro)
        if global_batch % m_micro:
            raise ValueError(f"global batch {global_batch} must be divisible by "
                             f"n_microbatches {m_micro} (micro-batch size = global_batch / M)")
    ticks = _select_schedule(step_cfg, plan, rounds or 1, 1)
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
                    g0=getattr(step_cfg, "g0", 0), tick_program=ticks, transport=transport)

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

def build_roundpipe_async_train_step(cfg: ModelConfig, n_workers: int, step_cfg,
                                     global_batch: int, seq_len: int, *, steps_per_call: int,
                                     plan=None, overlap: bool = True, transport=None):
    """The cross-step staleness-1 train program (paper §4.3, DESIGN.md §6):
    ``multi_step(state, batches) -> (state, metrics)`` runs
    ``steps_per_call`` optimizer steps back to back in one chained ring
    program (``roundpipe_async_forward_backward``), so the fill/drain bubble
    amortizes to ``(N-1)/(I*R*S + N-1)`` (``simulate_plan(...,
    iterations=I)``).

    ``batches`` leaves carry a leading ``(steps_per_call,)`` axis of flat
    global batches; ``metrics["loss"/"tokens"/"grad_norm"]`` come back with
    shape ``(steps_per_call,)``. The state is the synchronous step's
    ``{"params", "opt"}`` (``init_roundpipe_state``), so checkpoints
    interchange; its parameter tensors are taken over by the call (see
    ``roundpipe_async_forward_backward``) and the optimizer state is updated
    in place. The last update is applied before returning, so the result
    matches ``core.consistency.reference_staleness1``.

    The program is certified at build time: ``plan.validate_async(R)``, then
    ``verify_async_ticks(plan, R, I, program=...)``. ``overlap=False`` loops
    the synchronous step (staleness 0), bit-identical to calling
    ``build_roundpipe_train_step``'s step ``steps_per_call`` times.
    ``step_cfg.lora``, ``.pool_dtype``, ``.grad_compress``, ``.prefetch``
    and ``.schedule`` compose as in the synchronous step.

    Returns ``(multi_step, plan)``."""
    from repro_torch.core.consistency import verify_async_ticks

    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
    if global_batch % n_workers:
        raise ValueError("global batch must divide over the workers")
    if getattr(step_cfg, "strategy", "roundpipe") != "roundpipe":
        raise NotImplementedError(f"strategy {step_cfg.strategy!r} " + _LATER.format(
            "baselines and tooling"))
    if plan is None:
        plan = resolve_plan(cfg, step_cfg, n_workers)
    m_micro = getattr(step_cfg, "n_microbatches", None) or n_workers
    rounds = plan.rounds_for(m_micro)
    if global_batch % m_micro:
        raise ValueError(f"global batch {global_batch} must be divisible by n_microbatches "
                         f"{m_micro}")

    if not overlap:
        sync_step, plan = build_roundpipe_train_step(cfg, n_workers, step_cfg, global_batch,
                                                     seq_len, plan=plan, transport=transport)

        def multi_step(state, batches):
            per_step = []
            for i in range(steps_per_call):
                state, m = sync_step(state, {k: v[i] for k, v in batches.items()})
                per_step.append(m)
            metrics = {k: torch.stack([m[k] for m in per_step])
                       for k in ("loss", "tokens", "grad_norm")}
            metrics["step"] = per_step[-1]["step"]
            return state, metrics

        return multi_step, plan

    plan = _plan_for(cfg, n_workers, plan)
    plan.validate_async(rounds)
    ticks = _select_schedule(step_cfg, plan, rounds, steps_per_call)
    if ticks is None:
        ticks = plan.tick_program(rounds, steps_per_call, g0=getattr(step_cfg, "g0", 0))
    _check_options(pool_dtype=getattr(step_cfg, "pool_dtype", "none"),
                   grad_compress=getattr(step_cfg, "grad_compress", "none"))
    # certify that the chained tick order satisfies the five §4.3 constraints
    # and that the program's annotations match the protocol replay
    verify_async_ticks(plan, rounds, steps_per_call, program=ticks)
    program = None
    if getattr(step_cfg, "prefetch", True):
        program = plan.prefetch_program(
            chunk_limit=getattr(step_cfg, "prefetch_chunk_limit", None))
        program.validate(plan)
    body = functools.partial(
        roundpipe_async_forward_backward, cfg=cfg, plan=plan, n_workers=n_workers,
        l_pad=pool_rows(cfg, n_workers), steps=steps_per_call, rounds=rounds,
        opt_cfg=step_cfg.opt, xent_chunk=step_cfg.xent_chunk, kv_chunk=step_cfg.kv_chunk,
        ring_grad_dtype=step_cfg.accum_dtype, prefetch_program=program,
        lora=getattr(step_cfg, "lora", None),
        pool_dtype=getattr(step_cfg, "pool_dtype", "none"),
        grad_compress=getattr(step_cfg, "grad_compress", "none"), tick_program=ticks,
        transport=transport)

    def multi_step(state, batches):
        # (I, G, ...) -> (I, R, G/R, ...): step i's round r owns micro-batch
        # groups r*N..(r+1)*N-1 of that step's global batch
        batches = {k: v.reshape(v.shape[0], rounds, v.shape[1] // rounds, *v.shape[2:])
                   for k, v in batches.items()}
        params, opt, metrics = body(state["params"], state["opt"], batches)
        return {"params": params, "opt": opt}, metrics

    return multi_step, plan


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


def _pool_depth(node, pooled: bool = False):
    """The row count of the first pooled leaf in ``jax.tree_util`` order (dict
    keys sorted): a pooled list's length, or a stacked pooled tensor's leading
    dimension. None when the tree holds no pooled leaf."""
    if isinstance(node, dict):
        for k in sorted(node):
            depth = _pool_depth(node[k], pooled or k in POOLED_KEYS)
            if depth is not None:
                return depth
        return None
    if isinstance(node, list):
        return len(node) if pooled and node else None
    return node.shape[0] if pooled and node.ndim >= 1 else None


def reshape_pooled_state(state, cfg: ModelConfig, n_new: int):
    """Elastic-restore transform: re-pad every pooled leaf of ``state`` (a
    train state written under some earlier worker count) to the
    ``pool_rows(cfg, n_new)`` layout.

    Only the padding rows depend on the worker count: the first
    ``cfg.n_layers`` rows are the model and the padding rows are zero (never
    part of a slot, zero gradients, zero moments), so slice-then-repad loses
    nothing. The writer's pool depth is read from the tree itself. The pooled
    leaves are the lists under ``params["layers"]``, ``params["lora"]``, their
    optimizer mirrors (fp32 master, moments) and ``opt["grad_residual"]``,
    which keep their first ``n_layers`` rows and gain ``zeros_like`` rows,
    and the stacked tensors on such paths whose leading dimension is the old
    depth (Adafactor's factored statistics of the layer pool), re-padded on
    axis 0; Adafactor's statistics that drop the pool dimension pass through
    untouched, as in the reference. Tensors stay on their devices; no data
    is copied but the re-padded stacks."""
    rows_old = _pool_depth(state)
    rows_new = pool_rows(cfg, n_new)
    if rows_old is None or rows_old == rows_new:
        return state
    if rows_old < cfg.n_layers:
        raise ValueError(f"pool depth {rows_old} in the restored state is smaller than "
                         f"n_layers={cfg.n_layers}: not a padded pool for this model")
    pad = rows_new - cfg.n_layers

    def fix(node, pooled):
        if isinstance(node, dict):
            return {k: fix(v, pooled or k in POOLED_KEYS) for k, v in node.items()}
        if isinstance(node, list):
            if not pooled or len(node) != rows_old:
                return node
            return node[:cfg.n_layers] + [tree_map(torch.zeros_like, node[0])
                                          for _ in range(pad)]
        if not pooled or node.ndim < 1 or node.shape[0] != rows_old:
            return node
        real = node[:cfg.n_layers]
        return torch.cat([real, real.new_zeros((pad, *real.shape[1:]))])

    return fix(state, False)
