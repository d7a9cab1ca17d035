"""The slot ring's primitives for the synchronous driver, and the transport
that moves blocks between logical workers.

The PyTorch counterpart of the sync subset of ``repro/core/ring.py``:
``shift_perm``, ``RingMachine.shift`` (with the rotation ``g0``),
``layer_fwd``, ``stage_fwd``, ``fused_loss``, ``assemble_block``,
``deposit_plain`` and ``deposit_ef``; the dense payload codec of the prefetch
path (``chunk_elem_range``, ``upload_slot``, ``promote_standby``,
``zeros_standby``); the quantized codec (``quantize_pool``,
``zeros_standby_q``, ``upload_slot_q``, ``dequant_block``,
``assemble_block_q``); the helpers ``zeros_block``, ``block_row`` and
``gbuf_add``, and the per-step accumulator family ``StepAccum``. The
reference's async accumulators (``ParityAccum``, 2-deep buffers indexed by a
traced step) have no counterpart: here each worker's step at each tick is a
Python int, so the chained driver keeps one ``StepAccum`` set per step
(``core.dispatch._Step``) and frees it at the step's deposit-complete tick.

The reference runs N workers as N devices under ``shard_map``, and a hop is
a ``ppermute``. Here the N workers are logical: one process drives all of
them on one device, and every move between workers (a hop, a gathered row, a
streamed chunk, a code or scale row, a residual row, a deposit) goes through
one transport object, and every call names its source and destination
workers as physical indices. ``OneCardTransport`` moves references, not bytes
(all workers share the device); a multi-card transport over
``torch.distributed`` (NCCL, ``batch_isend_irecv``) takes its place without
touching the driver.

``g0`` rotates the logical ring positions onto the physical workers (the
paper's slot -> worker map ``(g0 + i) mod N``): injection enters at physical
worker ``g0`` (logical 0) and the reduced wave leaves at physical ``(g0 + N -
1) mod N`` (logical N-1). Physical worker p plays logical ``(p - g0) mod N``
and keeps its own micro-batch group; pool ownership stays physical, so the
pool shards never move and only the ring's endpoints rotate. ``g0 = 0`` is
the unrotated ring, move for move.

A block is a list of per-layer parameter dicts, one per real layer of the
slot. Eager PyTorch knows each slot's size, so there are no padding rows and
no identity masks: ``stage_fwd`` folds exactly the slot's layers, a gradient
buffer holds exactly one row per layer of its block, and a quantized slot
dequantizes exactly its own rows. In the frozen-base LoRA mode an adapter
block (a list of per-layer adapter dicts) rides beside each dense block: it
is gathered whole from the adapter pool's owners, hops through the same
transport calls, and the slot computations run on the merged weights.

Flat rows (a streamed chunk's byte range, a quantized pool row) lay a
layer's leaves end to end in the reference's flatten order, which sorts dict
keys (``flat_leaves``): ``attn{w_k,w_o,w_q,w_v}``, ``mlp``, ``norm1``,
``norm2``. The port's dicts keep insertion order, and a scale block spans
leaf boundaries, so any other order would quantize differently.
"""
from __future__ import annotations

import itertools
import math

import torch

from repro_torch.core.partition import POOL_DTYPE_BITS
from repro_torch.kernels import ops as kops
from repro_torch.kernels.dequant import quantize_rows
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_norm
from repro_torch.models.lora import merge_layers
from repro_torch.optim.adam import tree_map
from repro_torch.optim.compress import compress_int8, decompress_int8


def flat_leaves(tree) -> list:
    """The leaves of nested dicts and lists in ``jax.tree_util`` order: dict
    keys sorted, lists in order."""
    if isinstance(tree, dict):
        return [x for k in sorted(tree) for x in flat_leaves(tree[k])]
    if isinstance(tree, list):
        return [x for v in tree for x in flat_leaves(v)]
    return [tree]


def _fill(node, it):
    if isinstance(node, dict):
        got = {k: _fill(node[k], it) for k in sorted(node)}
        return {k: got[k] for k in node}
    if isinstance(node, list):
        return [_fill(v, it) for v in node]
    return next(it)


def unflatten_like(template, leaves):
    """``template``'s structure, in its own key order, holding ``leaves``
    given in ``flat_leaves`` order. The walk is a module function: a closure
    that calls itself is a reference cycle, which would keep ``leaves`` (a
    promoted standby's views) alive until the garbage collector runs."""
    return _fill(template, iter(leaves))


def shift_perm(n: int, g0: int = 0) -> list[tuple[int, int]]:
    """Open-ring hop as physical (src, dst) pairs: logical position i moves to
    i+1 and logical N-1 drops off, with logical i at physical ``(g0 + i) %
    n``. ``g0 = 0`` is ``[(0, 1), ..., (n-2, n-1)]``."""
    return [((g0 + i) % n, (g0 + i + 1) % n) for i in range(n - 1)]


def zeros_block(block, dtype=torch.float32):
    """A zero gradient buffer shaped like ``block``, in ``dtype``."""
    return tree_map(lambda a: torch.zeros(a.shape, dtype=dtype, device=a.device), block)


def block_row(block, k):
    return block[k]


def gbuf_add(gbuf, delta):
    """Accumulate a block's gradients into the traveling buffer, in the
    buffer's own dtype (fp32 for exactness)."""
    return tree_map(lambda a, d: a.add_(d.to(a.dtype)), gbuf, delta)


class StepAccum:
    """Per-step accumulators: one buffer per quantity, accumulated across
    every tick and read once at the end of the step (the synchronous
    driver's shape). Adds are in place."""

    @staticmethod
    def zeros(shape, dtype, device):
        return torch.zeros(shape, dtype=dtype, device=device)

    @staticmethod
    def tree_zeros(tree, dtype):
        return tree_map(lambda a: torch.zeros(a.shape, dtype=dtype, device=a.device), tree)

    @staticmethod
    def add(acc, val):
        return acc.add_(val)

    @staticmethod
    def add_f32(acc, val):
        return acc.add_(val.float())

    @staticmethod
    def tree_add_f32(acc, val):
        return tree_map(lambda a, d: a.add_(d.float()), acc, val)

    @staticmethod
    def token_add(acc, tok, val):
        """acc[tok] += val for token ids ``tok`` (any shape) and rows ``val``."""
        return acc.index_add_(0, tok.reshape(-1), val.reshape(-1, val.shape[-1]).float())


class OneCardTransport:
    """Every ring move for N logical workers that share one device. Workers
    are named by physical index.

    ``shift`` is the open-ring hop along ``perm`` (``shift_perm``'s pairs:
    each source's entry moves to its destination; the worker no pair reaches
    receives nothing); ``gather`` is the owner -> injection-worker copy of one
    pool row; ``send`` moves one payload (a streamed chunk, a code or scale
    row, a residual row, a compressed deposit) from worker ``src`` to worker
    ``dst``; ``deposit`` is the ``src`` -> owner copy of one fully reduced
    gradient row (``src`` is the tail, or the owner itself when the row
    crossed already), summed into the owner's accumulator. On one device
    each is a move of references."""

    def __init__(self, n_workers: int):
        self.n = n_workers

    def shift(self, entries: list, perm) -> list:
        if len(entries) != self.n:
            raise ValueError(f"ring of {len(entries)} entries for {self.n} workers")
        out = [None] * self.n
        for src, dst in perm:
            out[dst] = entries[src]
        return out

    def gather(self, shards, owner: int, idx: int, dst: int):
        del dst
        return shards[owner][idx]

    def send(self, payload, src: int, dst: int):
        del src, dst
        return payload

    def deposit(self, grad_shards, owner: int, idx: int, row, src: int):
        del src
        have = grad_shards[owner][idx]
        grad_shards[owner][idx] = row if have is None else tree_map(torch.add, have, row)


class RingMachine:
    """The ring plumbing of one compiled plan: which layers a slot holds,
    where each lives in the pool, the slot computations, and the payload
    codecs that fill a slot's block from the pool.

    ``pool_template`` is one pool row (a layer dict): it fixes the leaves'
    flatten order, shapes and dtypes, and so the flat row layout that chunks
    and quantized rows index. ``prefetch_program`` supplies the per-slot
    chunk tables of the standby uploads; ``pool_dtype`` selects the quantized
    codec ("int8" or "int4") or none; ``lora`` (a ``LoraConfig``) is the
    adapters' scale for the merged weights of the frozen-base mode. ``g0``
    rotates the ring (module docstring): ``inj`` and ``tail`` are the
    physical workers of logical 0 and N-1, and ``phys(w)`` is logical w's."""

    def __init__(self, *, cfg: ModelConfig, plan, n_workers: int, l_pad: int, transport,
                 pool_template, xent_chunk: int = 256, prefetch_program=None,
                 pool_dtype: str = "none", lora=None, g0: int = 0):
        if not 0 <= g0 < n_workers:
            raise ValueError(f"g0 must be in [0, {n_workers}), got {g0}")
        if l_pad % n_workers:
            raise ValueError(f"pool of {l_pad} rows over {n_workers} workers")
        if pool_dtype != "none" and pool_dtype not in POOL_DTYPE_BITS:
            raise ValueError(f"unknown pool_dtype {pool_dtype!r}; expected "
                             f"none|{'|'.join(POOL_DTYPE_BITS)}")
        self.cfg = cfg
        self.plan = plan
        self.n = n_workers
        self.per = l_pad // n_workers
        self.g0 = g0
        self.inj = g0                               # physical worker of logical 0
        self.tail = (g0 + n_workers - 1) % n_workers    # and of logical N-1
        self.perm = shift_perm(n_workers, g0)
        self.transport = transport
        self.xent_chunk = xent_chunk
        self.prefetch_program = prefetch_program
        self.pool_dtype = pool_dtype
        self.lora = lora
        self.kmax = plan.max_block
        self.template = pool_template
        leaves = flat_leaves(pool_template)
        self.leaf_shapes = [tuple(x.shape) for x in leaves]
        self.leaf_dtypes = [x.dtype for x in leaves]
        self.leaf_elems = [int(math.prod(s)) for s in self.leaf_shapes]
        self.leaf_offs = list(itertools.accumulate([0] + self.leaf_elems[:-1]))
        self.row_elems = sum(self.leaf_elems)
        self.device = leaves[0].device
        # the dequantized rows come out in the leaves' dtype when they share
        # one, so no fp32 copy of a block is ever made
        dtypes = set(self.leaf_dtypes)
        self.dequant_dtype = dtypes.pop() if len(dtypes) == 1 else torch.float32

    def shards(self, pool: list) -> list:
        """The pool (a list of per-layer dicts, padded or not) cut into the
        workers' shards by ``plan.pool_layout``: worker w owns rows
        [w * per, (w + 1) * per)."""
        return [pool[w * self.per:(w + 1) * self.per] for w in range(self.n)]

    def owner(self, lid: int) -> tuple[int, int]:
        return divmod(lid, self.per)

    def phys(self, w: int) -> int:
        """The physical worker that plays logical ring position ``w``."""
        return (w + self.g0) % self.n

    # ---- ring hop ----------------------------------------------------------
    def shift(self, entries: list) -> list:
        """One open-ring hop of ``entries`` (indexed by physical worker):
        every entry moves one logical position up, logical N-1's drops off."""
        return self.transport.shift(entries, self.perm)

    # ---- stage compute -----------------------------------------------------
    def layer_fwd(self, x, lw, aw=None):
        """One layer over x; with its adapter row ``aw``, on the merged
        weights W + (alpha/r) B@A, formed here so that autograd reaches the
        adapters through them (and freed with the layer's activations)."""
        if aw is not None:
            lw = merge_layers(lw, aw, self.lora)
        return T.layer_forward(x, lw, self.cfg)

    def stage_fwd(self, block, x, ablock=None):
        """Fold a block's layers over x (merged with ``ablock``'s adapters
        when given)."""
        for k, lw in enumerate(block):
            x = self.layer_fwd(x, lw, None if ablock is None else ablock[k])
        return x

    def fused_loss(self, block, fnorm, hw, x, labels_cur, ablock=None):
        """The FB slot's forward: the deepest body block (possibly empty),
        the final norm and the LM-head cross-entropy -> (loss sum, count)."""
        x = self.stage_fwd(block, x, ablock)
        h = apply_norm(x, fnorm, self.cfg.norm_kind, self.cfg.norm_eps)
        return T.chunked_softmax_xent(h, hw, labels_cur, chunk=self.xent_chunk)

    # ---- dense payload codec -----------------------------------------------
    def assemble_block(self, spec, shards) -> list:
        """Gather slot ``spec``'s layers from their pool owners to the
        injection worker (logical 0, physical ``inj``)."""
        return [self.transport.gather(shards, *self.owner(lid), self.inj)
                for lid in spec.layers]

    def chunk_elem_range(self, cu) -> tuple[int, int]:
        """A chunk's plan-byte range as an element range of the flat row (the
        cost model's byte total need not match the leaves' dtype)."""
        if cu.parent_bytes <= 0:
            return 0, self.row_elems
        return (cu.lo * self.row_elems // cu.parent_bytes,
                cu.hi * self.row_elems // cu.parent_bytes)

    def zeros_standby(self, rows: int) -> list:
        """A standby for ``rows`` layers: one (rows, *shape) buffer per leaf,
        in ``flat_leaves`` order."""
        return [torch.zeros((rows,) + s, dtype=d, device=self.device)
                for s, d in zip(self.leaf_shapes, self.leaf_dtypes)]

    def upload_slot(self, stand: list, slot_idx: int, shards) -> list:
        """Stream slot ``slot_idx``'s chunks into the standby leaves, one copy
        per (chunk x overlapped leaf), in the table's window order. The
        chunks partition every row, so the union of the writes is the whole
        block. ``shards`` is the pool cut by worker."""
        for cu in self.prefetch_program.uploads[slot_idx]:
            if cu.row < 0:              # the replicated LM head is never streamed
                continue
            a, b = self.chunk_elem_range(cu)
            src_leaves = flat_leaves(shards[cu.owner][cu.pool_row])
            for i, (off, ne) in enumerate(zip(self.leaf_offs, self.leaf_elems)):
                la, lb = max(a - off, 0), min(b - off, ne)
                if la >= lb:
                    continue
                src = self.transport.send(src_leaves[i].reshape(-1)[la:lb], cu.owner, self.inj)
                stand[i].view(stand[i].shape[0], -1)[cu.row, la:lb].copy_(src)
        return stand

    def promote_standby(self, stand: list, spec) -> list:
        """Standby -> injection block: one layer dict per real row, its leaves
        views of the standby buffers."""
        return [unflatten_like(self.template, [x[k] for x in stand]) for k in range(spec.size)]

    # ---- quantized payload codec -------------------------------------------
    def quantize_pool(self, shards) -> list:
        """One quantization pass over every worker's shard: per shard, the
        (codes (per, code_len), scales (per, nb)) image that the uploads ship.
        Row by row, so no fp32 copy of a whole shard is made; each row lays
        its leaves end to end in ``flat_leaves`` order, as the reference's
        whole-shard pass does, and gets its codes bit for bit."""
        bits = POOL_DTYPE_BITS[self.pool_dtype]
        out = []
        for shard in shards:
            codes = scales = None
            for i, row in enumerate(shard):
                cat = torch.cat([x.reshape(-1).float() for x in flat_leaves(row)])
                c, s = quantize_rows(cat[None], bits=bits)
                if codes is None:
                    codes = torch.empty((len(shard), c.shape[1]), dtype=c.dtype,
                                        device=c.device)
                    scales = torch.empty((len(shard), s.shape[1]), dtype=s.dtype,
                                         device=s.device)
                codes[i], scales[i] = c[0], s[0]
                del cat, c, s
            out.append((codes, scales))
        return out

    def zeros_standby_q(self, qpool) -> tuple:
        """A quantized standby of ``kmax`` rows: codes and fp32 scales."""
        q_codes, q_scales = qpool[0]
        return (torch.zeros((self.kmax, q_codes.shape[1]), dtype=q_codes.dtype,
                            device=q_codes.device),
                torch.zeros((self.kmax, q_scales.shape[1]), dtype=torch.float32,
                            device=q_scales.device))

    def upload_slot_q(self, stand: tuple, slot_idx: int, qpool) -> tuple:
        """Quantized standby fill: each chunk's plan-byte range maps onto code
        columns in proportion, with exact end points, so the chunks still
        partition every row; the row's fp32 scales ride its first chunk."""
        codes, scales = stand
        code_len = qpool[0][0].shape[1]
        for cu in self.prefetch_program.uploads[slot_idx]:
            if cu.row < 0:              # the replicated LM head is never streamed
                continue
            q_codes, q_scales = qpool[cu.owner]
            if cu.parent_bytes <= 0:
                la, lb = 0, code_len
            else:
                la = cu.lo * code_len // cu.parent_bytes
                lb = cu.hi * code_len // cu.parent_bytes
            if la < lb:
                codes[cu.row, la:lb].copy_(
                    self.transport.send(q_codes[cu.pool_row, la:lb], cu.owner, self.inj))
            if cu.lo == 0:
                scales[cu.row].copy_(self.transport.send(q_scales[cu.pool_row], cu.owner,
                                                         self.inj))
        return codes, scales

    def dequant_block(self, codes, scales, spec) -> list:
        """Dequant-on-upload: the slot's own rows of codes and scales -> its
        block in compute precision, in one ``kops.dequant_rows`` launch. The
        leaves are views of the dequantized rows."""
        flat = kops.dequant_rows(codes[:spec.size], scales[:spec.size],
                                 out_dtype=self.dequant_dtype)
        return [self._split_row(flat[k]) for k in range(spec.size)]

    def _split_row(self, flat_row):
        leaves = [flat_row[off:off + ne].view(s).to(d) for s, d, off, ne in
                  zip(self.leaf_shapes, self.leaf_dtypes, self.leaf_offs, self.leaf_elems)]
        return unflatten_like(self.template, leaves)

    def assemble_block_q(self, spec, qpool) -> list:
        """Whole-block injection, quantized: gather the slot's code and scale
        rows from their owners, then one dequant."""
        if not spec.layers:
            return []
        crows, srows = [], []
        for lid in spec.layers:
            owner, idx = self.owner(lid)
            crows.append(self.transport.send(qpool[owner][0][idx], owner, self.inj))
            srows.append(self.transport.send(qpool[owner][1][idx], owner, self.inj))
        return self.dequant_block(torch.stack(crows), torch.stack(srows), spec)

    # ---- gradient deposits (a slot leaves the ring at logical N-1, ``tail``) -
    def deposit_plain(self, grad_shards, row, lid: int) -> None:
        """Exact fp32 deposit: the fully ring-reduced row of layer ``lid`` (a
        layer's or, frozen-base, its adapters') crosses from the tail worker
        to its owner and sums into the owner's accumulator row."""
        owner, idx = self.owner(lid)
        self.transport.deposit(grad_shards, owner, idx, tree_map(lambda a: a.float(), row),
                               self.tail)

    def deposit_ef(self, grad_shards, res_shards, row, lid: int) -> None:
        """Error-feedback int8 deposit: per leaf, the tail compresses the
        reduced row plus the row's carried residual; codes and scales cross
        to the owner, which dequantizes them into its accumulator and keeps
        the fresh residual for the next deposit into this row. Only the
        owner's residual row changes; it is updated in place."""
        owner, idx = self.owner(lid)
        tx = self.transport
        res_row = res_shards[owner][idx]
        deq = []
        for res, rw in zip(flat_leaves(res_row), flat_leaves(row)):
            codes, scale, fresh = compress_int8(rw.float(), tx.send(res, owner, self.tail))
            codes, scale = tx.send(codes, self.tail, owner), tx.send(scale, self.tail, owner)
            res.copy_(tx.send(fresh, self.tail, owner))
            deq.append(decompress_int8(codes, scale, rw.shape))
        tx.deposit(grad_shards, owner, idx, unflatten_like(res_row, deq), owner)
