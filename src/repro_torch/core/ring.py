"""The slot ring's primitives for the synchronous driver, and the transport
that moves blocks between logical workers.

The PyTorch counterpart of the sync subset of ``repro/core/ring.py``:
``RingMachine.shift``, ``stage_fwd``, ``fused_loss``, ``assemble_block`` and
``deposit_plain``, the helpers ``zeros_block``, ``block_row`` and
``gbuf_add``, and the per-step accumulator family ``StepAccum``. The async
accumulators (``ParityAccum``), the quantized codec, ``deposit_ef``,
``upload_slot`` and ``promote_standby`` are later slices (ROADMAP.md, Queue 1).

The reference runs N workers as N devices under ``shard_map``, and a hop is
a ``ppermute``. Here the N workers are logical: one process drives all of
them on one device, and every move between workers goes through one
transport object. ``OneCardTransport`` moves references, not bytes (all
workers share the device); a multi-card transport over ``torch.distributed``
(NCCL, ``batch_isend_irecv``) takes its place without touching the driver.

A block is a list of per-layer parameter dicts, one per real layer of the
slot. Eager PyTorch knows each slot's size, so there are no padding rows and
no identity masks: ``stage_fwd`` folds exactly the slot's layers, and a
gradient buffer holds exactly one row per layer of its block.
"""
from __future__ import annotations

import torch

from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig
from repro_torch.models.layers import apply_norm
from repro_torch.optim.adam import tree_map


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
    """Every ring move for N logical workers that share one device.

    ``shift`` is the open-ring hop (logical worker i's entry moves to i+1;
    worker N-1's drops off, and worker 0 receives nothing); ``gather`` is the
    owner -> injection-worker copy of one pool row; ``deposit`` is the
    tail -> owner copy of one fully reduced gradient row, summed into the
    owner's accumulator. On one device each is a move of references."""

    def __init__(self, n_workers: int):
        self.n = n_workers

    def shift(self, entries: list) -> list:
        if len(entries) != self.n:
            raise ValueError(f"ring of {len(entries)} entries for {self.n} workers")
        return [None] + entries[:-1]

    def gather(self, shards, owner: int, idx: int):
        return shards[owner][idx]

    def deposit(self, grad_shards, owner: int, idx: int, row):
        have = grad_shards[owner][idx]
        grad_shards[owner][idx] = row if have is None else tree_map(torch.add, have, row)


class RingMachine:
    """The ring plumbing of one compiled plan: which layers a slot holds,
    where each lives in the pool, and the slot computations."""

    def __init__(self, *, cfg: ModelConfig, plan, n_workers: int, l_pad: int, transport,
                 xent_chunk: int = 256):
        if l_pad % n_workers:
            raise ValueError(f"pool of {l_pad} rows over {n_workers} workers")
        self.cfg = cfg
        self.plan = plan
        self.n = n_workers
        self.per = l_pad // n_workers
        self.transport = transport
        self.xent_chunk = xent_chunk

    def shards(self, pool: list) -> list:
        """The pool (a list of per-layer dicts, padded or not) cut into the
        workers' shards by ``plan.pool_layout``: worker w owns rows
        [w * per, (w + 1) * per)."""
        return [pool[w * self.per:(w + 1) * self.per] for w in range(self.n)]

    def owner(self, lid: int) -> tuple[int, int]:
        return divmod(lid, self.per)

    # ---- ring hop ----------------------------------------------------------
    def shift(self, entries: list) -> list:
        return self.transport.shift(entries)

    # ---- stage compute -----------------------------------------------------
    def stage_fwd(self, block, x):
        """Fold a block's layers over x."""
        for lw in block:
            x = T.layer_forward(x, lw, self.cfg)
        return x

    def fused_loss(self, block, fnorm, hw, x, labels_cur):
        """The FB slot's forward: the deepest body block (possibly empty),
        the final norm and the LM-head cross-entropy -> (loss sum, count)."""
        x = self.stage_fwd(block, x)
        h = apply_norm(x, fnorm, self.cfg.norm_kind, self.cfg.norm_eps)
        return T.chunked_softmax_xent(h, hw, labels_cur, chunk=self.xent_chunk)

    # ---- injection and deposit ---------------------------------------------
    def assemble_block(self, spec, shards) -> list:
        """Gather slot ``spec``'s layers from their pool owners to the
        injection worker (logical 0)."""
        return [self.transport.gather(shards, *self.owner(lid)) for lid in spec.layers]

    def deposit_plain(self, grad_shards, row, lid: int) -> None:
        """Exact fp32 deposit: the fully ring-reduced row of layer ``lid``
        crosses from the tail worker to its owner and sums into the owner's
        accumulator row."""
        owner, idx = self.owner(lid)
        self.transport.deposit(grad_shards, owner, idx, tree_map(lambda a: a.float(), row))
