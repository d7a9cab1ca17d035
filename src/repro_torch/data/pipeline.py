# Copied from src/repro/data/pipeline.py; tests/test_torch_plan.py holds the
# copy equal to it, apart from sharded_batches, which places torch tensors.
"""Deterministic data pipeline: synthetic corpus, document packing, sharded
host loading.

Every batch is a pure function of (seed, step) — restart-safe (the checkpoint
stores the step, the pipeline regenerates the identical stream) and
host-shardable (each data-parallel host materialises only its slice; the
``jax.make_array_from_process_local_data`` pattern on real multi-host pods,
plain ``device_put`` under the dry-run's single process).
"""
from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass(frozen=True)
class DataConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    pad_id: int = 0
    ignore_index: int = -100
    # > 0: emit batches in RoundPipe's round-major layout (R, B/R, S) —
    # round r owns samples r*B/R..(r+1)*B/R-1 of the same stream, exactly
    # the split the compiled step used to perform with an in-step reshape
    # (sample-identical to the flat layout by construction).  0 = flat (B, S).
    rounds: int = 0

    def __post_init__(self):
        if self.rounds and self.global_batch % self.rounds:
            raise ValueError(
                f"global_batch {self.global_batch} not divisible by "
                f"rounds {self.rounds}")


class SyntheticLMDataset:
    """Zipf-distributed token stream with document structure (BOS-delimited),
    mimicking packed-corpus statistics well enough for throughput work."""

    def __init__(self, cfg: DataConfig):
        self.cfg = cfg
        ranks = np.arange(1, cfg.vocab_size, dtype=np.float64)
        probs = 1.0 / ranks ** 1.1
        self._probs = probs / probs.sum()

    def batch(self, step: int) -> dict:
        """Returns {tokens, labels} int32 for ``step``: (B, S) flat, or the
        round-major (R, B/R, S) when ``cfg.rounds`` is set (same samples in
        the same order — only the leading axis is factored)."""
        cfg = self.cfg
        rng = np.random.default_rng(np.random.SeedSequence([cfg.seed, step]))
        toks = rng.choice(cfg.vocab_size - 1, p=self._probs,
                          size=(cfg.global_batch, cfg.seq_len + 1)) + 1
        # document boundaries: geometric lengths, BOS token = pad_id
        doc_mask = rng.random((cfg.global_batch, cfg.seq_len + 1)) < 1 / 512
        toks = np.where(doc_mask, cfg.pad_id, toks).astype(np.int32)
        tokens = toks[:, :-1]
        labels = toks[:, 1:].astype(np.int32)
        # don't predict across document starts
        labels = np.where(tokens == cfg.pad_id, cfg.ignore_index, labels)
        out = {"tokens": tokens, "labels": labels}
        if cfg.rounds:
            out = {k: v.reshape(cfg.rounds, cfg.global_batch // cfg.rounds,
                                cfg.seq_len) for k, v in out.items()}
        return out

    def host_shard(self, step: int, host_index: int, n_hosts: int) -> dict:
        """The per-host slice of the global batch (multi-host loading).
        Round-major batches slice the PER-ROUND batch dim — every host sees
        every round, holding its slice of each round's samples (the dim the
        step shards over the mesh)."""
        b = self.batch(step)
        dim = 1 if self.cfg.rounds else 0
        per = b["tokens"].shape[dim] // n_hosts
        sl = slice(host_index * per, (host_index + 1) * per)
        if self.cfg.rounds:
            return {k: v[:, sl] for k, v in b.items()}
        return {k: v[sl] for k, v in b.items()}


def pack_documents(docs: list[np.ndarray], seq_len: int, pad_id: int = 0,
                   ignore_index: int = -100):
    """Greedy sequence packing: concatenate documents into fixed-length rows,
    masking cross-document prediction.  Returns (tokens (N,S), labels (N,S))."""
    rows, cur = [], []
    for d in docs:
        d = list(d)
        while d:
            space = seq_len + 1 - len(cur)
            cur.extend(d[:space])
            d = d[space:]
            if len(cur) == seq_len + 1:
                rows.append(cur)
                cur = []
    if cur:
        cur.extend([pad_id] * (seq_len + 1 - len(cur)))
        rows.append(cur)
    arr = np.asarray(rows, np.int32)
    tokens, labels = arr[:, :-1], arr[:, 1:].copy()
    labels[tokens == pad_id] = ignore_index
    return tokens, labels


def sharded_batches(dataset: SyntheticLMDataset, start_step: int,
                    device=None):
    """Infinite iterator of batches from ``start_step``, as torch tensors on
    ``device`` (left as numpy arrays when ``device`` is None)."""
    import torch

    step = start_step
    while True:
        b = dataset.batch(step)
        if device is not None:
            b = {k: torch.from_numpy(v).to(device) for k, v in b.items()}
        yield step, b
        step += 1
