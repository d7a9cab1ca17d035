"""The port's multi-round ring and its prefetch path against the JAX
reference, on the CPU.

The sizes of ``tests/roundpipe_subprocess.py`` ``run_rounds``: the smoke
qwen3-1.7b config at 7 layers on the auto plan, N=4 ring workers, 8 samples
of 16 tokens per round (2 per worker), xent and kv chunks of 8; weights from
the reference's ``init_params`` through ``convert.params_from_jax``, batches
from numpy seeds. Bars:

* R in {1, 2, 3} rounds against ``jax.value_and_grad(T.loss_fn)`` over the
  whole R*8-sample batch: loss rtol 1e-4, worst relative grad error < 5e-3;
  R = 1 bit-identical to the one-round path with a flat batch;
* the dense standby prefetch with every row split into chunks, at one and at
  two rounds: bit-identical to whole-block injection;
* the train step with round-major batches: bit-identical to the same step
  fed flat batches;
* the launcher with ``--microbatches``, ``--pool-dtype`` and
  ``--grad-compress``: runs at smoke width on the CPU.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import transformer as JT
from repro.models.config import get_config as j_get_config
from repro_torch.configs import smoke_config
from repro_torch.core import dispatch, plan
from repro_torch.data import DataConfig, SyntheticLMDataset
from repro_torch.launch import train
from repro_torch.launch.steps import StepConfig
from repro_torch.models.config import get_config
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.optim import OptConfig


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: smoke-width ops gain nothing from more, and the
    suite's parallel workers share the cores with the JAX package's
    multi-device subprocess tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCH = "qwen3-1.7b"
N, B_ROUND, S, L = 4, 8, 16, 7


def npf(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def worst_rel(ref_tree, got_tree):
    """max over leaves of |got - ref|_inf / (|ref|_inf + 1e-6), as the harness."""
    ref_l, got_l = jax.tree.leaves(ref_tree), jax.tree.leaves(got_tree)
    assert len(ref_l) == len(got_l)
    return max(float(np.abs(npf(g) - npf(r)).max() / (np.abs(npf(r)).max() + 1e-6))
               for r, g in zip(ref_l, got_l))


def assert_bit_equal(a_tree, b_tree):
    a_l, b_l = jax.tree.leaves(a_tree), jax.tree.leaves(b_tree)
    assert len(a_l) == len(b_l)
    for a, b in zip(a_l, b_l):
        assert npf(a).tobytes() == npf(b).tobytes()


@functools.cache
def setup():
    j_cfg = dataclasses.replace(j_smoke_config(j_get_config(ARCH)), n_layers=L)
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)), n_layers=L)
    j_params = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), j_cfg,
                                                       dtype=jnp.float32))
    oracle = jax.jit(jax.value_and_grad(lambda p, bt: JT.loss_fn(
        p, bt, j_cfg, remat=False, xent_chunk=8, kv_chunk=8)))
    params = dispatch.pad_pool(params_from_jax(j_params, device="cpu"), cfg, N)
    return cfg, j_params, oracle, params, plan.plan_from_config(cfg, N)


def batch_np(cfg, rounds, seed):
    rng = np.random.default_rng(seed)
    g = rounds * B_ROUND
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (g, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (g, S)).astype(np.int32)}
    batch["labels"][::3, :2] = -100
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def forced_chunks(p):
    biggest = max(int(c.upload_stream_bytes) for c in p.layer_costs[:p.n_layers])
    program = p.prefetch_program(chunk_limit=max(1, biggest // 3))
    n_chunks = sum(1 for table in program.uploads for cu in table if cu.row >= 0)
    assert n_chunks > p.n_layers, "row chunk splitting did not engage"
    return program


@pytest.mark.parametrize("rounds", [1, 2, 3])
def test_multiround_matches_full_batch(rounds):
    cfg, j_params, oracle, params, p = setup()
    batch = batch_np(cfg, rounds, seed=rounds)
    want_loss, want_grads = oracle(j_params, batch)
    fn = dispatch.build_roundpipe_grads_fn(cfg, N, p, xent_chunk=8, kv_chunk=8,
                                           n_microbatches=rounds * N)
    grads, loss, tokens = fn(params, torch_batch(batch))
    assert int(tokens) == int((batch["labels"] != -100).sum())
    assert len(grads["layers"]) == L
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert worst_rel(want_grads, params_to_numpy(grads)) < 5e-3
    if rounds == 1:
        one = dispatch.build_roundpipe_grads_fn(cfg, N, p, xent_chunk=8,
                                                kv_chunk=8)(params, torch_batch(batch))
        assert_bit_equal(one, (grads, loss, tokens))


@pytest.mark.parametrize("rounds", [None, 2])
def test_dense_prefetch_bit_identical_to_whole_block(rounds):
    cfg, _, _, params, p = setup()
    batch = torch_batch(batch_np(cfg, rounds or 1, seed=11))
    m = None if rounds is None else rounds * N
    kw = dict(xent_chunk=8, kv_chunk=8, n_microbatches=m)
    whole = dispatch.build_roundpipe_grads_fn(cfg, N, p, **kw)(params, batch)
    chunked = dispatch.build_roundpipe_grads_fn(cfg, N, p, prefetch_program=forced_chunks(p),
                                                **kw)(params, batch)
    assert_bit_equal(whole, chunked)


def test_round_major_train_step_bit_identical_to_flat():
    cfg, _, _, _, p = setup()
    step_cfg = StepConfig(strategy="roundpipe", kv_chunk=8, xent_chunk=8, partition=p,
                          n_microbatches=2 * N, pool_dtype="int8", grad_compress="int8",
                          opt=OptConfig(lr=1e-3))
    flat = SyntheticLMDataset(DataConfig(cfg.vocab_size, S, 2 * B_ROUND))
    major = SyntheticLMDataset(DataConfig(cfg.vocab_size, S, 2 * B_ROUND, rounds=2))
    runs = []
    for data, round_major in ((flat, False), (major, True)):
        step, _ = dispatch.build_roundpipe_train_step(cfg, N, step_cfg, 2 * B_ROUND, S, plan=p,
                                                      round_major=round_major)
        state = dispatch.init_roundpipe_state(torch.Generator().manual_seed(0), cfg, step_cfg,
                                              n_workers=N, dtype=torch.float32, device="cpu")
        losses = []
        for s in range(2):
            state, metrics = step(state, torch_batch(data.batch(s)))
            losses.append(metrics["loss"])
        runs.append((losses, state))
    assert_bit_equal(runs[0], runs[1])
    assert all(np.isfinite(npf(x)) for x in runs[0][0])


@pytest.mark.parametrize("pool_dtype", ["int8", "int4"])
def test_launcher_trains_the_quantized_multiround_ring_on_cpu(pool_dtype, capsys):
    args = train.build_parser().parse_args(
        ["--arch", ARCH, "--smoke", "--strategy", "roundpipe", "--mesh", "1x4", "--steps", "2",
         "--batch", "8", "--seq", "16", "--microbatches", "8", "--pool-dtype", pool_dtype,
         "--grad-compress", "int8", "--log-every", "1", "--device", "cpu"])
    out = train.run_training(args)
    lines = capsys.readouterr().out.splitlines()
    assert lines[1].startswith("simulated bubble ratio (2 rounds, M=8): ")
    assert lines[2].startswith(f"quantized pool ({pool_dtype}): upload ")
    assert "x of the dense" in lines[2]
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "grad_residual" in out["state"]["opt"]
