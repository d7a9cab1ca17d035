"""The port's frozen-base LoRA mode against the JAX reference, on the CPU.

Sizes are the reference ring harness's (``tests/roundpipe_subprocess.py``
``run_lora``): the smoke qwen3-1.7b config at 7 layers on the LoRA auto plan
(8 on the uniform plan), b=8, s=16 a round, xent and kv chunks of 8, N=4 ring
workers, rank 4, alpha 8. Base weights come from the reference's
``init_params`` through ``convert.params_from_jax``; adapters, with B away
from its zero init, and batches from numpy seeds. On the CPU the kernel
entries run their plain versions. Bars:

* the adapter math (targets, parameter counts, dead targets, merge/unmerge,
  the zero-B no-op) and ``convert``: exact against ``repro.models.lora``;
* the plan's split byte accounting: equal to the reference's;
* the frozen ring at R = 1 and 2 against the reference's merged-dense
  single-program oracle (``jax.value_and_grad`` of ``loss_fn(merge_params)``
  with respect to the adapters): loss rtol 1e-4, adapter grads worst
  relative error (max |got - ref| / max |ref| per leaf) < 5e-3, every
  reference leaf non-zero; also on the uniform 8-layer plan on which the
  reference's own ring runs;
* prefetch on: bit-identical to whole-block injection;
* the int4 base with int8 error-feedback deposits: the oracle at the
  dequantized base, 1e-4 / 5e-3 for the exact deposits, and
  ``tests/test_torch_quant.py``'s error-feedback bars for the compressed
  ones (the loss bit-identical, one shot within 8e-3, the mean over 4
  steps below half of that, a non-zero residual);
* the launcher with ``--lora-rank``: finite losses, the base bit-identical,
  every adapter B moved.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core import dispatch as j_dispatch
from repro.core import plan as j_plan
from repro.core import simulator as j_simulator
from repro.kernels import dequant as j_dequant
from repro.kernels import ops as j_ops
from repro.launch.steps import StepConfig as JStepConfig
from repro.models import lora as j_lora
from repro.models import transformer as JT
from repro.models.config import get_config as j_get_config
from repro_torch.configs import smoke_config
from repro_torch.core import dispatch, partition, plan, simulator
from repro_torch.kernels.fused_xent import FusedXent, xent_backward
from repro_torch.kernels import ref
from repro_torch.launch import train
from repro_torch.launch.steps import StepConfig
from repro_torch.models import lora
from repro_torch.models import transformer as T
from repro_torch.models.config import get_config
from repro_torch.models.convert import (params_from_jax, params_to_numpy, state_from_jax,
                                        state_to_numpy)
from repro_torch.optim.adam import tree_leaves, tree_map


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
N, B, S, L = 4, 8, 16, 7
J_LCFG, LCFG = j_lora.LoraConfig(rank=4, alpha=8.0), lora.LoraConfig(rank=4, alpha=8.0)


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


def configs(n_layers=L):
    j_cfg = dataclasses.replace(j_smoke_config(j_get_config(ARCH)), n_layers=n_layers)
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)), n_layers=n_layers)
    return j_cfg, cfg


@functools.cache
def base_params(n_layers):
    """The reference's fp32 weights at ``n_layers`` (shared: never mutated)."""
    j_cfg, _ = configs(n_layers)
    init = jax.jit(lambda k: JT.init_params(k, j_cfg, dtype=jnp.float32))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


def random_adapters(j_params, seed):
    """The reference's adapter tree for ``j_params`` with every leaf drawn
    from a numpy seed (B away from zero, so A's grads are not empty)."""
    shape = jax.eval_shape(lambda: j_lora.init_adapters(
        jax.random.PRNGKey(3), j_params["layers"], J_LCFG, dtype=jnp.float32))
    rng = np.random.default_rng(seed)
    return jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
                        shape)


def batch_np(cfg, rounds, seed):
    rng = np.random.default_rng(seed)
    g = rounds * B
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (g, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (g, S)).astype(np.int32)}
    batch["labels"][::3, :2] = -100
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def lora_params(j_params, j_adapters, cfg):
    """The port's params with the adapters, padded to the pool's rows."""
    return dispatch.pad_pool(params_from_jax(dict(j_params, lora=j_adapters), device="cpu"),
                             cfg, N)


@functools.cache
def _oracle_fn(n_layers):
    j_cfg, _ = configs(n_layers)
    return jax.jit(jax.value_and_grad(lambda ad, p, bt: JT.loss_fn(
        j_lora.merge_params(p, ad, J_LCFG), bt, j_cfg, remat=False, xent_chunk=8, kv_chunk=8)))


def oracle(j_params, j_adapters, batch, n_layers=L):
    """The reference's merged-dense single program, differentiated with
    respect to the adapters only."""
    return _oracle_fn(n_layers)(j_adapters, j_params, batch)


@functools.cache
def setup():
    j_cfg, cfg = configs()
    j_params = base_params(L)
    j_adapters = random_adapters(j_params, seed=11)
    return j_cfg, cfg, j_params, j_adapters, lora_params(j_params, j_adapters, cfg)


def lora_plan(cfg, pool_dtype="none"):
    return plan.plan_from_config(cfg, N, lora=LCFG, pool_dtype=pool_dtype)


def check_against(want, grads, loss, tokens=None, labels=None):
    want_loss, want_grads = want
    assert set(grads) == {"lora"}
    got = params_to_numpy(grads)["lora"]
    assert jax.tree.structure(got) == jax.tree.structure(want_grads)
    for leaf in jax.tree.leaves(want_grads):
        assert np.abs(np.asarray(leaf)).max() > 0, "degenerate zero reference grad"
    if tokens is not None:
        assert int(tokens) == int((labels != -100).sum())
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert worst_rel(want_grads, got) < 5e-3


# ---------------------------------------------------------------------------
# (a) the adapter math
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("targets", [("attn", "mlp"), ("attn",), ("mlp.w_up", "attn.w_q"),
                                     ("attn.w_o",)])
def test_targets_and_counts_match_reference(targets):
    j_cfg, cfg = configs(2)
    j_l, l_ = j_lora.LoraConfig(rank=3, target_modules=targets), \
        lora.LoraConfig(rank=3, target_modules=targets)
    j_layers = JT.abstract_params(j_cfg)["layers"]
    layers = T.init_layer(None, cfg, device="meta")
    assert lora.target_leaf_paths(layers, l_) == j_lora.target_leaf_paths(j_layers, j_l)
    assert lora.target_leaf_paths([layers, layers], l_) == lora.target_leaf_paths(layers, l_)
    assert lora.adapter_params_per_layer(cfg, l_) == j_lora.adapter_params_per_layer(j_cfg, j_l)
    assert lora.applicable_targets(cfg, targets) == j_lora.applicable_targets(j_cfg, targets)
    assert l_.scale == j_l.scale


@pytest.mark.parametrize("targets", [("nope",), ("attn", "norm1"), ("attn.w_x",)])
def test_dead_targets_raise_as_reference(targets):
    j_cfg, cfg = configs(2)
    with pytest.raises(ValueError, match="match no"):
        j_lora.target_leaf_paths(JT.abstract_params(j_cfg)["layers"],
                                 j_lora.LoraConfig(target_modules=targets))
    with pytest.raises(ValueError, match="match no"):
        lora.target_leaf_paths(T.init_layer(None, cfg, device="meta"),
                               lora.LoraConfig(target_modules=targets))
    with pytest.raises(ValueError, match="none of"):
        lora.applicable_targets(cfg, ("nope",))
    with pytest.raises(ValueError, match="rank"):
        lora.LoraConfig(rank=0)


def test_init_adapters_shapes_and_zero_b():
    _, cfg = configs(2)
    gen = torch.Generator().manual_seed(0)
    params = T.init_params(cfg, gen, dtype=torch.bfloat16, device="cpu")
    ad = lora.init_adapters(gen, params["layers"], LCFG)
    j_cfg, _ = configs(2)
    j_ad = j_lora.adapter_abstract(j_cfg, J_LCFG)
    assert len(ad) == 2
    got_shapes = jax.tree.map(lambda *xs: (len(xs),) + tuple(xs[0].shape), *ad)
    assert jax.tree.leaves(got_shapes) == jax.tree.leaves(jax.tree.map(
        lambda a: tuple(a.shape), j_ad))
    for layer in ad:
        for path in lora.target_leaf_paths(params["layers"], LCFG):
            pair = lora.at_path(layer, path)
            assert pair["A"].dtype == torch.bfloat16 and not pair["B"].any()
            assert pair["A"].float().std() > 0
    # a fresh adapter is a bit-exact no-op
    merged = lora.merge_params(dict(params, lora=ad), ad, LCFG)
    assert "lora" not in merged
    for a, b in zip(tree_leaves(merged), tree_leaves(params)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_merge_and_unmerge_match_reference(dtype):
    """The B@A product sums in another order than XLA's: within one rounding
    of the summands in the merged leaf's dtype (fp32 2**-22 relative and
    1e-7 absolute, the rounding of weights of ~0.5; bf16 2**-8); a zero B
    merges bit-exactly."""
    jd, td = getattr(jnp, dtype), getattr(torch, dtype)
    j_params = jax.tree.map(lambda a: jnp.asarray(a).astype(jd), base_params(2))
    j_ad = jax.tree.map(lambda a: jnp.asarray(a).astype(jd),
                        random_adapters(jax.tree.map(np.asarray, j_params), seed=2))
    params = params_from_jax(jax.tree.map(np.asarray, dict(j_params, lora=j_ad)), dtype=td,
                             device="cpu")
    tol = dict(rtol=2 ** -22, atol=1e-7) if dtype == "float32" else dict(rtol=2 ** -8,
                                                                          atol=1e-6)

    def close(want, got):
        w_l, g_l = jax.tree.leaves(want), jax.tree.leaves(got)
        assert len(w_l) == len(g_l)
        for a, b in zip(w_l, g_l):
            np.testing.assert_allclose(b, np.asarray(a, np.float32), **tol)

    merged = lora.merge_params(params, params["lora"], LCFG)
    j_merge = jax.jit(lambda p, a: j_lora.merge_params(p, a, J_LCFG))
    j_merged = j_merge(j_params, j_ad)
    close(j_merged, params_to_numpy(merged))
    back = lora.unmerge_params(dict(merged, lora=params["lora"]), params["lora"], LCFG)
    close(jax.jit(lambda p, a: j_lora.unmerge_params(p, a, J_LCFG))(j_merged, j_ad),
          params_to_numpy(back))
    if dtype == "float32":      # the round trip, up to the delta's rounding
        for a, b in zip(tree_leaves(back["layers"]), tree_leaves(params["layers"])):
            torch.testing.assert_close(a, b, rtol=0, atol=1e-6)
    # zero B: bit-exact no-op, against the reference's
    zero = tree_map(torch.zeros_like, params["lora"])
    same = lora.merge_params(params, zero, LCFG)
    assert_bit_equal(j_merge(j_params, jax.tree.map(jnp.zeros_like, j_ad)),
                     params_to_numpy(same))
    for a, b in zip(tree_leaves(same["layers"]), tree_leaves(params["layers"])):
        assert torch.equal(a, b)


def test_masks_match_reference():
    j_params = base_params(2)
    j_ad = random_adapters(j_params, seed=3)
    params = params_from_jax(dict(j_params, lora=j_ad), device="cpu")
    mask = lora.param_mask(params)
    j_mask = j_lora.param_mask(dict(j_params, lora=j_ad))
    assert mask["lora"] is True and mask["layers"] is False
    assert mask["embed"] is j_mask["embed"] is False
    assert mask["final_norm"] == j_mask["final_norm"]
    assert all(jax.tree.leaves(j_mask["lora"])) and not any(jax.tree.leaves(j_mask["layers"]))
    from repro_torch.optim.adam import merge_trainable, trainable_leaves
    tr = trainable_leaves(params, mask)
    assert set(tr) == {"lora"} and tr["lora"] is params["lora"]
    back = merge_trainable(params, {"lora": [dict(x) for x in tr["lora"]]}, mask)
    assert back["layers"] is params["layers"] and back["embed"] is params["embed"]
    om = lora.opt_mask(params["lora"])
    assert jax.tree.leaves(om) == [True] * len(tree_leaves(params["lora"]))


# ---------------------------------------------------------------------------
# (b) convert, (c) the plan
# ---------------------------------------------------------------------------

def test_adapters_convert_both_ways_leaf_for_leaf():
    j_cfg, cfg = configs(3)
    j_params = base_params(3)
    j_ad = random_adapters(j_params, seed=4)
    params = params_from_jax(dict(j_params, lora=j_ad), device="cpu")
    assert len(params["lora"]) == 3
    assert params["lora"][1]["attn"]["w_q"]["A"].shape == (4, cfg.q_dim)
    np.testing.assert_array_equal(npf(params["lora"][2]["mlp"]["w_down"]["B"]),
                                  j_ad["mlp"]["w_down"]["B"][2])
    back = params_to_numpy(params)
    assert jax.tree.structure(back) == jax.tree.structure(dict(j_params, lora=j_ad))
    assert_bit_equal(dict(j_params, lora=j_ad), back)
    # a LoRA train state: adapter-only optimizer trees and an adapter
    # residual, laid out as the reference's own init_roundpipe_state lays it
    j_step = JStepConfig(strategy="roundpipe", lora=J_LCFG, grad_compress="int8")
    j_shape = jax.eval_shape(lambda: j_dispatch.init_roundpipe_state(
        jax.random.PRNGKey(1), j_cfg, j_step, n_workers=N))
    state = dispatch.init_roundpipe_state(
        torch.Generator().manual_seed(1), cfg,
        StepConfig(strategy="roundpipe", lora=LCFG, grad_compress="int8"), n_workers=N,
        device="cpu")
    assert set(state["opt"]["master"]) == set(state["opt"]["m"]) == {"lora"}
    assert len(state["params"]["lora"]) == 4 and len(state["opt"]["grad_residual"]) == 4
    as_ref = state_to_numpy(state)
    flat_ref, tree_ref = jax.tree.flatten(j_shape)
    flat_got, tree_got = jax.tree.flatten(as_ref)
    assert tree_ref == tree_got
    assert [tuple(a.shape) for a in flat_ref] == [a.shape for a in flat_got]
    again = state_from_jax(as_ref, device="cpu")
    assert len(again["opt"]["grad_residual"]) == 4
    assert_bit_equal(as_ref, state_to_numpy(again))


@pytest.mark.parametrize("n_layers,pool_dtype", [(7, "none"), (8, "none"), (7, "int4")])
def test_lora_plan_matches_reference(n_layers, pool_dtype):
    j_cfg, cfg = configs(n_layers)
    got = plan.plan_from_config(cfg, N, lora=LCFG, pool_dtype=pool_dtype)
    want = j_plan.plan_from_config(j_cfg, N, lora=J_LCFG, pool_dtype=pool_dtype)
    assert got.describe() == want.describe()
    assert got.stage_bytes == want.stage_bytes
    assert got.stage_download_bytes == want.stage_download_bytes
    assert [c.trainable_bytes for c in got.layer_costs] == \
        [c.trainable_bytes for c in want.layer_costs]
    assert got.layer_costs[-1].trainable_bytes == 0
    assert (simulator.simulate_plan(got, N, round_size=N).bubble_ratio
            == j_simulator.simulate_plan(want, N, round_size=N).bubble_ratio)
    # uploads stay dense (or quantized), downloads shrink to the adapters
    full = plan.plan_from_config(cfg, N, partition=got.partition, pool_dtype=pool_dtype)
    assert got.stage_bytes == full.stage_bytes
    assert 0 < sum(got.stage_download_bytes) < sum(full.stage_download_bytes)
    costs = plan.default_layer_costs(cfg, lora=LCFG)
    assert costs[0].trainable_bytes == 2 * lora.adapter_params_per_layer(cfg, LCFG)
    rep = plan.replan_for_survivors(cfg, 3, n_microbatches=8, lora=LCFG)
    j_rep = j_plan.replan_for_survivors(j_cfg, 3, n_microbatches=8, lora=J_LCFG)
    assert rep.plan.stage_download_bytes == j_rep.plan.stage_download_bytes
    assert (rep.n_microbatches, rep.rounds) == (j_rep.n_microbatches, j_rep.rounds)


# ---------------------------------------------------------------------------
# (d) the frozen ring, (e) prefetch
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rounds", [1, 2])
def test_frozen_ring_matches_merged_dense_oracle(rounds):
    _, cfg, j_params, j_ad, params = setup()
    batch = batch_np(cfg, rounds, seed=20 + rounds)
    fn = dispatch.build_roundpipe_grads_fn(cfg, N, lora_plan(cfg), xent_chunk=8, kv_chunk=8,
                                           lora=LCFG, n_microbatches=N * rounds)
    grads, loss, tokens = fn(params, torch_batch(batch))
    assert len(grads["lora"]) == L
    check_against(oracle(j_params, j_ad, batch), grads, loss, tokens, batch["labels"])
    # the same ring on the unpadded pools
    unpadded = dict(params, layers=params["layers"][:L], lora=params["lora"][:L])
    grads2, loss2, _ = fn(unpadded, torch_batch(batch))
    assert_bit_equal((grads, loss), (grads2, loss2))


def _forced_chunks(p):
    biggest = max(int(c.upload_stream_bytes) for c in p.layer_costs[:p.n_layers])
    program = p.prefetch_program(chunk_limit=max(1, biggest // 3))
    assert sum(1 for t in program.uploads for cu in t if cu.row >= 0) > p.n_layers
    return program


@pytest.mark.parametrize("rounds", [1, 2])
def test_frozen_prefetch_bit_identical_to_whole_block(rounds):
    _, cfg, _, _, params = setup()
    batch = torch_batch(batch_np(cfg, rounds, seed=30 + rounds))
    p = lora_plan(cfg)
    kw = dict(xent_chunk=8, kv_chunk=8, lora=LCFG, n_microbatches=N * rounds)
    whole = dispatch.build_roundpipe_grads_fn(cfg, N, p, **kw)(params, batch)
    chunked = dispatch.build_roundpipe_grads_fn(cfg, N, p, prefetch_program=_forced_chunks(p),
                                                **kw)(params, batch)
    assert_bit_equal(whole[:2], chunked[:2])


def test_frozen_ring_on_the_uniform_8_layer_plan():
    """One layer a slot over 8 layers (15 slots on 4 workers, no padding
    rows): the plan on which the reference's own frozen ring runs on this
    JAX (``n_layers % N == 0``)."""
    j_cfg, cfg = configs(8)
    j_params = base_params(8)
    j_ad = random_adapters(j_params, seed=12)
    batch = batch_np(cfg, 1, seed=40)
    p = plan.compile_plan(plan.uniform_partition(8),
                          [partition.LayerCost(1.0, 2.0) for _ in range(8)],
                          n_workers=N, n_body_layers=8)
    fn = dispatch.build_roundpipe_grads_fn(cfg, N, p, xent_chunk=8, kv_chunk=8, lora=LCFG)
    grads, loss, tokens = fn(lora_params(j_params, j_ad, cfg), torch_batch(batch))
    check_against(oracle(j_params, j_ad, batch, n_layers=8), grads, loss, tokens,
                  batch["labels"])


# ---------------------------------------------------------------------------
# (f) the int4 base with int8 EF deposits on the adapter pool
# ---------------------------------------------------------------------------

def _dequantized_layers(layers_tree, bits):
    """The reference ring's quantize -> ship -> dequant round trip of the
    stacked base pool, host-side (``tests/roundpipe_subprocess.py``)."""
    leaves, tdef = jax.tree_util.tree_flatten(layers_tree)
    rows = leaves[0].shape[0]
    cat = jnp.concatenate([jnp.asarray(x).reshape(rows, -1).astype(jnp.float32)
                           for x in leaves], axis=1)
    codes, scales = j_dequant.quantize_rows(cat, bits=bits)
    flat = j_ops.dequant_rows(codes, scales)[:, :cat.shape[1]]
    out, off = [], 0
    for x in leaves:
        ne = int(np.prod(x.shape[1:]))
        out.append(np.asarray(flat[:, off:off + ne].reshape(x.shape), np.float32))
        off += ne
    return jax.tree_util.tree_unflatten(tdef, out)


def test_int4_base_with_ef_deposits_matches_dequantized_oracle():
    _, cfg, j_params, j_ad, params = setup()
    batch = batch_np(cfg, 2, seed=50)
    want = oracle(dict(j_params, layers=_dequantized_layers(j_params["layers"], 4)), j_ad,
                  batch)
    p = lora_plan(cfg, "int4")
    kw = dict(xent_chunk=8, kv_chunk=8, lora=LCFG, n_microbatches=2 * N, pool_dtype="int4",
              prefetch_program=_forced_chunks(p))
    ex_g, ex_loss, tokens = dispatch.build_roundpipe_grads_fn(cfg, N, p, **kw)(
        params, torch_batch(batch))
    check_against(want, ex_g, ex_loss, tokens, batch["labels"])
    cfn = dispatch.build_roundpipe_grads_fn(cfg, N, p, grad_compress="int8", **kw)
    residual = [tree_map(lambda a: torch.zeros(a.shape), row) for row in params["lora"]]
    k_steps, sums = 4, None
    for k in range(k_steps):
        c_g, c_loss, _, residual = cfn(params, torch_batch(batch), residual)
        assert set(c_g) == {"lora"}
        if k == 0:
            first_err = worst_rel(ex_g["lora"], c_g["lora"])
        sums = c_g["lora"] if sums is None else tree_map(torch.add, sums, c_g["lora"])
    mean_err = worst_rel(ex_g["lora"], tree_map(lambda a: a / k_steps, sums))
    assert npf(c_loss).tobytes() == npf(ex_loss).tobytes()
    assert first_err < 8e-3
    assert mean_err < first_err / 2, (mean_err, first_err)
    assert sum(float(x.abs().sum()) for x in tree_leaves(residual)) > 0.0
    # the padding rows of the adapter residual take no deposit
    assert not any(x.any() for x in tree_leaves(residual[L:]))


# ---------------------------------------------------------------------------
# the train step, the state, and (g) the launcher
# ---------------------------------------------------------------------------

def test_train_step_updates_adapters_only():
    _, cfg, _, _, params = setup()
    step_cfg = StepConfig(strategy="roundpipe", kv_chunk=8, xent_chunk=8, lora=LCFG,
                          grad_compress="int8")
    state = dispatch.init_roundpipe_state(torch.Generator().manual_seed(0), cfg, step_cfg,
                                          n_workers=N, dtype=torch.float32, device="cpu")
    assert len(state["params"]["lora"]) == 8 and set(state["opt"]["master"]) == {"lora"}
    assert all(not x.any() for x in tree_leaves(state["opt"]["grad_residual"]))
    paths = lora.target_leaf_paths(state["params"]["layers"], LCFG)
    assert all(not lora.at_path(layer, path)["B"].any() for layer in state["params"]["lora"]
               for path in paths)
    # start from the shared adapters, B away from zero
    state["params"] = dict(state["params"], lora=params["lora"])
    state["opt"] = dict(state["opt"], master={"lora": tree_map(torch.clone, params["lora"])})
    step, _ = dispatch.build_roundpipe_train_step(cfg, N, step_cfg, B, S, plan=lora_plan(cfg))
    base = {k: v for k, v in state["params"].items() if k != "lora"}
    before = tree_map(torch.clone, base)
    new, metrics = step(state, torch_batch(batch_np(cfg, 1, seed=60)))
    assert np.isfinite(float(metrics["loss"]))
    kept = {k: new["params"][k] for k in base}
    assert all(a is b for a, b in zip(tree_leaves(kept), tree_leaves(base)))  # untouched
    assert_bit_equal(before, kept)
    moved = [not torch.equal(a, b) for a, b in zip(tree_leaves(new["params"]["lora"][:L]),
                                                   tree_leaves(params["lora"][:L]))]
    assert all(moved)
    assert all(not x.any() for x in tree_leaves(new["params"]["lora"][L:]))


def test_launcher_trains_lora_on_cpu(capsys):
    out = train.main(["--arch", ARCH, "--smoke", "--strategy", "roundpipe", "--mesh", "1x4",
                      "--steps", "2", "--batch", str(B), "--seq", str(S), "--lora-rank", "4",
                      "--log-every", "1", "--device", "cpu"])
    text = capsys.readouterr().out
    assert "LoRA r=4: " in text and "trainable parameters" in text
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    _, cfg = configs(2)
    init = dispatch.init_roundpipe_state(
        torch.Generator().manual_seed(0), cfg,
        StepConfig(strategy="roundpipe", lora=lora.LoraConfig(rank=4)), n_workers=N,
        device="cpu")
    got = out["state"]["params"]
    for key in ("layers", "embed", "final_norm"):
        assert_bit_equal(init["params"][key], got[key])
    for a, b in zip(init["params"]["lora"][:2], got["lora"][:2]):
        for path in lora.target_leaf_paths(got["layers"], lora.LoraConfig(rank=4)):
            assert not torch.equal(lora.at_path(a, path)["B"], lora.at_path(b, path)["B"])


def test_launcher_trains_int4_lora_on_cpu(capsys):
    out = train.main(["--arch", ARCH, "--smoke", "--strategy", "roundpipe", "--mesh", "1x4",
                      "--steps", "2", "--batch", str(B), "--seq", str(S), "--lora-rank", "4",
                      "--microbatches", "8", "--pool-dtype", "int4", "--grad-compress", "int8",
                      "--device", "cpu"])
    assert "quantized pool (int4)" in capsys.readouterr().out
    assert all(np.isfinite(out["losses"]))
    assert len(out["state"]["opt"]["grad_residual"]) == 4


# ---------------------------------------------------------------------------
# the cross-entropy backward under a frozen head
# ---------------------------------------------------------------------------

def test_xent_backward_skips_dw_with_dx_bit_identical():
    rng = np.random.default_rng(70)
    x = torch.from_numpy(rng.standard_normal((37, 24)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((24, 300)) * 0.1).astype(np.float32))
    labels = torch.from_numpy(rng.integers(0, 300, 37))
    labels[::4] = -100
    g = torch.from_numpy(rng.standard_normal(37).astype(np.float32))
    _, lse = ref.fused_xent_ref(x, w, labels, return_lse=True)
    for block_v in (64, 300):
        dx, dw = xent_backward(x, w, labels, lse, g, block_v=block_v)
        dx_only, none = xent_backward(x, w, labels, lse, g, block_v=block_v, want_dw=False)
        assert none is None and dw is not None
        assert torch.equal(dx, dx_only)
    # through autograd: a head that needs no gradient takes the dx-only path
    fwd = functools.partial(ref.fused_xent_ref, return_lse=True)
    xl = x.clone().requires_grad_()
    (gx,) = torch.autograd.grad((FusedXent.apply(xl, w, labels, -100, fwd) * g).sum(), (xl,))
    xl2, wl = x.clone().requires_grad_(), w.clone().requires_grad_()
    gx2, gw2 = torch.autograd.grad((FusedXent.apply(xl2, wl, labels, -100, fwd) * g).sum(),
                                   (xl2, wl))
    assert torch.equal(gx, gx2) and torch.equal(gx, dx)
    assert torch.equal(gw2, dw)
