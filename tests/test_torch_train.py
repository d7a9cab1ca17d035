"""The port's training slice against the JAX reference, on the CPU.

Sizes are the reference ring harness's: the smoke qwen3-1.7b config, at most
8 layers, b=8, s=16, xent and kv chunks of 8, N=4 ring workers. Weights come
from the reference's ``init_params`` through ``convert.params_from_jax``;
other inputs from numpy seeds. On the CPU the port's kernel entries run
their plain versions. Bars:

* xent entry against the Pallas ``fused_xent`` (interpret mode): the
  reference's own ``tests/test_kernels.py`` bars, fp32 1e-4, bf16 3e-2;
* ``chunked_softmax_xent`` and the plain flash backward against jnp/``jax.grad``
  of the reference: 1e-5 (fp32, sums in other orders);
* loss and grads (single program and ring): loss rtol 1e-4, grads worst
  relative error (max |got - ref| / max |ref| per leaf) < 5e-3, the bar of
  ``tests/roundpipe_subprocess.py:199``;
* optimizer states after 1 and 5 steps: fp32 rtol 1e-5 / atol 1e-6 (the
  global norm sums leaves in another order), bf16 leaves within one bf16
  rounding (rtol 2**-7);
* the launcher against a loop of reference oracle grads and
  ``repro.optim.apply_updates``: losses rtol 1e-4 with fp32 weights, 2e-3
  with its default bf16 weights (the test says why);
* the roundpipe train state round trip: bit-exact.
"""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core import dispatch as j_dispatch
from repro.data import DataConfig as JDataConfig
from repro.data import SyntheticLMDataset as JDataset
from repro.kernels import ops as j_ops
from repro.launch.steps import StepConfig as JStepConfig
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import get_config as j_get_config
from repro.optim import OptConfig as JOptConfig
from repro.optim import apply_updates as j_apply_updates
from repro.optim import init_opt_state as j_init_opt_state
from repro_torch.configs import smoke_config
from repro_torch.core import dispatch, partition, plan
from repro_torch.kernels import ops, ref
from repro_torch.launch import train
from repro_torch.models import transformer as T
from repro_torch.models.config import get_config
from repro_torch.models.convert import (params_from_jax, params_to_numpy, state_from_jax,
                                        state_to_numpy)
from repro_torch.optim import OptConfig, apply_updates, init_opt_state
from repro_torch.optim.adam import tree_leaves, tree_map

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-1.7b"
N, B, S = 4, 8, 16


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def t(a, dtype=torch.float32):
    return torch.from_numpy(np.array(a, np.float32)).to(dtype)


def npf(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def worst_rel(ref_tree, got_tree):
    """max over leaves of |got - ref|_inf / (|ref|_inf + 1e-6), as the harness."""
    ref_l = jax.tree.leaves(ref_tree)
    got_l = jax.tree.leaves(got_tree)
    assert len(ref_l) == len(got_l)
    return max(float(np.abs(npf(g) - npf(r)).max() / (np.abs(npf(r)).max() + 1e-6))
               for r, g in zip(ref_l, got_l))


def configs(n_layers):
    j_cfg = dataclasses.replace(j_smoke_config(j_get_config(ARCH)), n_layers=n_layers)
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)), n_layers=n_layers)
    return j_cfg, cfg


def batch_np(cfg, seed=0):
    rng = np.random.default_rng(seed)
    tokens = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels = rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)
    labels[:, :2] = -100
    return {"tokens": tokens, "labels": labels}


def oracle(j_cfg, j_params, batch):
    """The reference's single-program loss and grads (no pipeline)."""
    def loss(p):
        return JT.loss_fn(p, batch, j_cfg, remat=False, xent_chunk=8, kv_chunk=8)
    return jax.value_and_grad(loss)(j_params)


# ---------------------------------------------------------------------------
# kernels' plain versions
# ---------------------------------------------------------------------------

XENT_SHAPES = [(128, 32, 512, 64, 128), (256, 16, 1024, 256, 256), (64, 64, 256, 32, 64)]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("tt,d,v,bt,bv", XENT_SHAPES)
def test_xent_entry_matches_pallas(dtype, tt, d, v, bt, bv):
    x, w = rand(1, tt, d), rand(2, d, v) * 0.1
    labels = np.random.default_rng(3).integers(0, v, tt).astype(np.int32)
    jd = jnp.float32 if dtype == "float32" else jnp.bfloat16
    td = getattr(torch, dtype)
    tol = 1e-4 if dtype == "float32" else 3e-2
    xj, wj = jnp.asarray(x).astype(jd), jnp.asarray(w).astype(jd)
    xt = t(np.asarray(xj.astype(jnp.float32)), td).requires_grad_()
    wt = t(np.asarray(wj.astype(jnp.float32)), td).requires_grad_()
    lab = torch.from_numpy(labels).long()
    got = ops.fused_xent(xt, wt, lab)
    want = j_ops.fused_xent(xj, wj, jnp.asarray(labels), use_pallas=True, interpret=True,
                            block_t=bt, block_v=bv)
    np.testing.assert_allclose(npf(got), np.asarray(want, np.float32), rtol=tol, atol=tol)
    if dtype == "float32":
        gx, gw = torch.autograd.grad(got.sum(), (xt, wt))
        rx, rw = jax.grad(lambda a, b: j_ops.fused_xent(
            a, b, jnp.asarray(labels), use_pallas=True, interpret=True, block_t=bt,
            block_v=bv).sum(), argnums=(0, 1))(xj, wj)
        np.testing.assert_allclose(npf(gx), np.asarray(rx), rtol=tol, atol=tol)
        np.testing.assert_allclose(npf(gw), np.asarray(rw), rtol=tol, atol=tol)


def test_xent_streamed_backward_blocks_match_one_block():
    x, w = t(rand(4, 37, 24)).requires_grad_(), t(rand(5, 24, 300) * 0.1).requires_grad_()
    labels = torch.from_numpy(np.random.default_rng(6).integers(0, 300, 37))
    labels[::3] = -100
    loss, lse = ref.fused_xent_ref(x, w, labels, return_lse=True)
    g = t(rand(7, 37))
    from repro_torch.kernels.fused_xent import xent_backward
    one = xent_backward(x.detach(), w.detach(), labels, lse.detach(), g, block_v=300)
    many = xent_backward(x.detach(), w.detach(), labels, lse.detach(), g, block_v=64)
    want = torch.autograd.grad(loss, (x, w), g)
    for a, b, c in zip(one, many, want):
        torch.testing.assert_close(a, c, rtol=1e-5, atol=1e-6)
        torch.testing.assert_close(b, c, rtol=1e-5, atol=1e-6)
    assert float(loss.detach()[::3].abs().max()) == 0.0


def test_chunked_softmax_xent_matches_reference():
    x, w = rand(8, 2, 19, 32), rand(9, 32, 100) * 0.2
    labels = np.random.default_rng(10).integers(0, 100, (2, 19)).astype(np.int32)
    labels[0, :5] = -100
    labels[1, -3:] = -100

    tot, cnt = JT.chunked_softmax_xent(x, w, jnp.asarray(labels), chunk=8)
    jx, jw = jax.grad(lambda a, b: JT.chunked_softmax_xent(a, b, jnp.asarray(labels),
                                                           chunk=8)[0], argnums=(0, 1))(x, w)
    xt, wt = t(x).requires_grad_(), t(w).requires_grad_()
    got_tot, got_cnt = T.chunked_softmax_xent(xt, wt, torch.from_numpy(labels), chunk=8)
    assert int(got_cnt) == int(cnt)
    np.testing.assert_allclose(float(got_tot), float(tot), rtol=1e-5)
    gx, gw = torch.autograd.grad(got_tot, (xt, wt))
    np.testing.assert_allclose(npf(gx), np.asarray(jx), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(npf(gw), np.asarray(jw), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("kh,g,dv,window,causal", [
    (2, 2, 16, None, True), (1, 4, 16, None, True), (2, 1, 16, 5, True), (2, 2, 8, None, True),
    (2, 2, 16, None, False)])
def test_flash_attention_bwd_ref_matches_jax_grad(kh, g, dv, window, causal):
    q, k, v = rand(11, 2, 19, kh * g, 16), rand(12, 2, 19, kh, 16), rand(13, 2, 19, kh, dv)
    do = rand(14, 2, 19, kh * g, dv)
    _, vjp = jax.vjp(lambda a, b, c: JL.chunked_attention(
        a, b, c, causal=causal, sliding_window=window, kv_chunk=8), q, k, v)
    want = vjp(jnp.asarray(do))
    o, lse = ref.flash_attention_ref(t(q), t(k), t(v), causal=causal, sliding_window=window,
                                     return_lse=True)
    got = ref.flash_attention_bwd_ref(t(q), t(k), t(v), o, lse, t(do), causal=causal,
                                      sliding_window=window)
    for a, b in zip(got, want):
        np.testing.assert_allclose(npf(a), np.asarray(b), rtol=1e-5, atol=1e-5)


# ---------------------------------------------------------------------------
# model loss and grads
# ---------------------------------------------------------------------------

def test_loss_and_grads_match_reference():
    j_cfg, cfg = configs(3)
    j_params = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), j_cfg,
                                                       dtype=jnp.float32))
    batch = batch_np(cfg)
    want_loss, want_grads = oracle(j_cfg, j_params, batch)
    params = params_from_jax(j_params, device="cpu")
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_()
    loss = T.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()}, cfg,
                     xent_chunk=8, kv_chunk=8)
    grads = torch.autograd.grad(loss, leaves)
    np.testing.assert_allclose(float(loss.detach()), float(want_loss), rtol=1e-4)
    assert worst_rel(want_grads, params_to_numpy(tree_map(lambda _, g: g, params,
                                                          _unflat(params, grads)))) < 5e-3


def _unflat(tree, flat):
    it = iter(flat)
    return tree_map(lambda _: next(it), tree)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

def _opt_tree(seed):
    return {"w": rand(seed, 6, 5), "layers": [{"s": rand(seed + 1, 5)}, {"s": rand(seed + 2, 5)}],
            "m": rand(seed + 3, 3, 1, 4)}


@pytest.mark.parametrize("mode", ["adamw", "adafactor"])
def test_optimizer_matches_reference(mode):
    kw = dict(mode=mode, lr=1e-2, weight_decay=0.1, grad_clip=1.0)
    params_np = _opt_tree(20)
    j_params = jax.tree.map(lambda a: jnp.asarray(a).astype(jnp.bfloat16), params_np)
    params = tree_map(lambda a: t(a, torch.bfloat16), params_np)
    j_state = j_init_opt_state(j_params, JOptConfig(**kw))
    state = init_opt_state(params, OptConfig(**kw))
    for step in range(1, 6):
        grads_np = jax.tree.map(lambda a: a * 3.0, _opt_tree(100 + step))
        j_params, j_state, _ = j_apply_updates(j_state, grads_np, JOptConfig(**kw),
                                               param_like=j_params)
        params, state, _ = apply_updates(state, tree_map(t, grads_np), OptConfig(**kw),
                                         param_like=params)
        if step in (1, 5):
            assert int(state["step"]) == int(j_state["step"]) == step
            for key in [k for k in j_state if k != "step"]:
                bf16 = key == "m" and mode == "adafactor"
                tol = dict(rtol=2 ** -7, atol=1e-6) if bf16 else dict(rtol=1e-5, atol=1e-6)
                for a, b in zip(jax.tree.leaves(state[key]), jax.tree.leaves(j_state[key])):
                    np.testing.assert_allclose(npf(a), np.asarray(b, np.float32), **tol)
            for a, b in zip(jax.tree.leaves(params), jax.tree.leaves(j_params)):
                assert a.dtype == torch.bfloat16
                np.testing.assert_allclose(npf(a), np.asarray(b, np.float32), rtol=2 ** -7,
                                           atol=1e-6)


def test_fp32_master_is_a_copy_and_host_placement_raises():
    p = {"w": torch.ones(3)}
    state = init_opt_state(p, OptConfig())
    assert state["master"]["w"].data_ptr() != p["w"].data_ptr()
    new, _, _ = apply_updates(state, {"w": torch.ones(3)}, OptConfig(), param_like=p)
    assert new["w"].data_ptr() != state["master"]["w"].data_ptr()
    with pytest.raises(NotImplementedError, match="placement"):
        init_opt_state(p, OptConfig(placement="host"))


def test_trainable_masking_matches_reference():
    from repro.optim import merge_trainable as j_merge
    from repro.optim import trainable_leaves as j_trainable
    from repro_torch.optim import merge_trainable, trainable_leaves
    tree = {"a": {"x": 1, "y": 2}, "b": {"z": 3}, "c": 4}
    mask = {"a": {"x": True, "y": False}, "b": {"z": False}, "c": True}
    assert trainable_leaves(tree, mask) == j_trainable(tree, mask) == {"a": {"x": 1}, "c": 4}
    new = {"a": {"x": 10}, "c": 40}
    assert merge_trainable(tree, new, mask) == j_merge(tree, new, mask)
    with pytest.raises(ValueError):
        merge_trainable(tree, {"c": 40}, mask)


# ---------------------------------------------------------------------------
# the ring
# ---------------------------------------------------------------------------

def ring_plan(kind, cfg):
    if kind == "auto-7":
        return plan.plan_from_config(cfg, N)
    if kind == "uniform-8":
        return plan.compile_plan(plan.uniform_partition(8),
                                 [partition.LayerCost(1.0, 2.0) for _ in range(8)],
                                 n_workers=N, n_body_layers=8)
    part = partition.Partition(fwd_stages=((0, 1), (2, 3)),
                               bwd_stages=((4, 5, 6), (3,), (0, 1, 2)),
                               t_max=9.0, objective=0.0, n_stages=5)
    costs = [partition.LayerCost(1.0, 2.0) for _ in range(6)] + [partition.LayerCost(2.0, 4.0)]
    return plan.compile_plan(part, costs, n_workers=N, n_body_layers=6)


@pytest.mark.parametrize("kind,n_layers", [("auto-7", 7), ("uneven-6", 6), ("uniform-8", 8)])
def test_ring_matches_single_program(kind, n_layers):
    j_cfg, cfg = configs(n_layers)
    p = ring_plan(kind, cfg)
    j_params = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), j_cfg,
                                                       dtype=jnp.float32))
    batch = batch_np(cfg, seed=n_layers)
    want_loss, want_grads = oracle(j_cfg, j_params, batch)
    params = dispatch.pad_pool(params_from_jax(j_params, device="cpu"), cfg, N)
    grads_fn = dispatch.build_roundpipe_grads_fn(cfg, N, p, xent_chunk=8, kv_chunk=8)
    grads, loss, tokens = grads_fn(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    assert len(grads["layers"]) == n_layers
    assert int(tokens) == int((batch["labels"] != -100).sum())
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert worst_rel(want_grads, params_to_numpy(grads)) < 5e-3


def test_ring_refuses_what_is_not_ported():
    _, cfg = configs(7)
    p = plan.plan_from_config(cfg, N)
    for kw, item in [({"lora": object()}, "LoRA"), ({"pool_dtype": "int8"}, "quantized pool"),
                     ({"grad_compress": "int8"}, "quantized pool"),
                     ({"n_microbatches": 8}, "multi-round"),
                     ({"prefetch_program": object()}, "multi-round"), ({"g0": 1}, "supervisor")]:
        with pytest.raises(NotImplementedError, match=item):
            dispatch.build_roundpipe_grads_fn(cfg, N, p, **kw)


# ---------------------------------------------------------------------------
# weights across, and the launcher
# ---------------------------------------------------------------------------

def test_roundpipe_state_round_trip_bit_exact():
    j_cfg, _ = configs(7)
    j_state = j_dispatch.init_roundpipe_state(jax.random.PRNGKey(1), j_cfg,
                                              JStepConfig(strategy="roundpipe"), n_workers=N)
    j_state = jax.tree.map(np.asarray, j_state)
    state = state_from_jax(j_state, device="cpu")
    assert len(state["params"]["layers"]) == 8
    assert state["params"]["embed"].dtype == torch.bfloat16
    assert state["opt"]["master"]["embed"].dtype == torch.float32
    back = state_to_numpy(state)
    flat_ref, tree_ref = jax.tree.flatten(j_state)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree_ref == tree_back
    for a, b in zip(flat_ref, flat_back):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    again = state_to_numpy(state_from_jax(back, device="cpu"))
    for a, b in zip(jax.tree.leaves(again), flat_back):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("dtype,rtol", [("float32", 1e-4), ("bfloat16", 2e-3)])
def test_launcher_tracks_the_reference_loop(dtype, rtol, monkeypatch):
    """fp32 weights (the launcher's state built in fp32) hold the 1e-4 bar. The
    launcher's own bf16 weights take 2e-3: the reference rounds the logits
    to bf16 before its softmax (``(x @ w).astype(f32)`` of bf16 operands) and
    the port's fused cross-entropy keeps them in fp32 (2.4e-4 measured)."""
    td, jd = getattr(torch, dtype), getattr(jnp, dtype)
    real_init = dispatch.init_roundpipe_state
    monkeypatch.setattr(dispatch, "init_roundpipe_state",
                        lambda *a, **kw: real_init(*a, **dict(kw, dtype=td)))
    args = train.build_parser().parse_args(
        ["--arch", ARCH, "--smoke", "--strategy", "roundpipe", "--mesh", "1x4", "--steps", "2",
         "--batch", str(B), "--seq", str(S), "--device", "cpu"])
    out = train.run_training(args)
    assert out["state"]["params"]["embed"].dtype == td
    j_cfg, cfg = configs(2)
    # the same initial weights: the launcher's seeded state, padded rows dropped
    from repro_torch.launch.steps import StepConfig
    init = real_init(torch.Generator().manual_seed(0), cfg, StepConfig(strategy="roundpipe"),
                     n_workers=N, dtype=td, device="cpu")
    j_params = jax.tree.map(lambda a: jnp.asarray(a).astype(jd),
                            params_to_numpy(dict(init["params"],
                                                 layers=init["params"]["layers"][:2])))
    opt_cfg = JOptConfig(lr=args.lr)
    j_opt = j_init_opt_state(j_params, opt_cfg)
    data = JDataset(JDataConfig(j_cfg.vocab_size, S, B))
    want = []
    for s in range(2):
        batch = data.batch(s)
        loss, grads = jax.value_and_grad(lambda p: JT.loss_fn(
            p, batch, j_cfg, remat=False, xent_chunk=8, kv_chunk=8))(j_params)
        j_params, j_opt, _ = j_apply_updates(j_opt, grads, opt_cfg, param_like=j_params)
        want.append(float(loss))
    np.testing.assert_allclose(out["losses"], want, rtol=rtol)


def _run_cli(*argv):
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
    return subprocess.run([sys.executable, "-m", "repro_torch.launch.train", *argv], cwd=ROOT,
                          env=env, capture_output=True, text=True, timeout=120)


def test_train_cli_on_cpu_and_refusals():
    base = ["--arch", ARCH, "--smoke", "--strategy", "roundpipe", "--mesh", "1x4"]
    r = _run_cli(*base, "--steps", "2", "--log-every", "1", "--device", "cpu")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("ExecutionPlan(N=4, L=2")
    assert lines[1].startswith("simulated bubble ratio (1 round, M=4): ")
    assert lines[2].startswith("step     0 loss ") and lines[3].startswith("step     1 loss ")
    assert lines[4].startswith("done: 2 steps")
    if not torch.cuda.is_available():
        r = _run_cli(*base, "--steps", "1")
        assert r.returncode != 0 and "CUDA is not available" in r.stderr
    for extra, name in [(["--async-opt"], "--async-opt"), (["--ckpt-dir", "x"], "--ckpt-dir"),
                        (["--mesh", "2x4"], "data axis"), (["--lora-rank", "4"], "--lora-rank"),
                        (["--microbatches", "8"], "--microbatches")]:
        r = _run_cli(*base, *extra, "--device", "cpu")
        assert r.returncode != 0 and name in r.stderr, (extra, r.stderr)


def test_step_config_has_the_reference_fields_and_defaults():
    from repro_torch.launch.steps import StepConfig
    ref_fields = {f.name: f for f in dataclasses.fields(JStepConfig)}
    got_fields = {f.name: f for f in dataclasses.fields(StepConfig)}
    assert list(got_fields) == list(ref_fields)
    ref_default, got_default = JStepConfig(), StepConfig()
    differ = {name for name in ref_fields
              if getattr(ref_default, name) != getattr(got_default, name)}
    # the dtype and optimizer fields hold the port's own objects; prefetch
    # is off until the prefetch slice (its field comment says why)
    assert differ == {"accum_dtype", "opt", "prefetch"}
    assert got_default.accum_dtype == torch.float32 and got_default.prefetch is False
    assert dataclasses.asdict(got_default.opt).keys() == dataclasses.asdict(ref_default.opt).keys()


def test_train_flags_are_the_documented_ones_and_device():
    from test_docs_cli import argparse_flags, documented_flags
    assert argparse_flags(train.build_parser()) == documented_flags("repro.launch.train") | {
        "--device"}
