"""The port's staleness-1 asynchronous optimizer against the JAX reference,
on the CPU.

* ``repro_torch/core/consistency.py`` is a copy of the reference module:
  each top-level definition equals the original's (syntax trees), the
  reference's ``tests/test_core_consistency.py`` cases run against both
  modules, and ``verify_async_ticks`` gives the same verdicts (the same
  error, or none) on the same plans and programs, corrupted ones included;
* the chained ring (``build_roundpipe_async_train_step``) against the
  staleness-1 oracle ``reference_staleness1`` driven by the reference's
  ``jax.value_and_grad(T.loss_fn)`` and ``apply_updates``, with the four bars
  of ``tests/roundpipe_subprocess.py`` ``run_async``: losses rtol 1e-4, worst
  relative weight error < 5e-3, the oracle's separation from staleness-0 more
  than 10x that error, and the ring's distance from staleness-0 more than 5x
  it. Cases: the uniform 8-layer plan (N = 4) at (R, I) = (1, 3) and (2, 2)
  with prefetch, the shallow 3-layer plan at (1, 3) (step k+1's fused work
  overlaps step k's drain); frozen-base LoRA against the oracle over the
  adapters, the base bit-identical; the int8 pool against the oracle at the
  dequantized pool, and with error-feedback deposits against the oracle
  whose device function is the port's synchronous ring with the same
  deposits (a nonzero residual, the first loss the uncompressed chain's);
* ``overlap=False`` is bit-identical to looping the synchronous step;
* ``HostAsyncRoundPipe`` (threads, host-resident optimizer) within 5e-3 of
  the oracle, losses rtol 1e-4;
* ``async_apply`` / ``flush`` against the reference's; ``search_schedule``'s
  winner, scores and program against the reference's on three plans.

Sizes are the ring harness's: smoke qwen3-1.7b, N = 4, 8 samples of 16
tokens a round, fp32 weights from the reference's ``init_params``, xent and
kv chunks of 8, learning rate 1e-2 (large enough that staleness shows).
"""
import ast
import dataclasses
import functools
import random
import threading
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core import consistency as j_consistency
from repro.core import plan as j_plan
from repro.core import simulator as j_simulator
from repro.kernels import ops as j_kops
from repro.kernels.dequant import quantize_rows as j_quantize_rows
from repro.models import lora as j_lora
from repro.models import transformer as JT
from repro.models.config import get_config as j_get_config
from repro.optim import OptConfig as JOptConfig
from repro.optim import apply_updates as j_apply_updates
from repro.optim import init_opt_state as j_init_opt_state
from repro.optim import async_opt as j_async_opt
from repro_torch.configs import smoke_config
from repro_torch.core import consistency, dispatch, plan, simulator
from repro_torch.launch.steps import StepConfig
from repro_torch.models import lora
from repro_torch.models.config import get_config
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.optim import OptConfig, init_opt_state
from repro_torch.optim import async_opt
from repro_torch.optim.adam import tree_leaves, trainable_leaves


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: smoke-width ops gain nothing from more, and the
    suite's parallel workers share the cores with the JAX package's
    multi-device subprocess tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-1.7b"
N, B, S = 4, 8, 16
LR = 1e-2
J_LCFG, LCFG = j_lora.LoraConfig(rank=4, alpha=8.0), lora.LoraConfig(rank=4, alpha=8.0)
MODULES = {"reference": j_consistency, "port": consistency}


def npf(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def worst_rel(ref_tree, got_tree):
    """max over leaves of |got - ref|_inf / (|ref|_inf + 1e-6), as the harness."""
    ref_l, got_l = jax.tree.leaves(ref_tree), jax.tree.leaves(got_tree)
    assert len(ref_l) == len(got_l)
    return max(float(np.abs(npf(g) - npf(r)).max() / (np.abs(npf(r)).max() + 1e-6))
               for r, g in zip(ref_l, got_l))


def assert_bit_equal(a_tree, b_tree):
    a_l, b_l = tree_leaves(a_tree), tree_leaves(b_tree)
    assert len(a_l) == len(b_l)
    for a, b in zip(a_l, b_l):
        assert a.dtype == b.dtype and torch.equal(a, b)


# ---------------------------------------------------------------------------
# core/consistency.py: the copy, and the reference's cases on both modules
# ---------------------------------------------------------------------------

def _definitions(path):
    tree = ast.parse(path.read_text())
    return {getattr(node, "name", None) or f"<statement {i}>": ast.dump(node)
            for i, node in enumerate(tree.body)}


def test_consistency_copy_equals_the_reference():
    ref = _definitions(ROOT / "src" / "repro" / "core" / "consistency.py")
    got = _definitions(ROOT / "src" / "repro_torch" / "core" / "consistency.py")
    assert ref == got


def make_workload(n_layers, jitter=0.0, seed=0):
    """Deterministic math, optional random sleeps to shake out races."""
    rng = random.Random(seed)

    def device_fn(weights, t):
        if jitter:
            time.sleep(rng.random() * jitter)
        return [w * 0.1 + (t + 1) * (l + 1) for l, w in enumerate(weights)]

    def optimizer_fn(opt, grads, t):
        if jitter:
            time.sleep(rng.random() * jitter)
        return [w - 0.01 * g for w, g in zip(opt, grads)]

    return device_fn, optimizer_fn


def _event_book_case(mod, case):
    book = mod.EventBook()
    if case == "negative_iteration_vacuous":
        book.wait("pcp", 0, -1)
    elif case == "set_then_wait":
        book.set("up", 3, 7)
        book.wait("up", 3, 7, timeout=0.1)
    elif case == "timeout":
        with pytest.raises(TimeoutError):
            book.wait("up", 0, 0, timeout=0.05)
    elif case == "cross_thread":
        def setter():
            time.sleep(0.02)
            book.set("down", 1, 2)
        th = threading.Thread(target=setter)
        th.start()
        book.wait("down", 1, 2, timeout=1.0)
        th.join()
    elif case == "timeout_message_names_event":
        with pytest.raises(TimeoutError, match=r"\(gcp, layer=2, it=5\)"):
            book.wait("gcp", 2, 5, timeout=0.01)
    elif case == "is_set_vacuous_for_prehistory":
        assert book.is_set("up", 0, -1) and book.is_set("pcp", 9, -3)
        assert not book.is_set("up", 0, 0)


@pytest.mark.parametrize("mod", MODULES)
@pytest.mark.parametrize("case", ["negative_iteration_vacuous", "set_then_wait", "timeout",
                                  "cross_thread", "timeout_message_names_event",
                                  "is_set_vacuous_for_prehistory"])
def test_event_book(mod, case):
    _event_book_case(MODULES[mod], case)


@pytest.mark.parametrize("mod", MODULES)
@pytest.mark.parametrize("n_layers,n_iters", [(1, 3), (4, 6), (8, 10)])
def test_async_trainer_matches_reference_staleness1(mod, n_layers, n_iters):
    m = MODULES[mod]
    dev, opt = make_workload(n_layers)
    init = [float(i + 1) for i in range(n_layers)]
    got = m.AsyncTrainer(n_layers, dev, opt, init).train(n_iters)
    want = m.reference_staleness1(n_layers, *make_workload(n_layers)[0:2], init, n_iters)
    assert got == pytest.approx(want)
    assert want == j_consistency.reference_staleness1(n_layers, *make_workload(n_layers)[0:2],
                                                      init, n_iters)


@pytest.mark.parametrize("mod", MODULES)
def test_async_trainer_with_jitter_and_stale_reads(mod):
    m = MODULES[mod]
    n_layers, n_iters = 5, 8
    init = [1.0] * n_layers
    for seed in range(3):
        dev, opt = make_workload(n_layers, jitter=0.003, seed=seed)
        got = m.AsyncTrainer(n_layers, dev, opt, init).train(n_iters)
        want = m.reference_staleness1(n_layers, *make_workload(n_layers), init, n_iters)
        assert got == pytest.approx(want), f"seed {seed}"
    seen = []

    def device_fn(weights, t):
        seen.append((t, list(weights)))
        return [1.0 for _ in weights]

    m.AsyncTrainer(2, device_fn, lambda o, g, t: [w - 1.0 for w in o], [10.0, 10.0]).train(5)
    for t, w in sorted(seen):
        assert w[0] == pytest.approx(10.0 - max(0, t - 1))

    def failing(weights, t):
        raise RuntimeError("device failure")

    with pytest.raises((RuntimeError, TimeoutError)):
        m.AsyncTrainer(2, failing, lambda o, g, t: o, [1.0, 1.0]).train(2, timeout=2.0)


@pytest.mark.parametrize("mod", MODULES)
def test_protocol_ordering(mod):
    m = MODULES[mod]
    p = m.ConsistencyProtocol(1)
    done = []

    def pcopy():
        p.before_p_copy(0, 0)
        done.append("pcp")

    th = threading.Thread(target=pcopy)
    th.start()
    time.sleep(0.05)
    assert done == []                   # (1): P-copy of 0 waits for the upload of 1
    p.after_param_upload(0, 1)
    th.join(1.0)
    assert done == ["pcp"]

    def writer():
        p.before_grad_download(0, 1)
        done.append("down")

    th = threading.Thread(target=writer)
    th.start()
    time.sleep(0.05)
    assert done == ["pcp"]              # (4): download of 1 waits for the G-copy of 0
    p.after_g_copy(0, 0)
    th.join(1.0)
    assert done == ["pcp", "down"]
    q = m.ConsistencyProtocol(3)
    for lid in range(3):
        q.before_param_upload(lid, 0)
        q.before_param_upload(lid, 1)
        q.before_grad_download(lid, 0)
    r = m.ConsistencyProtocol(1)
    assert r.may_param_upload(0, 0) and r.may_param_upload(0, 1)
    assert not r.may_param_upload(0, 2)
    r.after_p_copy(0, 0)
    assert r.may_param_upload(0, 2) and not r.may_g_copy(0, 0)
    r.after_grad_download(0, 0)
    assert r.may_g_copy(0, 0) and not r.may_grad_download(0, 1)
    r.after_g_copy(0, 0)
    assert r.may_grad_download(0, 1)
    r.after_param_upload(0, 3)
    assert r.may_p_copy(0, 3, double_buffered=True) and not r.may_p_copy(0, 3)
    r.after_param_upload(0, 4)
    assert r.may_p_copy(0, 3)


def _verdict(fn):
    try:
        fn()
    except ValueError as e:
        return str(e)
    return None


def _one_layer_plans():
    from repro.core.partition import LayerCost as JLayerCost
    from repro_torch.core.partition import LayerCost
    return (j_plan.compile_plan(j_plan.uniform_partition(1), [JLayerCost(1.0, 2.0)],
                                n_workers=4, n_body_layers=1),
            plan.compile_plan(plan.uniform_partition(1), [LayerCost(1.0, 2.0)], n_workers=4,
                              n_body_layers=1))


@pytest.mark.parametrize("layers,partition", [(7, "auto"), (8, "uniform"), (3, "auto"),
                                              (1, "one-slot")])
def test_verify_async_ticks_gives_the_reference_verdicts(layers, partition):
    """Every (R, I) up to 3 x 4 on each plan, and programs with one record
    corrupted (a moved update, a dropped deposit, a wrong injection step)."""
    if partition == "one-slot":
        j_p, p = _one_layer_plans()
    else:
        _, cfg = configs(layers)
        j_cfg, _ = configs(layers)
        part = plan.uniform_partition(layers) if partition == "uniform" else None
        j_part = j_plan.uniform_partition(layers) if partition == "uniform" else None
        p = plan.plan_from_config(cfg, N, partition=part)
        j_p = j_plan.plan_from_config(j_cfg, N, partition=j_part)
    verdicts = []
    for rounds in (1, 2, 3):
        for iters in (1, 2, 4):
            got = _verdict(lambda: consistency.verify_async_ticks(
                p, rounds, iters, program=p.tick_program(rounds, iters)))
            want = _verdict(lambda: j_consistency.verify_async_ticks(
                j_p, rounds, iters, program=j_p.tick_program(rounds, iters)))
            assert got == want, (rounds, iters)
            verdicts.append(got)
            prog = p.tick_program(rounds, iters)
            j_prog = j_p.tick_program(rounds, iters)
            for field, value in (("update_step", 0), ("deposit", None), ("inject_step", 5)):
                t = len(prog.records) // 2
                bad = dataclasses.replace(prog, records=prog.records[:t] + (
                    dataclasses.replace(prog.records[t], **{field: value}),)
                    + prog.records[t + 1:])
                j_bad = dataclasses.replace(j_prog, records=j_prog.records[:t] + (
                    dataclasses.replace(j_prog.records[t], **{field: value}),)
                    + j_prog.records[t + 1:])
                assert (_verdict(lambda: consistency.verify_async_ticks(p, rounds, iters, bad))
                        == _verdict(lambda: j_consistency.verify_async_ticks(
                            j_p, rounds, iters, j_bad)))
    if partition == "one-slot":
        assert any(v and "constraint (2)" in v for v in verdicts)
        with pytest.raises(ValueError, match="infeasible"):
            p.validate_async(1)
    else:
        assert verdicts[0] is None


# ---------------------------------------------------------------------------
# The chained ring against the staleness-1 oracle
# ---------------------------------------------------------------------------

@functools.cache
def configs(n_layers):
    j_cfg = dataclasses.replace(j_smoke_config(j_get_config(ARCH)), n_layers=n_layers)
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)), n_layers=n_layers)
    return j_cfg, cfg


@functools.cache
def base_params(n_layers):
    j_cfg, _ = configs(n_layers)
    init = jax.jit(lambda k: JT.init_params(k, j_cfg, dtype=jnp.float32))
    return jax.tree.map(np.asarray, init(jax.random.PRNGKey(0)))


@functools.cache
def dense_oracle(n_layers):
    j_cfg, _ = configs(n_layers)
    return jax.jit(jax.value_and_grad(lambda p, bt: JT.loss_fn(
        p, bt, j_cfg, remat=False, xent_chunk=8, kv_chunk=8)))


@functools.cache
def lora_oracle(n_layers):
    j_cfg, _ = configs(n_layers)
    j_params = base_params(n_layers)
    return jax.jit(jax.value_and_grad(lambda ad, bt: JT.loss_fn(
        j_lora.merge_params(j_params, ad, J_LCFG), bt, j_cfg, remat=False, xent_chunk=8,
        kv_chunk=8)))


def make_batches(cfg, steps, rows, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (steps, rows, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (steps, rows, S)).astype(np.int32)}
    batch["labels"][:, ::3, :2] = -100
    return batch


def oracles(init, grad_of, batches, steps):
    """The staleness-1 oracle (final weights, losses) and the staleness-0
    (synchronous) trajectory's final weights, with the reference's Adam."""
    ocfg = JOptConfig(lr=LR)
    ref_losses = []
    cell = {"opt": j_init_opt_state(init, ocfg)}

    def device_fn(weights, t):
        loss, grads = grad_of(weights[0], t)
        ref_losses.append(float(loss))
        return [grads]

    def optimizer_fn(opt_w, staged, t):
        new, cell["opt"], _ = j_apply_updates(cell["opt"], staged[0], ocfg, param_like=init)
        return [new]

    ref_final = j_consistency.reference_staleness1(1, device_fn, optimizer_fn, [init], steps)[0]
    cur, opt = init, j_init_opt_state(init, ocfg)
    for t in range(steps):
        _, grads = grad_of(cur, t)
        cur, opt, _ = j_apply_updates(opt, grads, ocfg, param_like=init)
    return ref_final, ref_losses, cur


def step_of(t, batches):
    return {k: v[t] for k, v in batches.items()}


def torch_batches(batches):
    return {k: torch.from_numpy(v) for k, v in batches.items()}


def dense_state(n_layers, cfg):
    params = dispatch.pad_pool(params_from_jax(base_params(n_layers), device="cpu"), cfg, N)
    return {"params": params, "opt": init_opt_state(params, OptConfig(lr=LR))}


def real_params(params, cfg, key="layers"):
    out = params_to_numpy(params)
    out[key] = jax.tree.map(lambda a: a[:cfg.n_layers], out[key])
    return out


def check_bars(metrics_loss, ref_losses, got, ref_final, sync_final):
    err_s1 = worst_rel(ref_final, got)
    err_s0 = worst_rel(sync_final, got)
    sep = worst_rel(sync_final, ref_final)
    np.testing.assert_allclose(npf(metrics_loss), np.asarray(ref_losses), rtol=1e-4)
    assert err_s1 < 5e-3, err_s1
    assert sep > 10 * max(err_s1, 1e-9), (sep, err_s1)
    assert err_s0 > 5 * err_s1, (err_s0, err_s1)
    return err_s1


@pytest.mark.parametrize("layers,partition,rounds,steps,prefetch", [
    (8, "uniform", 1, 3, False), (8, "uniform", 2, 2, True), (3, "auto", 1, 3, True)])
def test_chained_ring_matches_the_staleness1_oracle(layers, partition, rounds, steps,
                                                    prefetch):
    j_cfg, cfg = configs(layers)
    p = plan.plan_from_config(cfg, N, partition=plan.uniform_partition(layers)
                              if partition == "uniform" else None)
    if partition == "auto":
        assert p.n_fwd < N - 1          # the shallow case: k+1's fused work overlaps k's drain
    batches = make_batches(cfg, steps, rounds * B, seed=layers + rounds)
    oracle = dense_oracle(layers)
    ref_final, ref_losses, sync_final = oracles(
        base_params(layers), lambda w, t: oracle(w, step_of(t, batches)), batches, steps)
    step_cfg = StepConfig(strategy="roundpipe", partition=p, n_microbatches=rounds * N,
                          prefetch=prefetch, kv_chunk=8, xent_chunk=8, opt=OptConfig(lr=LR))
    multi, _ = dispatch.build_roundpipe_async_train_step(cfg, N, step_cfg, rounds * B, S,
                                                         steps_per_call=steps, plan=p)
    state, metrics = multi(dense_state(layers, cfg), torch_batches(batches))
    assert tuple(metrics["loss"].shape) == tuple(metrics["grad_norm"].shape) == (steps,)
    assert int(metrics["step"]) == steps
    assert metrics["tokens"].tolist() == [int((batches["labels"][t] != -100).sum())
                                          for t in range(steps)]
    check_bars(metrics["loss"], ref_losses, real_params(state["params"], cfg), ref_final,
               sync_final)


def test_overlap_false_is_the_synchronous_loop_bit_for_bit():
    _, cfg = configs(8)
    p = plan.plan_from_config(cfg, N, partition=plan.uniform_partition(8))
    steps = 3
    batches = torch_batches(make_batches(cfg, steps, B, seed=11))
    step_cfg = StepConfig(strategy="roundpipe", partition=p, kv_chunk=8, xent_chunk=8,
                          opt=OptConfig(lr=LR))
    nool, _ = dispatch.build_roundpipe_async_train_step(cfg, N, step_cfg, B, S,
                                                        steps_per_call=steps, plan=p,
                                                        overlap=False)
    a, m_a = nool(dense_state(8, cfg), batches)
    sync, _ = dispatch.build_roundpipe_train_step(cfg, N, step_cfg, B, S, plan=p)
    b = dense_state(8, cfg)
    losses = []
    for t in range(steps):
        b, m = sync(b, step_of(t, batches))
        losses.append(m["loss"])
    assert_bit_equal(a, b)
    assert torch.equal(m_a["loss"], torch.stack(losses))


def test_chained_lora_ring_matches_the_adapter_oracle():
    layers, rounds, steps = 8, 2, 2
    j_cfg, cfg = configs(layers)
    p = plan.plan_from_config(cfg, N, lora=LCFG)
    j_params = base_params(layers)
    shape = jax.eval_shape(lambda: j_lora.init_adapters(
        jax.random.PRNGKey(3), j_params["layers"], J_LCFG, dtype=jnp.float32))
    rng = np.random.default_rng(5)
    j_ad = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
                        shape)
    batches = make_batches(cfg, steps, rounds * B, seed=12)
    oracle = lora_oracle(layers)
    ref_final, ref_losses, sync_final = oracles(
        j_ad, lambda w, t: oracle(w, step_of(t, batches)), batches, steps)
    params = dispatch.pad_pool(params_from_jax(dict(j_params, lora=j_ad), device="cpu"), cfg, N)
    base = {k: v for k, v in params.items() if k != "lora"}
    base_copy = {k: [dict(r) for r in v] if k == "layers" else v for k, v in base.items()}
    base_copy = jax.tree.map(torch.clone, base_copy)
    state = {"params": params, "opt": init_opt_state(
        trainable_leaves(params, lora.param_mask(params)), OptConfig(lr=LR))}
    step_cfg = StepConfig(strategy="roundpipe", partition=p, n_microbatches=rounds * N,
                          kv_chunk=8, xent_chunk=8, lora=LCFG, opt=OptConfig(lr=LR))
    multi, _ = dispatch.build_roundpipe_async_train_step(cfg, N, step_cfg, rounds * B, S,
                                                         steps_per_call=steps, plan=p)
    state, metrics = multi(state, torch_batches(batches))
    new = state["params"]
    # the frozen base: the same tensors, bit-identical to a copy taken before
    assert all(a is b for a, b in zip(tree_leaves({k: new[k] for k in base}),
                                      tree_leaves(base)))
    assert_bit_equal({k: new[k] for k in base}, base_copy)
    got = params_to_numpy({"lora": new["lora"]})["lora"]
    got = jax.tree.map(lambda a: a[:layers], got)
    check_bars(metrics["loss"], ref_losses, got, ref_final, sync_final)


def _dequantize_pool(layers_tree, bits):
    """The quantize -> ship -> dequant round trip of the pool, per layer row
    (leaves end to end, blocks spanning leaf boundaries), through the
    reference's codec (``tests/roundpipe_subprocess.py``)."""
    leaves, tdef = jax.tree_util.tree_flatten(layers_tree)
    rows = leaves[0].shape[0]
    cat = jnp.concatenate([l.reshape(rows, -1).astype(jnp.float32) for l in leaves], axis=1)
    codes, scales = j_quantize_rows(cat, bits=bits)
    flat = j_kops.dequant_rows(codes, scales)[:, :cat.shape[1]]
    out, off = [], 0
    for l in leaves:
        ne = int(np.prod(l.shape[1:]))
        out.append(flat[:, off:off + ne].reshape(l.shape).astype(l.dtype))
        off += ne
    return jax.tree_util.tree_unflatten(tdef, out)


def test_chained_int8_pool_and_ef_deposits_match_the_dequantized_oracle():
    """The int8 pool against the staleness-1 oracle at the reference's
    dequantized pool (``run_async_quant``'s first part). With error-feedback
    deposits the oracle's device function is the port's synchronous ring with
    the same int8 pool and EF deposits, its residual carried across the
    oracle's iterations: the chain must apply the same codec to the same
    gradients in the same order, so it is held to the same four bars; its
    first loss equals the uncompressed chain's and its residual is nonzero."""
    layers, rounds, steps = 8, 1, 3
    j_cfg, cfg = configs(layers)
    p = plan.plan_from_config(cfg, N, pool_dtype="int8")
    batches = make_batches(cfg, steps, B, seed=13)
    oracle = dense_oracle(layers)

    def dq(w):
        return dict(w, layers=_dequantize_pool(w["layers"], 8))

    ref_final, ref_losses, sync_final = oracles(
        base_params(layers), lambda w, t: oracle(dq(w), step_of(t, batches)), batches, steps)

    def chain(compress):
        step_cfg = StepConfig(strategy="roundpipe", partition=p, n_microbatches=rounds * N,
                              kv_chunk=8, xent_chunk=8, pool_dtype="int8",
                              grad_compress=compress, opt=OptConfig(lr=LR))
        multi, _ = dispatch.build_roundpipe_async_train_step(cfg, N, step_cfg, B, S,
                                                             steps_per_call=steps, plan=p)
        state = dense_state(layers, cfg)
        if compress != "none":
            state["opt"]["grad_residual"] = zero_residual(state["params"]["layers"])
        return multi(state, torch_batches(batches))

    state, metrics = chain("none")
    check_bars(metrics["loss"], ref_losses, real_params(state["params"], cfg), ref_final,
               sync_final)

    # the EF oracle: the synchronous ring's EF grads at the staleness-1 weights
    ring = dispatch.build_roundpipe_grads_fn(cfg, N, p, xent_chunk=8, kv_chunk=8,
                                             pool_dtype="int8", grad_compress="int8")
    tb = torch_batches(batches)

    def ef_oracle():
        residual = zero_residual(dense_state(layers, cfg)["params"]["layers"])

        def grad_of(weights, t):
            w = dispatch.pad_pool(params_from_jax(weights, device="cpu"), cfg, N)
            grads, loss, _, _ = ring(w, step_of(t, tb), residual)
            return float(loss), params_to_numpy(grads)
        return oracles(base_params(layers), grad_of, batches, steps)

    ef_final, ef_losses, ef_sync = ef_oracle()
    state_c, metrics_c = chain("int8")
    check_bars(metrics_c["loss"], ef_losses, real_params(state_c["params"], cfg), ef_final,
               ef_sync)
    np.testing.assert_allclose(float(metrics_c["loss"][0]), float(metrics["loss"][0]),
                               rtol=1e-6)
    assert sum(float(x.abs().sum()) for x in tree_leaves(state_c["opt"]["grad_residual"])) > 0


def zero_residual(pool):
    return [{k: v for k, v in jax.tree.map(torch.zeros_like, row).items()} for row in pool]


def test_host_async_roundpipe_matches_the_oracle():
    layers, steps = 8, 3
    _, cfg = configs(layers)
    p = plan.plan_from_config(cfg, N, partition=plan.uniform_partition(layers))
    batches = make_batches(cfg, steps, B, seed=14)
    oracle = dense_oracle(layers)
    ref_final, ref_losses, _ = oracles(
        base_params(layers), lambda w, t: oracle(w, step_of(t, batches)), batches, steps)
    grads_fn = dispatch.build_roundpipe_grads_fn(cfg, N, p, xent_chunk=8, kv_chunk=8)
    params = params_from_jax(base_params(layers), device="cpu")
    tb = torch_batches(batches)
    host = async_opt.HostAsyncRoundPipe(grads_fn, params, OptConfig(lr=LR),
                                        [step_of(t, tb) for t in range(steps)])
    final = host.train(steps)
    assert all(x.device.type == "cpu" for x in tree_leaves(host._opt))
    assert worst_rel(ref_final, params_to_numpy(final)) < 5e-3
    np.testing.assert_allclose(np.asarray(host.losses), np.asarray(ref_losses), rtol=1e-4)
    assert len(host.optimizer_s) == len(host.device_s) == steps
    assert 0.0 <= host.hidden_share() <= 1.0


# ---------------------------------------------------------------------------
# async_apply / flush, split_host_layers, search_schedule
# ---------------------------------------------------------------------------

def _opt_params():
    return {"w": np.arange(4, dtype=np.float32) + 1.0, "b": np.ones((2,), np.float32)}


def _opt_grads(t):
    return {"w": np.full((4,), 0.1 * (t + 1), np.float32),
            "b": np.full((2,), -0.2 * (t + 1), np.float32)}


def test_async_apply_and_flush_match_the_reference():
    j_cfg, cfg = JOptConfig(lr=0.1, b1=0.5, b2=0.9, grad_clip=0.0), \
        OptConfig(lr=0.1, b1=0.5, b2=0.9, grad_clip=0.0)
    tt = lambda tree: {k: torch.from_numpy(v.copy()) for k, v in tree.items()}   # noqa: E731
    j_p, p = {k: jnp.asarray(v) for k, v in _opt_params().items()}, tt(_opt_params())
    j_state, state = j_async_opt.init_async(j_p, j_cfg), async_opt.init_async(p, cfg)
    assert not state.has_pending
    for t in range(4):
        j_p, j_state, j_m = j_async_opt.async_apply(
            j_p, j_state, {k: jnp.asarray(v) for k, v in _opt_grads(t).items()}, j_cfg)
        p, state, m = async_opt.async_apply(p, state, tt(_opt_grads(t)), cfg)
        assert int(m["step"]) == int(j_m["step"]) == t
        np.testing.assert_allclose(float(m["grad_norm"]), float(j_m["grad_norm"]), rtol=1e-6)
        for k in p:
            np.testing.assert_allclose(npf(p[k]), np.asarray(j_p[k], np.float32), rtol=1e-6)
    for _ in range(2):                  # the second flush has nothing to drain
        j_p, j_state, j_m = j_async_opt.flush(j_p, j_state, j_cfg)
        p, state, m = async_opt.flush(p, state, cfg)
        assert int(m["step"]) == int(j_m["step"]) == 4 and not state.has_pending
        for k in p:
            np.testing.assert_allclose(npf(p[k]), np.asarray(j_p[k], np.float32), rtol=1e-6)
    assert all(float(x.abs().max()) == 0.0 for x in state.pending.values())


def test_split_host_layers_matches_the_reference_units():
    t = {"embed": torch.ones((5, 3)),
         "layers": [{"attn": torch.arange(6.0).reshape(2, 3) + 6 * i, "mlp": torch.ones(3)}
                    for i in range(4)],
         "final_norm": {"scale": torch.ones(3)}}
    units, unsplit = async_opt.split_host_layers(t)
    j_units, _ = j_async_opt.split_host_layers(params_to_numpy(t))
    assert len(units) == len(j_units) == 5
    for u, ju in zip(units, j_units):
        assert jax.tree.structure(params_to_numpy(u)) == jax.tree.structure(ju)
        for a, b in zip(jax.tree.leaves(params_to_numpy(u)), jax.tree.leaves(ju)):
            np.testing.assert_array_equal(a, np.asarray(b))
    assert_bit_equal(unsplit(units), t)


@pytest.mark.parametrize("layers,partition,micro,iters,bandwidth", [
    (7, "auto", 4, 1, None), (8, "uniform", 8, 3, 2e9), (3, "auto", 4, 2, 1e8)])
def test_search_schedule_matches_the_reference(layers, partition, micro, iters, bandwidth):
    j_cfg, cfg = configs(layers)
    part = plan.uniform_partition(layers) if partition == "uniform" else None
    j_part = j_plan.uniform_partition(layers) if partition == "uniform" else None
    p = plan.plan_from_config(cfg, N, partition=part)
    j_p = j_plan.plan_from_config(j_cfg, N, partition=j_part)
    got = simulator.search_schedule(p, micro, iterations=iters, bandwidth=bandwidth)
    want = j_simulator.search_schedule(j_p, micro, iterations=iters, bandwidth=bandwidth)
    assert got.choice.name == want.choice.name and got.bubble == want.bubble
    assert got.hand_bubble == want.hand_bubble
    assert [(c.name, b) for c, b in got.scored] == [(c.name, b) for c, b in want.scored]
    assert got.program.to_json() == want.program.to_json()


def test_a_rotated_searched_schedule_is_refused_by_name(monkeypatch):
    """A searched winner with g0 != 0 is no longer refused: the chained and
    the synchronous builders run its rotated program, on the losses and the
    weights of the unrotated one (the rotation changes only which physical
    worker plays each logical position, and so the order of fp32 sums)."""
    _, cfg = configs(8)
    p = plan.plan_from_config(cfg, N)
    scfg = StepConfig(strategy="roundpipe", partition=p, schedule="searched", kv_chunk=8,
                      xent_chunk=8, opt=OptConfig(lr=LR))
    batches = torch_batches(make_batches(cfg, 2, B, seed=21))
    hand, _ = dispatch.build_roundpipe_async_train_step(cfg, N, scfg, B, S, steps_per_call=2,
                                                        plan=p)
    want, want_m = hand(dense_state(8, cfg), batches)
    search = simulator.search_schedule

    def rotated(iterations):
        result = search(p, N, iterations=iterations, candidates=[
            simulator.ScheduleChoice("hand"), simulator.ScheduleChoice("rot1", g0=1)],
            device_scale=[3.0, 1.0, 1.0, 1.0])
        assert result.program.g0 == 1
        return result

    monkeypatch.setattr(simulator, "search_schedule", lambda *a, **k: rotated(2))
    multi, _ = dispatch.build_roundpipe_async_train_step(cfg, N, scfg, B, S, steps_per_call=2,
                                                         plan=p)
    got, got_m = multi(dense_state(8, cfg), batches)
    np.testing.assert_allclose(npf(got_m["loss"]), npf(want_m["loss"]), rtol=1e-5)
    assert worst_rel(real_params(want["params"], cfg), real_params(got["params"], cfg)) < 1e-4
    monkeypatch.setattr(simulator, "search_schedule", lambda *a, **k: rotated(1))
    sync, _ = dispatch.build_roundpipe_train_step(cfg, N, scfg, B, S, plan=p)
    _, m = sync(dense_state(8, cfg), step_of(0, batches))
    np.testing.assert_allclose(float(m["loss"]), float(want_m["loss"][0]), rtol=1e-5)
