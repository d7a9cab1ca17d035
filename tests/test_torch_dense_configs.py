"""The dense configs of the port against the JAX reference, on the CPU.

llama-3.1-8b, qwen3-32b, starcoder2-7b, stablelm-12b, gemma-2b and
nemotron-4-340b: each copied config equals the reference's field by field;
at smoke width (2 layers, d_model 64, 4 heads of 16) each arch's loss and
grads equal ``jax.value_and_grad`` of the reference's ``loss_fn`` and its
prefill and decode equal the reference's serving path, with the reference's
weights (its ``abstract_params`` tree filled from a numpy seed) carried
across by ``params_from_jax``. The smoke
config sets ``d_head=16``, so gemma-2b, stablelm-12b and nemotron-4-340b
also run at their true head dims (256, 160, 192), the widths the card's wide
attention kernels take. A 6-layer gemma-2b ring (tied head, MQA, geglu) is
held against the single-program oracle; the reference's own ring cannot run
it (``n_layers % N != 0``, ROADMAP.md "Reference faults").

Bars: the reference harness's (loss rtol 1e-4, grads worst relative
< 5e-3) and ``tests/test_torch_model.py``'s serving bar (fp32 logits 1e-4).
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
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import transformer as T
from repro_torch.models.config import get_config
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.optim.adam import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: smoke-width ops gain nothing from more, and the
    suite's parallel workers share the cores with the JAX package's
    multi-device subprocess tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


DENSE = ["llama-3.1-8b", "qwen3-32b", "starcoder2-7b", "stablelm-12b", "gemma-2b",
         "nemotron-4-340b"]
WIDE = {"gemma-2b": 256, "stablelm-12b": 160, "nemotron-4-340b": 192}
B, S = 2, 16


def npf(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def worst_rel(ref_tree, got_tree):
    """max over leaves of |got - ref|_inf / (|ref|_inf + 1e-6), as the harness."""
    ref_l, got_l = jax.tree.leaves(ref_tree), jax.tree.leaves(got_tree)
    assert len(ref_l) == len(got_l)
    return max(float(np.abs(npf(g) - npf(r)).max() / (np.abs(npf(r)).max() + 1e-6))
               for r, g in zip(ref_l, got_l))


@functools.cache
def model(arch, d_head=None, n_layers=None):
    """(reference config, reference fp32 weights as numpy, port config, port
    weights) at smoke width, optionally at another head dim or depth. The
    weights fill the reference's tree (``abstract_params``) from a numpy seed
    (eager JAX draws them ~10x slower): N(0, 1/fan_in) matrices and
    embeddings, norm scales near 1 and biases near 0."""
    extra = {k: v for k, v in (("d_head", d_head), ("n_layers", n_layers)) if v is not None}
    j_cfg = dataclasses.replace(j_smoke_config(j_get_config(arch)), **extra)
    cfg = dataclasses.replace(smoke_config(get_config(arch)), **extra)
    rng = np.random.default_rng(0)

    def draw(path, a):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(a.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * x
        if "bias" in name:
            return 0.1 * x
        return x / np.float32(np.sqrt(a.shape[-1] if "embed" in name else a.shape[-2]))

    tree = jax.tree_util.tree_map_with_path(draw, JT.abstract_params(j_cfg, jnp.float32))
    return j_cfg, tree, cfg, params_from_jax(tree, device="cpu")


def run_jitted(fn, *args):
    """``fn(*args)`` compiled once by XLA at backend optimisation level 0:
    eager JAX dispatches each operation alone, and at smoke width the full
    level's compile takes longer than the run it speeds up."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def oracle(j_cfg, tree, batch):
    """The reference's single program: ``jax.value_and_grad`` of its
    ``loss_fn``."""
    return run_jitted(jax.value_and_grad(lambda p, bt: JT.loss_fn(
        p, bt, j_cfg, remat=False, xent_chunk=8, kv_chunk=8)), tree, batch)


GEN, MAX_LEN = 3, 12


@functools.cache
def reference(arch, d_head=None):
    """The reference's loss and grads on ``batch_np(cfg, 1)`` and its serving
    logits (``T.prefill``, the last position's logits as ``launch/steps.py``
    takes them, then ``GEN`` greedy ``T.decode_step``s in a ``lax.scan``) for
    ``prompt(cfg)``, in one jitted program: one compile an arch serves the
    training and the serving tests."""
    j_cfg, tree, cfg, _ = model(arch, d_head)

    def run(p, bt, toks):
        loss, grads = jax.value_and_grad(lambda q: JT.loss_fn(
            q, bt, j_cfg, remat=False, xent_chunk=8, kv_chunk=8))(p)
        x, cache = JT.prefill(p, {"tokens": toks}, j_cfg, MAX_LEN, dtype=jnp.float32)
        logits = (x[:, -1] @ JT.lm_head_weights(p, j_cfg)).astype(jnp.float32)

        def step(carry, _):
            lg, c = carry
            lg, c = JT.decode_step(p, c, jnp.argmax(lg, axis=-1).astype(jnp.int32), j_cfg)
            return (lg, c), lg

        _, steps = jax.lax.scan(step, (logits, cache), None, length=GEN)
        return loss, grads, logits, steps

    loss, grads, first, steps = run_jitted(run, tree, batch_np(cfg, 1), prompt(cfg))
    return (float(loss), jax.tree.map(np.asarray, grads),
            [np.asarray(first)] + list(np.asarray(steps)))


def prompt(cfg):
    return np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)


def batch_np(cfg, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B * 4, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B * 4, S)).astype(np.int32)}
    batch["labels"][::3, :2] = -100
    return batch


@pytest.mark.parametrize("arch", DENSE)
def test_config_equals_reference(arch):
    got, want = dataclasses.asdict(get_config(arch)), dataclasses.asdict(j_get_config(arch))
    assert got == want
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(
        j_smoke_config(j_get_config(arch)))


def test_head_dims_and_groups_are_the_wide_kernels():
    """128 for three archs, 160, 192 and 256 for the others; every GQA group
    within flash-decode's 16 heads a kv head."""
    from repro_torch.kernels.decode_attention import G_MAX
    dims = {a: get_config(a).d_head for a in DENSE}
    assert dims == {"llama-3.1-8b": 128, "qwen3-32b": 128, "starcoder2-7b": 128,
                    "stablelm-12b": 160, "gemma-2b": 256, "nemotron-4-340b": 192}
    assert all(get_config(a).n_heads // get_config(a).n_kv_heads <= G_MAX for a in DENSE)


def _loss_and_grads(arch, d_head=None):
    _, _, cfg, params = model(arch, d_head)
    want_loss, want_grads, _ = reference(arch, d_head)
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_()
    loss = T.loss_fn(params, {k: torch.from_numpy(v) for k, v in batch_np(cfg, 1).items()},
                     cfg, remat=False, xent_chunk=8, kv_chunk=8)
    grads = torch.autograd.grad(loss, leaves)
    for x in leaves:
        x.requires_grad_(False)
    got = jax.tree.unflatten(jax.tree.structure(want_grads),
                             jax.tree.leaves(params_to_numpy(_rebuild(params, grads))))
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-4)
    assert worst_rel(want_grads, got) < 5e-3


def _rebuild(params, flat):
    """``params``' structure with the leaves of ``flat`` in tree_leaves order."""
    it = iter(flat)

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return next(it)

    return walk(params)


@pytest.mark.parametrize("arch", DENSE)
def test_loss_and_grads_match_reference(arch):
    _loss_and_grads(arch)


@pytest.mark.parametrize("arch", sorted(WIDE))
def test_loss_and_grads_at_the_true_head_dim(arch):
    _loss_and_grads(arch, d_head=WIDE[arch])


def _serving(arch, d_head=None):
    """The port's prefill and greedy decode steps against the reference's."""
    _, _, cfg, params = model(arch, d_head)
    want = reference(arch, d_head)[2]
    logits, cache = build_prefill_step(cfg, MAX_LEN)(
        params, {"tokens": torch.from_numpy(prompt(cfg))})
    decode = build_decode_step(cfg)
    got = [logits]
    for _ in range(GEN):
        logits, cache = decode(params, cache, logits.argmax(dim=-1))
        got.append(logits)
    assert len(got) == len(want) == GEN + 1
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("arch", DENSE)
def test_prefill_and_decode_match_reference(arch):
    _serving(arch)


@pytest.mark.parametrize("arch", sorted(WIDE))
def test_prefill_and_decode_at_the_true_head_dim(arch):
    _serving(arch, d_head=WIDE[arch])


def test_gemma_ring_matches_single_program():
    """gemma-2b at 6 layers on the auto plan for N = 4 workers (pool padded
    to 8 rows): the ring's loss and grads against the reference's single
    program, ``jax.value_and_grad(T.loss_fn)``."""
    n, layers = 4, 6
    j_cfg, tree, cfg, params = model("gemma-2b", n_layers=layers)
    assert cfg.tie_embeddings and cfg.n_kv_heads == 1 and cfg.mlp_kind == "geglu"
    batch = batch_np(cfg, 3)
    want_loss, want_grads = oracle(j_cfg, tree, batch)
    p = plan.plan_from_config(cfg, n)
    fn = dispatch.build_roundpipe_grads_fn(cfg, n, p, xent_chunk=8, kv_chunk=8)
    grads, loss, tokens = fn(dispatch.pad_pool(params, cfg, n),
                             {k: torch.from_numpy(v) for k, v in batch.items()})
    assert int(tokens) == int((batch["labels"] != -100).sum())
    assert len(grads["layers"]) == layers and "head" not in grads
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert worst_rel(want_grads, params_to_numpy(grads)) < 5e-3
