"""Multi-head latent attention (MLA) and deepseek-v2-236b in the port against
the JAX reference, on the CPU.

The copied config equals the reference's field by field (all 60 layers MoE,
the reference's deviation from the real model). At smoke width (Dh 16 + 8
of RoPE against Dv 16, a latent of 16) the MLA branch of ``_attention_block``
and its gradients equal the reference's; a 2-layer smoke deepseek's loss and
grads equal ``jax.value_and_grad`` of the reference's ``loss_fn``; its
prefill and 3 greedy decode steps (the absorbed decode, in the compressed
space) equal the reference's ``prefill`` and ``decode_step``, logits and the
``c_kv``/``k_pe`` caches both, and equal one teacher-forced prefill of the
port, which materialises keys and values. A 4-layer smoke ring (N = 4),
dense and LoRA over the attention, equals the port's single program. The
counts (``param_count``, ``active_param_count``, the LoRA targets and
adapter sizes, ``default_layer_costs``) equal the reference's at full
width, and the init and cache layouts equal the reference's abstract ones.

Weights fill the reference's tree (``abstract_params``) from a numpy seed and
cross by ``params_from_jax``. Bars: loss rtol 1e-4, grads worst relative
< 5e-3, fp32 serving logits and caches 1e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core import plan as j_plan
from repro.models import lora as j_lora
from repro.models import transformer as JT
from repro.models.config import get_config as j_get_config
from repro_torch.configs import smoke_config
from repro_torch.core import dispatch, plan
from repro_torch.launch import serve, train
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import lora
from repro_torch.models import transformer as T
from repro_torch.models.config import get_config
from repro_torch.models.convert import params_from_jax, params_to_numpy
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


ARCH = "deepseek-v2-236b"
N, B, S = 4, 8, 16
RING_LAYERS = 4
GEN, MAX_LEN = 3, 12
LCFG = lora.LoraConfig(rank=4, alpha=8.0, target_modules=("attn",))
MLA_LEAVES = ["attn.w_dkv", "attn.w_kpe", "attn.w_o"]     # MLA's rank-2 (stacked rank-3) leaves


def npf(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def worst_rel(ref_tree, got_tree):
    """max over leaves of |got - ref|_inf / (|ref|_inf + 1e-6), as the harness."""
    ref_l, got_l = jax.tree.leaves(ref_tree), jax.tree.leaves(got_tree)
    assert len(ref_l) == len(got_l)
    return max(float(np.abs(npf(g) - npf(r)).max() / (np.abs(npf(r)).max() + 1e-6))
               for r, g in zip(ref_l, got_l))


def run_jitted(fn, *args):
    """``fn(*args)`` compiled once by XLA at backend optimisation level 0
    (at smoke width the full level's compile takes longer than the run)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _fan_in(name, shape):
    """The fan-in of a leaf of the reference's tree: MLA's (d, h, e) query
    and (r, h, d) up-projections take the axis before the heads; every other
    matrix (the experts' stacked ones too) its second-to-last axis, the
    embedding its last."""
    if "embed" in name:
        return shape[-1]
    if name.endswith(("['w_q']", "['w_uk']", "['w_uv']")) and "attn" in name:
        return shape[-3]
    return shape[-2]


def _draw(rng):
    def draw(path, a):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(a.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * x
        return x / np.float32(np.sqrt(_fan_in(name, a.shape)))
    return draw


@functools.cache
def model(n_layers=2):
    """(reference config, reference fp32 weights as numpy, port config, port
    weights) of the smoke deepseek at ``n_layers``: N(0, 1/fan_in) matrices
    and embeddings, norm scales near 1."""
    j_cfg = dataclasses.replace(j_smoke_config(j_get_config(ARCH)), n_layers=n_layers)
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)), n_layers=n_layers)
    tree = jax.tree_util.tree_map_with_path(_draw(np.random.default_rng(0)),
                                            JT.abstract_params(j_cfg, jnp.float32))
    return j_cfg, tree, cfg, params_from_jax(tree, device="cpu")


def batch_np(cfg, rows, seed):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (rows, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (rows, S)).astype(np.int32)}
    batch["labels"][::3, :2] = -100
    return batch


def torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _rebuild(params, flat):
    """``params``' structure with the leaves of ``flat`` in tree_leaves order."""
    it = iter(flat)
    return tree_map(lambda _: next(it), params)


def port_loss_and_grads(params, batch, cfg):
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_()
    loss = T.loss_fn(params, torch_batch(batch), cfg, remat=False)
    grads = torch.autograd.grad(loss, leaves)
    for x in leaves:
        x.requires_grad_(False)
    return loss, params_to_numpy(_rebuild(params, grads))


def prompt(cfg):
    return np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)


# ---------------------------------------------------------------------------
# The config, the init and the cache layout
# ---------------------------------------------------------------------------

def test_config_equals_reference():
    got, want = dataclasses.asdict(get_config(ARCH)), dataclasses.asdict(j_get_config(ARCH))
    assert got == want
    assert dataclasses.asdict(smoke_config(ARCH)) == dataclasses.asdict(
        j_smoke_config(j_get_config(ARCH)))
    cfg = get_config(ARCH)
    assert (cfg.attn_kind, cfg.kv_lora_rank, cfg.qk_rope_dim, cfg.v_head_dim, cfg.n_experts,
            cfg.experts_per_token, cfg.n_shared_experts) == ("mla", 512, 64, 128, 160, 6, 2)


def test_init_and_cache_layouts_match_reference_at_full_width():
    """One layer on the meta device (nothing allocated, no generator) has the
    reference's leaves and shapes, and the cache spec its layout."""
    cfg, j_cfg = get_config(ARCH), j_get_config(ARCH)
    layer = T.init_layer(None, cfg, device="meta")
    want = jax.tree.map(lambda a: a.shape[1:], JT.abstract_params(j_cfg)["layers"])
    assert jax.tree.map(lambda t: tuple(t.shape), layer) == want
    assert set(layer["attn"]) == {"w_dkv", "w_kpe", "w_uk", "w_uv", "w_q", "w_o"}
    cache = T.init_cache(cfg, 4, 1056)
    j_cache = JT.init_cache(j_cfg, 4, 1056)
    assert set(cache) == set(j_cache) == {"len", "c_kv", "k_pe"}
    for name in ("c_kv", "k_pe"):
        assert tuple(cache[name].shape) == j_cache[name].shape
    assert tuple(cache["c_kv"].shape) == (60, 4, 1056, 512)


# ---------------------------------------------------------------------------
# The MLA branch of _attention_block
# ---------------------------------------------------------------------------

def test_attention_block_and_its_grads_match_reference():
    """fp32 output and the gradients of a random cotangent with respect to
    the input and every MLA weight; the cache entries are the latent and the
    post-RoPE shared key."""
    j_cfg, tree, cfg, params = model()
    p = {k: np.asarray(v[0]) for k, v in tree["layers"]["attn"].items()}
    x = np.random.default_rng(3).standard_normal((2, S, cfg.d_model)).astype(np.float32)
    ct = np.random.default_rng(4).standard_normal(x.shape).astype(np.float32)

    def value_and_vjp(xx, pp, c):
        o, vjp = jax.vjp(lambda a, b: JT._attention_block(a, b, j_cfg, kv_chunk=8), xx, pp)
        return o, vjp(c)

    out, (want_dx, want_dp) = run_jitted(value_and_vjp, x, p, ct)
    xt = torch.from_numpy(x).requires_grad_()
    pt = {k: torch.from_numpy(v).requires_grad_() for k, v in p.items()}
    got, entries = T._attention_block(xt, pt, cfg)
    np.testing.assert_allclose(npf(got), np.asarray(out), rtol=1e-5, atol=1e-5)
    assert tuple(entries["c_kv"].shape) == (2, S, cfg.kv_lora_rank)
    assert tuple(entries["k_pe"].shape) == (2, S, cfg.qk_rope_dim)
    np.testing.assert_allclose(npf(entries["c_kv"]), x @ p["w_dkv"], rtol=1e-5, atol=1e-5)
    names = sorted(pt)
    grads = torch.autograd.grad(got, [xt] + [pt[k] for k in names], torch.from_numpy(ct))
    assert worst_rel(want_dx, grads[0]) < 5e-3
    assert worst_rel([want_dp[k] for k in names], list(grads[1:])) < 5e-3


# ---------------------------------------------------------------------------
# The model: loss and grads, prefill and decode
# ---------------------------------------------------------------------------

@functools.cache
def reference():
    """The reference's loss and grads on ``batch_np(cfg, B, 1)``, its serving
    logits (prefill's last position, then ``GEN`` greedy decode steps) and
    its ``c_kv``/``k_pe`` caches after the prefill and after the last step,
    in one jitted program."""
    j_cfg, tree, cfg, _ = model()

    def run(p, bt, toks):
        loss, grads = jax.value_and_grad(lambda q: JT.loss_fn(
            q, bt, j_cfg, remat=False, xent_chunk=8, kv_chunk=8))(p)
        x, cache = JT.prefill(p, {"tokens": toks}, j_cfg, MAX_LEN, dtype=jnp.float32)
        logits = (x[:, -1] @ JT.lm_head_weights(p, j_cfg)).astype(jnp.float32)

        def step(carry, _):
            lg, c = carry
            lg, c = JT.decode_step(p, c, jnp.argmax(lg, axis=-1).astype(jnp.int32), j_cfg)
            return (lg, c), lg

        (_, last), steps = jax.lax.scan(step, (logits, cache), None, length=GEN)
        return loss, grads, logits, steps, cache, last

    loss, grads, first, steps, cache, last = run_jitted(run, tree, batch_np(cfg, B, 1),
                                                        prompt(cfg))
    caches = [{k: np.asarray(c[k]) for k in ("c_kv", "k_pe")} for c in (cache, last)]
    return (float(loss), jax.tree.map(np.asarray, grads),
            [np.asarray(first)] + list(np.asarray(steps)), caches)


def test_loss_and_grads_match_reference():
    _, _, cfg, params = model()
    want_loss, want_grads, _, _ = reference()
    loss, got = port_loss_and_grads(params, batch_np(cfg, B, 1), cfg)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-4)
    assert jax.tree.structure(got) == jax.tree.structure(want_grads)
    assert worst_rel(want_grads, got) < 5e-3


def _serve(params, cfg):
    """The port's prefill of ``prompt`` and ``GEN`` greedy decode steps: the
    logits of each, the tokens fed and the caches after the prefill and
    after the last step."""
    logits, cache = build_prefill_step(cfg, MAX_LEN)(
        params, {"tokens": torch.from_numpy(prompt(cfg))})
    after_prefill = {k: cache[k].clone() for k in ("c_kv", "k_pe")}
    decode = build_decode_step(cfg)
    got, fed = [logits], []
    for _ in range(GEN):
        fed.append(logits.argmax(dim=-1))
        logits, cache = decode(params, cache, fed[-1])
        got.append(logits)
    assert cache["len"] == prompt(cfg).shape[1] + GEN
    return got, fed, [after_prefill, {k: cache[k] for k in ("c_kv", "k_pe")}]


def test_prefill_and_decode_match_reference():
    _, _, cfg, params = model()
    _, _, want, want_caches = reference()
    got, _, caches = _serve(params, cfg)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)
    for c, w in zip(caches, want_caches, strict=True):
        assert {k: tuple(v.shape) for k, v in c.items()} == {k: v.shape for k, v in w.items()}
        for k in w:
            np.testing.assert_allclose(c[k].numpy(), w[k], rtol=1e-4, atol=1e-4)


def test_absorbed_decode_equals_teacher_forced_prefill():
    """The decode's logits equal the last ``GEN`` + 1 positions of one
    prefill over the prompt and the fed tokens, and its cache the prefill's:
    the absorbed decode and the materialised prefill compute one function."""
    _, _, cfg, params = model()
    got, fed, caches = _serve(params, cfg)
    tokens = torch.cat([torch.from_numpy(prompt(cfg))] + [f[:, None] for f in fed], dim=1)
    with torch.inference_mode():
        x, cache = T.prefill(params, {"tokens": tokens}, cfg, MAX_LEN, dtype=torch.float32)
        want = (x[:, -GEN - 1:] @ T.lm_head_weights(params, cfg)).float()
    np.testing.assert_allclose(torch.stack(got, 1).numpy(), want.numpy(), rtol=1e-4, atol=1e-4)
    s = tokens.shape[1]
    for k in ("c_kv", "k_pe"):
        np.testing.assert_allclose(caches[1][k][:, :, :s].numpy(), cache[k][:, :, :s].numpy(),
                                   rtol=1e-4, atol=1e-4)
        assert not cache[k][:, :, s:].any()


# ---------------------------------------------------------------------------
# The ring (4 layers, N = 4) against the port's single program
# ---------------------------------------------------------------------------

def _lora_single_program(params, adapters, batch, cfg):
    """Loss and adapter grads of the port's single program on the merged
    weights."""
    leaves = tree_leaves(adapters)
    for x in leaves:
        x.requires_grad_()
    loss = T.loss_fn(lora.merge_params(params, adapters, LCFG), torch_batch(batch), cfg,
                     remat=False)
    grads = torch.autograd.grad(loss, leaves)
    for x in leaves:
        x.requires_grad_(False)
    return loss, _rebuild(adapters, grads)


@pytest.mark.parametrize("mode", ["dense", "lora"])
def test_ring_matches_single_program(mode):
    _, _, cfg, params = model(RING_LAYERS)
    batch = batch_np(cfg, B, 5)
    if mode == "dense":
        want_loss, want = port_loss_and_grads(params, batch, cfg)
        fn = dispatch.build_roundpipe_grads_fn(cfg, N, plan.plan_from_config(cfg, N),
                                               xent_chunk=8, kv_chunk=8)
        grads, loss, tokens = fn(dispatch.pad_pool(params, cfg, N), torch_batch(batch))
        assert int(tokens) == int((batch["labels"] != -100).sum())
        got = params_to_numpy(grads)
    else:
        gen = torch.Generator().manual_seed(6)
        # B away from its zero init, or every A grad is exactly zero
        adapters = tree_map(lambda a: torch.randn(a.shape, generator=gen) * 0.05,
                            lora.init_adapters(gen, params["layers"], LCFG))
        assert lora.target_leaf_paths(params["layers"], LCFG) == MLA_LEAVES
        want_loss, want = _lora_single_program(params, adapters, batch, cfg)
        want = params_to_numpy({"lora": want})["lora"]
        fn = dispatch.build_roundpipe_grads_fn(cfg, N, plan.plan_from_config(cfg, N, lora=LCFG),
                                               xent_chunk=8, kv_chunk=8, lora=LCFG)
        grads, loss, _ = fn(dispatch.pad_pool(dict(params, lora=adapters), cfg, N),
                            torch_batch(batch))
        assert set(grads) == {"lora"}
        got = params_to_numpy(grads)["lora"]
    np.testing.assert_allclose(npf(loss), npf(want_loss), rtol=1e-4)
    assert worst_rel(want, got) < 5e-3


# ---------------------------------------------------------------------------
# Counts, LoRA targets and the cost model at full width
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", [ARCH, "qwen3-1.7b", "qwen3-235b"])
def test_param_counts_match_reference(arch):
    cfg, j_cfg = get_config(arch), j_get_config(arch)
    assert T.param_count(cfg) == JT.param_count(j_cfg)
    assert T.active_param_count(cfg) == JT.active_param_count(j_cfg)
    if arch == ARCH:
        assert round(T.param_count(cfg) / 1e9, 1) == 244.2


def test_lora_targets_and_layer_costs_match_reference():
    """The attention only (an MoE layer has no ``mlp`` leaf), and of MLA's
    attention only the matrices: w_dkv, w_kpe and w_o (the reference adapts
    stacked rank-3 leaves, so w_q, w_uk and w_uv stay frozen); the adapter
    count per layer; the cost model dense, quantized and under LoRA."""
    cfg, j_cfg = get_config(ARCH), j_get_config(ARCH)
    targets = lora.applicable_targets(cfg)
    assert targets == j_lora.applicable_targets(j_cfg) == ("attn",)
    lcfg, j_lcfg = lora.LoraConfig(target_modules=targets), j_lora.LoraConfig(
        target_modules=targets)
    layer = T.init_layer(None, cfg, device="meta")
    assert lora.target_leaf_paths(layer, lcfg) == MLA_LEAVES
    assert j_lora.target_leaf_paths(JT.abstract_params(j_cfg)["layers"], j_lcfg) == MLA_LEAVES
    assert lora.adapter_params_per_layer(cfg, lcfg) == j_lora.adapter_params_per_layer(
        j_cfg, j_lcfg)

    def costs(mod, c, **kw):
        return [dataclasses.asdict(x) for x in mod.default_layer_costs(c, **kw)]

    for kw, j_kw in (({}, {}), ({"pool_dtype": "int4"}, {"pool_dtype": "int4"}),
                     ({"lora": lcfg}, {"lora": j_lcfg})):
        assert costs(plan, cfg, **kw) == costs(j_plan, j_cfg, **j_kw)


@pytest.mark.parametrize("launcher", ["serve", "train"])
def test_launchers_take_deepseek_on_the_cpu(launcher, capsys):
    """The smoke deepseek through the serve launcher, and through the train
    launcher on the ring (N = 4) with LoRA over the attention: finite
    outputs, a frozen base."""
    if launcher == "serve":
        out = serve.main(["--arch", ARCH, "--smoke", "--device", "cpu", "--batch", "2",
                          "--prompt-len", "8", "--gen", "3"])
        assert tuple(out.tokens.shape) == (2, 3)
        assert all(bool(torch.isfinite(lg).all()) for lg in out.logits)
        return
    out = train.main(["--arch", ARCH, "--smoke", "--strategy", "roundpipe", "--mesh", "1x4",
                      "--steps", "2", "--batch", "8", "--seq", "16", "--lora-rank", "4",
                      "--lora-targets", "attn", "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert "LoRA r=4" in capsys.readouterr().out
    paths = lora.target_leaf_paths(out["state"]["params"]["layers"], LCFG)
    assert paths == MLA_LEAVES
