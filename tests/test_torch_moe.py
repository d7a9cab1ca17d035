"""The Mixture-of-Experts family of the port against the JAX reference, on
the CPU.

mixtral-8x7b (8 experts top-2, window 4096), gpt-oss-20b (32 experts top-4,
64 query heads over 8 kv heads of 64) and qwen3-235b (128 experts top-8):
each copied config equals the reference's field by field. ``moe_block``
equals the reference's on numpy-seeded inputs, with its gradients, with
dropped assignments (capacity factor 1), without, and with one shared
expert; in bf16 it lies no farther from fp32 than the reference's does.
``expert_capacity`` and ``aux_load_balance_loss`` equal the reference's. At
smoke width each arch's loss and grads equal ``jax.value_and_grad`` of the
reference's ``loss_fn`` and its prefill and decode equal the reference's;
the ``MOE_CHUNK_TOKENS`` path (set small in both modules) equals the
reference's chunked one. A 4-layer mixtral ring (N = 4), dense and LoRA
(the attention only: experts and router stay frozen), equals the single
program. ``applicable_targets``, ``adapter_params_per_layer`` and
``default_layer_costs`` equal the reference's on the five configs this
slice adds.

Weights fill the reference's tree (``abstract_params``) from a numpy seed and
cross by ``params_from_jax``. Bars: loss rtol 1e-4, grads worst relative
< 5e-3, fp32 serving logits 1e-4.
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
from repro.models import moe as j_moe
from repro.models import transformer as JT
from repro.models.config import get_config as j_get_config
from repro_torch.configs import smoke_config
from repro_torch.core import dispatch, plan
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import lora, moe
from repro_torch.models import transformer as T
from repro_torch.models.config import ModelConfig, get_config
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


MOE = ["mixtral-8x7b", "gpt-oss-20b", "qwen3-235b"]
NEW = MOE + ["internvl2-76b", "hubert-xlarge"]
N, B, S = 4, 8, 16
RING_LAYERS = 4
J_LCFG = j_lora.LoraConfig(rank=4, alpha=8.0, target_modules=("attn",))
LCFG = lora.LoraConfig(rank=4, alpha=8.0, target_modules=("attn",))


def npf(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def worst_rel(ref_tree, got_tree):
    """max over leaves of |got - ref|_inf / (|ref|_inf + 1e-6), as the harness."""
    ref_l, got_l = jax.tree.leaves(ref_tree), jax.tree.leaves(got_tree)
    assert len(ref_l) == len(got_l)
    return max(float(np.abs(npf(g) - npf(r)).max() / (np.abs(npf(r)).max() + 1e-6))
               for r, g in zip(ref_l, got_l))


def rel(a, b):
    return float(np.linalg.norm(npf(a) - npf(b)) / np.linalg.norm(npf(b)))


def run_jitted(fn, *args):
    """``fn(*args)`` compiled once by XLA at backend optimisation level 0
    (at smoke width the full level's compile takes longer than the run)."""
    return jax.jit(fn).lower(*args).compile(
        compiler_options={"xla_backend_optimization_level": 0})(*args)


def _draw(rng):
    def draw(path, a):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(a.shape).astype(np.float32)
        if "scale" in name:
            return 1.0 + 0.1 * x
        if "bias" in name:
            return 0.1 * x
        return x / np.float32(np.sqrt(a.shape[-1] if "embed" in name else a.shape[-2]))
    return draw


@functools.cache
def model(arch, n_layers=None, capacity_factor=None):
    """(reference config, reference fp32 weights as numpy, port config, port
    weights) at smoke width, optionally at another depth or capacity factor:
    N(0, 1/fan_in) matrices (experts by their own fan-in) and embeddings,
    norm scales near 1."""
    extra = {k: v for k, v in (("n_layers", n_layers), ("capacity_factor", capacity_factor))
             if v is not None}
    j_cfg = dataclasses.replace(j_smoke_config(j_get_config(arch)), **extra)
    cfg = dataclasses.replace(smoke_config(get_config(arch)), **extra)
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

    def walk(node):
        if isinstance(node, dict):
            return {k: walk(v) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v) for v in node]
        return next(it)

    return walk(params)


def port_loss_and_grads(params, batch, cfg):
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_()
    loss = T.loss_fn(params, torch_batch(batch), cfg, remat=False)
    grads = torch.autograd.grad(loss, leaves)
    for x in leaves:
        x.requires_grad_(False)
    return loss, params_to_numpy(_rebuild(params, grads))


def reference_loss_and_grads(j_cfg, tree, batch):
    return run_jitted(jax.value_and_grad(lambda p, bt: JT.loss_fn(
        p, bt, j_cfg, remat=False, xent_chunk=8, kv_chunk=8)), tree, batch)


# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", MOE)
def test_config_equals_reference(arch):
    got, want = dataclasses.asdict(get_config(arch)), dataclasses.asdict(j_get_config(arch))
    assert got == want
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(
        j_smoke_config(j_get_config(arch)))


def test_the_moe_configs_shapes():
    shape = {a: (c.n_layers, c.d_model, c.n_heads, c.n_kv_heads, c.d_head, c.n_experts,
                 c.experts_per_token, c.moe_d_ff, c.sliding_window, c.capacity_factor)
             for a in MOE for c in [get_config(a)]}
    assert shape == {"mixtral-8x7b": (32, 4096, 32, 8, 128, 8, 2, 14336, 4096, 1.25),
                     "gpt-oss-20b": (24, 2880, 64, 8, 64, 32, 4, 2880, None, 1.25),
                     "qwen3-235b": (94, 4096, 64, 4, 128, 128, 8, 1536, None, 1.25)}


# ---------------------------------------------------------------------------
# moe_block
# ---------------------------------------------------------------------------

def _block_case(case):
    """A smoke MoE config, its reference and port MoE weights and (T, D)
    tokens, all from numpy seeds."""
    extra = {"drops": {"capacity_factor": 1.0}, "no_drops": {},
             "shared": {"n_shared_experts": 1, "capacity_factor": 1.0}}[case]
    j_cfg = dataclasses.replace(j_smoke_config(j_get_config("mixtral-8x7b")), **extra)
    cfg = ModelConfig(**dataclasses.asdict(j_cfg))
    shape = jax.eval_shape(lambda: j_moe.init_moe(jax.random.PRNGKey(0), j_cfg, jnp.float32))
    p = jax.tree_util.tree_map_with_path(_draw(np.random.default_rng(1)), shape)
    x = np.random.default_rng(2).standard_normal((128, j_cfg.d_model)).astype(np.float32)
    return j_cfg, cfg, p, x


def _assignments_dropped(cfg, p, x):
    """How many (token, choice) assignments exceed their expert's capacity."""
    logits = torch.from_numpy(x) @ torch.from_numpy(np.asarray(p["router"]))
    top = torch.topk(logits, cfg.experts_per_token, dim=-1).indices.reshape(-1)
    cap = moe.expert_capacity(x.shape[0], cfg.n_experts, cfg.experts_per_token,
                              cfg.capacity_factor)
    return int((torch.bincount(top, minlength=cfg.n_experts) - cap).clamp(min=0).sum())


@pytest.mark.parametrize("case", ["drops", "no_drops", "shared"])
def test_moe_block_matches_reference(case):
    """Output and the gradients of a random cotangent with respect to the
    tokens and every weight, fp32."""
    j_cfg, cfg, p, x = _block_case(case)
    dropped = _assignments_dropped(cfg, p, x)
    assert (dropped > 0) == (case != "no_drops"), dropped
    assert ("shared" in p) == (case == "shared")
    ct = np.random.default_rng(3).standard_normal(x.shape).astype(np.float32)

    def value_and_vjp(xx, pp, c):
        o, vjp = jax.vjp(lambda a, b: j_moe.moe_block(a, b, j_cfg), xx, pp)
        return o, vjp(c)

    out, (want_dx, want_dp) = run_jitted(value_and_vjp, x, p, ct)
    xt = torch.from_numpy(x).requires_grad_()
    pt = jax.tree.map(lambda a: torch.from_numpy(np.asarray(a)).requires_grad_(), p)
    got = moe.moe_block(xt, pt, cfg)
    leaves = jax.tree.leaves(pt)
    grads = torch.autograd.grad(got, [xt] + leaves, torch.from_numpy(ct))
    np.testing.assert_allclose(npf(got), np.asarray(out), rtol=1e-5, atol=1e-5)
    assert worst_rel(want_dx, grads[0]) < 5e-3
    assert worst_rel(want_dp, jax.tree.unflatten(jax.tree.structure(pt), grads[1:])) < 5e-3


def test_moe_block_bf16_lies_no_farther_from_fp32_than_the_reference():
    """bf16 tokens and weights (the same values in fp32 give the truth): the
    port's output is no farther from the fp32 output than the reference's
    bf16 output is, within 1.25x for the two libraries' operation orders. A
    near-tie in the router can route a token differently on either side, so
    the outputs are held by distance, not element by element."""
    j_cfg, cfg, p, x = _block_case("drops")
    p16 = jax.tree.map(lambda a: jnp.asarray(a, jnp.bfloat16), p)
    x16 = jnp.asarray(x, jnp.bfloat16)
    up = jax.tree.map(lambda a: np.asarray(a, np.float32), p16)
    truth = np.asarray(j_moe.moe_block(np.asarray(x16, np.float32), up, j_cfg))
    ref_gap = rel(np.asarray(j_moe.moe_block(x16, p16, j_cfg), np.float32), truth)
    to_bf16 = lambda a: torch.from_numpy(np.asarray(a, np.float32)).to(torch.bfloat16)  # noqa: E731
    port = moe.moe_block(to_bf16(x16), jax.tree.map(to_bf16, p16), cfg)
    port32 = moe.moe_block(torch.from_numpy(np.asarray(x16, np.float32)),
                           jax.tree.map(torch.from_numpy, up), cfg)
    assert port.dtype == torch.bfloat16
    np.testing.assert_allclose(npf(port32), truth, rtol=1e-5, atol=1e-5)
    assert ref_gap > 1e-3, "the reference's bf16 run did not run in bf16"
    assert rel(port, truth) <= 1.25 * ref_gap, (rel(port, truth), ref_gap)


def test_expert_capacity_and_aux_loss_match_reference():
    for t, e, k, cf in [(1, 8, 2, 1.25), (4, 32, 4, 1.25), (4096, 32, 4, 1.25), (7, 4, 2, 4.0),
                        (2048, 128, 8, 1.0)]:
        assert moe.expert_capacity(t, e, k, cf) == j_moe.expert_capacity(t, e, k, cf)
    j_cfg, cfg, p, x = _block_case("drops")
    want = j_moe.aux_load_balance_loss(x, p["router"], j_cfg)
    got = moe.aux_load_balance_loss(torch.from_numpy(x), torch.from_numpy(np.asarray(p["router"])),
                                    cfg)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


# ---------------------------------------------------------------------------
# The model: loss and grads, prefill and decode, the chunked path
# ---------------------------------------------------------------------------

GEN, MAX_LEN = 3, 12


def prompt(cfg):
    return np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)


@functools.cache
def reference(arch):
    """The reference's loss and grads on ``batch_np(cfg, B, 1)`` and its
    serving logits (prefill's last position, then ``GEN`` greedy decode
    steps), in one jitted program."""
    j_cfg, tree, cfg, _ = model(arch)

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

    loss, grads, first, steps = run_jitted(run, tree, batch_np(cfg, B, 1), prompt(cfg))
    return (float(loss), jax.tree.map(np.asarray, grads),
            [np.asarray(first)] + list(np.asarray(steps)))


@pytest.mark.parametrize("arch", MOE)
def test_loss_and_grads_match_reference(arch):
    _, _, cfg, params = model(arch)
    want_loss, want_grads, _ = reference(arch)
    loss, got = port_loss_and_grads(params, batch_np(cfg, B, 1), cfg)
    np.testing.assert_allclose(loss.item(), want_loss, rtol=1e-4)
    assert jax.tree.structure(got) == jax.tree.structure(want_grads)
    assert worst_rel(want_grads, got) < 5e-3


@pytest.mark.parametrize("arch", MOE)
def test_prefill_and_decode_match_reference(arch):
    _, _, cfg, params = model(arch)
    want = reference(arch)[2]
    logits, cache = build_prefill_step(cfg, MAX_LEN)(
        params, {"tokens": torch.from_numpy(prompt(cfg))})
    decode = build_decode_step(cfg)
    got = [logits]
    for _ in range(GEN):
        logits, cache = decode(params, cache, logits.argmax(dim=-1))
        got.append(logits)
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


def test_chunked_dispatch_matches_reference(monkeypatch):
    """``MOE_CHUNK_TOKENS`` set to 48 in both modules: a batch of 8 x 16
    = 128 tokens routes in three chunks, the last padded with 16 zero
    tokens, each with its own capacity. At capacity factor 1 the chunks drop
    other assignments than one dispatch of all 128 would, so the loss moves
    off the unchunked one; the port's chunked loss and grads equal the
    reference's chunked ones."""
    j_cfg, tree, cfg, params = model("mixtral-8x7b", capacity_factor=1.0)
    batch = batch_np(cfg, B, 4)
    whole, _ = port_loss_and_grads(params, batch, cfg)
    monkeypatch.setattr(JT, "MOE_CHUNK_TOKENS", 48)
    monkeypatch.setattr(T, "MOE_CHUNK_TOKENS", 48)
    want_loss, want_grads = reference_loss_and_grads(j_cfg, tree, batch)
    calls = []
    real = T.moe_block
    monkeypatch.setattr(T, "moe_block", lambda *a: calls.append(a[0].shape[0]) or real(*a))
    loss, got = port_loss_and_grads(params, batch, cfg)
    assert calls == [48, 48, 48] * cfg.n_layers
    assert abs(loss.item() - whole.item()) > 1e-4 * abs(whole.item())
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    assert worst_rel(want_grads, got) < 5e-3


# ---------------------------------------------------------------------------
# The ring (mixtral-8x7b, 4 layers, N = 4)
# ---------------------------------------------------------------------------

def test_mixtral_ring_matches_single_program():
    j_cfg, tree, cfg, params = model("mixtral-8x7b", n_layers=RING_LAYERS)
    batch = batch_np(cfg, B, 5)
    want_loss, want_grads = reference_loss_and_grads(j_cfg, tree, batch)
    fn = dispatch.build_roundpipe_grads_fn(cfg, N, plan.plan_from_config(cfg, N), xent_chunk=8,
                                           kv_chunk=8)
    grads, loss, tokens = fn(dispatch.pad_pool(params, cfg, N), torch_batch(batch))
    assert int(tokens) == int((batch["labels"] != -100).sum())
    assert len(grads["layers"]) == RING_LAYERS and "moe" in grads["layers"][0]
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert worst_rel(want_grads, params_to_numpy(grads)) < 5e-3


def test_mixtral_lora_ring_matches_merged_single_program():
    j_cfg, tree, cfg, _ = model("mixtral-8x7b", n_layers=RING_LAYERS)
    shape = jax.eval_shape(lambda: j_lora.init_adapters(
        jax.random.PRNGKey(3), tree["layers"], J_LCFG, dtype=jnp.float32))
    rng = np.random.default_rng(6)
    j_ad = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
                        shape)
    batch = batch_np(cfg, B, 7)
    want_loss, want_grads = run_jitted(jax.value_and_grad(lambda ad, p, bt: JT.loss_fn(
        j_lora.merge_params(p, ad, J_LCFG), bt, j_cfg, remat=False, xent_chunk=8,
        kv_chunk=8)), j_ad, tree, batch)
    params = dispatch.pad_pool(params_from_jax(dict(tree, lora=j_ad), device="cpu"), cfg, N)
    assert set(params["lora"][0]) == {"attn"}
    fn = dispatch.build_roundpipe_grads_fn(cfg, N, plan.plan_from_config(cfg, N, lora=LCFG),
                                           xent_chunk=8, kv_chunk=8, lora=LCFG)
    grads, loss, _ = fn(params, torch_batch(batch))
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert worst_rel(want_grads, params_to_numpy(grads)["lora"]) < 5e-3


# ---------------------------------------------------------------------------
# LoRA targets and the cost model on the new configs
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", NEW)
def test_lora_targets_and_layer_costs_match_reference(arch):
    """At full width: the default targets that apply (the attention only on
    the MoE configs), the adapter count per layer, and the cost model dense,
    quantized and under LoRA."""
    j_cfg, cfg = j_get_config(arch), get_config(arch)
    targets = lora.applicable_targets(cfg)
    assert targets == j_lora.applicable_targets(j_cfg)
    assert targets == (("attn",) if cfg.is_moe else ("attn", "mlp"))
    lcfg, j_lcfg = lora.LoraConfig(target_modules=targets), j_lora.LoraConfig(
        target_modules=targets)
    assert lora.adapter_params_per_layer(cfg, lcfg) == j_lora.adapter_params_per_layer(
        j_cfg, j_lcfg)

    def costs(mod, c, **kw):
        return [dataclasses.asdict(x) for x in mod.default_layer_costs(c, **kw)]

    for kw, j_kw in (({}, {}), ({"pool_dtype": "int4"}, {"pool_dtype": "int4"}),
                     ({"lora": lcfg}, {"lora": j_lcfg})):
        assert costs(plan, cfg, **kw) == costs(j_plan, j_cfg, **j_kw)
