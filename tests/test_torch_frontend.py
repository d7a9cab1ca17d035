"""The ``embeds`` front end of the port against the JAX reference, on the CPU.

internvl2-76b (a stubbed vision front end over a llama-class decoder) and
hubert-xlarge (a stubbed audio front end: encoder-only, bidirectional,
LayerNorm, GELU, no RoPE, a 504-unit head): each copied config equals the
reference's field by field; at smoke width each arch's loss and grads on an
embeds batch equal ``jax.value_and_grad`` of the reference's ``loss_fn``
(hubert also at its true head dim, 80); internvl2's prefill from embeds and
its decode from tokens and from (B,1,D) embeds equal the reference's. The
ring takes embeds batches (hubert, 4 layers, N = 4): one round, two rounds
and frozen-base LoRA r = 4 against the single program, and the chained
staleness-1 driver at K = 2 against ``reference_staleness1`` driven by the
reference's program and optimizer, and two steps of
``build_roundpipe_train_step`` on embeds batches. The embedding table gets a
zero gradient throughout, as in the reference. The serve launcher serves
internvl2 from embeds and refuses hubert (no decode path); the train
launcher refuses both by name (its dataset makes tokens, as the reference
launcher's does).

Weights fill the reference's tree (``abstract_params``) from a numpy seed and
cross by ``params_from_jax``; embeds and labels come from numpy seeds. Bars:
loss rtol 1e-4, grads worst relative < 5e-3, fp32 serving logits 1e-4.
"""
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core import consistency as j_consistency
from repro.models import lora as j_lora
from repro.models import transformer as JT
from repro.models.config import get_config as j_get_config
from repro.optim import OptConfig as JOptConfig
from repro.optim import apply_updates as j_apply_updates
from repro.optim import init_opt_state as j_init_opt_state
from repro_torch.configs import smoke_config
from repro_torch.core import dispatch, plan
from repro_torch.launch import serve, train
from repro_torch.launch.steps import StepConfig, build_decode_step, build_prefill_step
from repro_torch.models import lora
from repro_torch.models import transformer as T
from repro_torch.models.config import get_config
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.optim import OptConfig, init_opt_state
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


ARCHS = ["internvl2-76b", "hubert-xlarge"]
N, B, S = 4, 8, 16
RING_LAYERS = 4
LR = 1e-2
J_LCFG, LCFG = j_lora.LoraConfig(rank=4, alpha=8.0), lora.LoraConfig(rank=4, alpha=8.0)


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


@functools.cache
def model(arch, d_head=None, n_layers=None):
    """(reference config, reference fp32 weights as numpy, port config, port
    weights) at smoke width, optionally at another head dim or depth:
    N(0, 1/fan_in) matrices and embeddings, norm scales near 1, biases near 0."""
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


def embeds_batch(cfg, rows, seed, steps=None):
    """Front-end embeds (rows, S, D) and labels (rows, S), a leading
    ``steps`` axis when given; every third sequence's first two labels -100."""
    rng = np.random.default_rng(seed)
    lead = (rows,) if steps is None else (steps, rows)
    batch = {"embeds": rng.standard_normal(lead + (S, cfg.d_model)).astype(np.float32),
             "labels": rng.integers(0, cfg.vocab_size, lead + (S,)).astype(np.int32)}
    batch["labels"][..., ::3, :2] = -100
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


def single_program_grads(params, batch, cfg):
    """The port's single program: loss and grads of ``T.loss_fn`` by
    autograd; the unused embedding table gets zeros."""
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_()
    loss = T.loss_fn(params, torch_batch(batch), cfg, remat=False)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True)
    for x in leaves:
        x.requires_grad_(False)
    grads = [torch.zeros_like(x) if g is None else g for x, g in zip(leaves, grads)]
    return loss, _rebuild(params, grads)


@pytest.mark.parametrize("arch", ARCHS)
def test_config_equals_reference(arch):
    got, want = dataclasses.asdict(get_config(arch)), dataclasses.asdict(j_get_config(arch))
    assert got == want
    assert dataclasses.asdict(smoke_config(arch)) == dataclasses.asdict(
        j_smoke_config(j_get_config(arch)))


def test_the_front_end_configs_shapes():
    vlm, audio = get_config("internvl2-76b"), get_config("hubert-xlarge")
    assert (vlm.n_layers, vlm.d_model, vlm.n_heads, vlm.n_kv_heads, vlm.d_head, vlm.d_ff,
            vlm.vocab_size, vlm.tie_embeddings, vlm.frontend) == (
        80, 8192, 64, 8, 128, 28672, 128256, False, "vision")
    assert (audio.n_layers, audio.d_model, audio.n_heads, audio.d_head, audio.d_ff,
            audio.vocab_size, audio.norm_kind, audio.rope, audio.causal,
            audio.encoder_only) == (48, 1280, 16, 80, 5120, 504, "layernorm", False, False,
                                    True)


@pytest.mark.parametrize("arch,d_head", [("internvl2-76b", None), ("hubert-xlarge", None),
                                         ("hubert-xlarge", 80)])
def test_loss_and_grads_on_embeds_match_reference(arch, d_head):
    j_cfg, tree, cfg, params = model(arch, d_head)
    batch = embeds_batch(cfg, B, seed=1)
    want_loss, want_grads = run_jitted(jax.value_and_grad(lambda p, bt: JT.loss_fn(
        p, bt, j_cfg, remat=False, xent_chunk=8, kv_chunk=8)), tree, batch)
    loss, grads = single_program_grads(params, batch, cfg)
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-4)
    assert not np.asarray(want_grads["embed"]).any()
    got = params_to_numpy(grads)
    assert jax.tree.structure(got) == jax.tree.structure(jax.tree.map(np.asarray, want_grads))
    assert worst_rel(want_grads, got) < 5e-3


GEN, MAX_LEN = 3, 12


def test_internvl2_prefill_from_embeds_and_decode_match_reference():
    """Prefill from (2, 8, D) embeds, then GEN greedy token steps, then one
    step from (B,1,D) embeds: every logit against the reference's."""
    j_cfg, tree, cfg, params = model("internvl2-76b")
    rng = np.random.default_rng(2)
    prompt = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    step_embeds = rng.standard_normal((2, 1, cfg.d_model)).astype(np.float32)

    def run(p, emb, last):
        x, cache = JT.prefill(p, {"embeds": emb}, j_cfg, MAX_LEN, dtype=jnp.float32)
        logits = (x[:, -1] @ JT.lm_head_weights(p, j_cfg)).astype(jnp.float32)

        def step(carry, _):
            lg, c = carry
            lg, c = JT.decode_step(p, c, jnp.argmax(lg, axis=-1).astype(jnp.int32), j_cfg)
            return (lg, c), lg

        (lg, cache), steps = jax.lax.scan(step, (logits, cache), None, length=GEN)
        emb_logits, _ = JT.decode_step(p, cache, last, j_cfg)
        return logits, steps, emb_logits

    first, steps, emb_logits = run_jitted(run, tree, prompt, step_embeds)
    want = [np.asarray(first)] + list(np.asarray(steps)) + [np.asarray(emb_logits)]
    logits, cache = build_prefill_step(cfg, MAX_LEN)(params, {"embeds": torch.from_numpy(prompt)})
    decode = build_decode_step(cfg)
    got = [logits]
    for _ in range(GEN):
        logits, cache = decode(params, cache, logits.argmax(dim=-1))
        got.append(logits)
    logits, cache = decode(params, cache, torch.from_numpy(step_embeds))
    got.append(logits)
    assert cache["len"] == 8 + GEN + 1
    for g, w in zip(got, want, strict=True):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-4)


# ---------------------------------------------------------------------------
# The ring with embeds batches (hubert-xlarge, 4 layers, N = 4)
# ---------------------------------------------------------------------------

@functools.cache
def ring_oracle():
    j_cfg, tree, _, _ = model("hubert-xlarge", n_layers=RING_LAYERS)
    return jax.jit(jax.value_and_grad(lambda p, bt: JT.loss_fn(
        p, bt, j_cfg, remat=False, xent_chunk=8, kv_chunk=8)))


@pytest.mark.parametrize("rounds", [1, 2])
def test_ring_on_embeds_matches_single_program(rounds):
    j_cfg, tree, cfg, params = model("hubert-xlarge", n_layers=RING_LAYERS)
    batch = embeds_batch(cfg, rounds * B, seed=3 + rounds)
    want_loss, want_grads = ring_oracle()(tree, batch)
    p = plan.plan_from_config(cfg, N)
    fn = dispatch.build_roundpipe_grads_fn(cfg, N, p, xent_chunk=8, kv_chunk=8,
                                           n_microbatches=rounds * N)
    grads, loss, tokens = fn(dispatch.pad_pool(params, cfg, N), torch_batch(batch))
    assert int(tokens) == int((batch["labels"] != -100).sum())
    assert len(grads["layers"]) == RING_LAYERS and "lm_head" in grads
    assert not grads["embed"].any()
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert worst_rel(want_grads, params_to_numpy(grads)) < 5e-3


def test_lora_ring_on_embeds_matches_merged_single_program():
    j_cfg, tree, cfg, _ = model("hubert-xlarge", n_layers=RING_LAYERS)
    shape = jax.eval_shape(lambda: j_lora.init_adapters(
        jax.random.PRNGKey(3), tree["layers"], J_LCFG, dtype=jnp.float32))
    rng = np.random.default_rng(7)
    j_ad = jax.tree.map(lambda a: (rng.standard_normal(a.shape) * 0.05).astype(np.float32),
                        shape)
    batch = embeds_batch(cfg, B, seed=8)
    want_loss, want_grads = run_jitted(jax.value_and_grad(lambda ad, p, bt: JT.loss_fn(
        j_lora.merge_params(p, ad, J_LCFG), bt, j_cfg, remat=False, xent_chunk=8,
        kv_chunk=8)), j_ad, tree, batch)
    params = dispatch.pad_pool(params_from_jax(dict(tree, lora=j_ad), device="cpu"), cfg, N)
    fn = dispatch.build_roundpipe_grads_fn(cfg, N, plan.plan_from_config(cfg, N, lora=LCFG),
                                           xent_chunk=8, kv_chunk=8, lora=LCFG)
    grads, loss, _ = fn(params, torch_batch(batch))
    assert set(grads) == {"lora"}
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert worst_rel(want_grads, params_to_numpy(grads)["lora"]) < 5e-3


def test_train_step_on_embeds_leaves_the_embedding_moments_zero():
    """``build_roundpipe_train_step`` takes an embeds batch: two AdamW steps
    on the ring, finite losses, every token counted, the layers moved, and
    the embedding's first moment still zero (it never had a gradient)."""
    _, _, cfg, _ = model("hubert-xlarge", n_layers=RING_LAYERS)
    p = plan.plan_from_config(cfg, N)
    step_cfg = StepConfig(strategy="roundpipe", partition=p, kv_chunk=8, xent_chunk=8,
                          opt=OptConfig(lr=LR))
    step, _ = dispatch.build_roundpipe_train_step(cfg, N, step_cfg, B, S, plan=p)
    state = dispatch.init_roundpipe_state(torch.Generator().manual_seed(0), cfg, step_cfg,
                                          n_workers=N, dtype=torch.float32, device="cpu")
    before = state["params"]["layers"][0]["attn"]["w_q"].clone()
    for seed in (10, 11):
        batch = embeds_batch(cfg, B, seed=seed)
        state, metrics = step(state, torch_batch(batch))
        assert np.isfinite(float(metrics["loss"]))
        assert int(metrics["tokens"]) == int((batch["labels"] != -100).sum())
    assert not torch.equal(state["params"]["layers"][0]["attn"]["w_q"], before)
    assert not state["opt"]["m"]["embed"].any()


def test_chained_ring_on_embeds_matches_the_staleness1_oracle():
    """K = 2 chained steps, one round each, against ``reference_staleness1``
    with the reference's program and AdamW (learning rate 1e-2, so that
    staleness shows): losses rtol 1e-4, final weights within 5e-3 and far
    nearer the staleness-1 oracle than the staleness-0 trajectory."""
    steps = 2
    j_cfg, tree, cfg, params = model("hubert-xlarge", n_layers=RING_LAYERS)
    batches = embeds_batch(cfg, B, seed=9, steps=steps)
    oracle, ocfg = ring_oracle(), JOptConfig(lr=LR)
    ref_losses, cell = [], {"opt": j_init_opt_state(tree, ocfg)}

    def device_fn(weights, t):
        loss, grads = oracle(weights[0], {k: v[t] for k, v in batches.items()})
        ref_losses.append(float(loss))
        return [grads]

    def optimizer_fn(opt_w, staged, t):
        new, cell["opt"], _ = j_apply_updates(cell["opt"], staged[0], ocfg, param_like=tree)
        return [new]

    ref_final = j_consistency.reference_staleness1(1, device_fn, optimizer_fn, [tree], steps)[0]
    sync, opt = tree, j_init_opt_state(tree, ocfg)
    for t in range(steps):
        _, grads = oracle(sync, {k: v[t] for k, v in batches.items()})
        sync, opt, _ = j_apply_updates(opt, grads, ocfg, param_like=tree)

    p = plan.plan_from_config(cfg, N)
    step_cfg = StepConfig(strategy="roundpipe", partition=p, kv_chunk=8, xent_chunk=8,
                          opt=OptConfig(lr=LR))
    multi, _ = dispatch.build_roundpipe_async_train_step(cfg, N, step_cfg, B, S,
                                                         steps_per_call=steps, plan=p)
    padded = dispatch.pad_pool(jax.tree.map(torch.clone, params), cfg, N)
    state, metrics = multi({"params": padded, "opt": init_opt_state(padded, OptConfig(lr=LR))},
                           torch_batch(batches))
    got = params_to_numpy(state["params"])
    got["layers"] = jax.tree.map(lambda a: a[:RING_LAYERS], got["layers"])
    np.testing.assert_allclose(npf(metrics["loss"]), np.asarray(ref_losses), rtol=1e-4)
    err = worst_rel(ref_final, got)
    assert err < 5e-3, err
    assert worst_rel(sync, got) > 5 * err


# ---------------------------------------------------------------------------
# The launchers
# ---------------------------------------------------------------------------

def test_serve_launcher_serves_internvl2_from_embeds(capsys):
    out = serve.main(["--arch", "internvl2-76b", "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", "8", "--gen", "3"])
    cfg = smoke_config("internvl2-76b")
    assert out.prompts.dtype == torch.bfloat16
    assert tuple(out.prompts.shape) == (2, 8, cfg.d_model)
    assert tuple(out.tokens.shape) == (2, 3) and len(out.logits) == 4
    assert all(bool(torch.isfinite(lg).all()) for lg in out.logits)
    assert "prefill: 2x8" in capsys.readouterr().out


def test_serve_launcher_refuses_the_encoder_only_arch():
    with pytest.raises(SystemExit, match="encoder-only arch has no decode path"):
        serve.main(["--arch", "hubert-xlarge", "--smoke", "--device", "cpu"])


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_refuses_the_front_end_archs_by_name(arch):
    with pytest.raises(SystemExit, match=f"--arch {arch}: the .* front-end arch"):
        train.main(["--arch", arch, "--smoke", "--strategy", "roundpipe", "--mesh", "1x4",
                    "--steps", "1", "--device", "cpu"])
