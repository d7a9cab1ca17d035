"""The port's layers, converter and dense model against the JAX reference.

Weights come from the reference's ``init_params`` and cross through numpy
with ``params_from_jax``; other inputs come from numpy seeds. On the CPU the
port's attention runs its plain versions (the kernels run only on the card).
fp32 logits are held at rtol/atol 1e-4 (the loss bar of the reference's own
ring harness; the two frameworks sum in different orders), bf16 at 2e-2 on
the relative norm (the bf16 test says why).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import layers as JL
from repro.models import transformer as JT
from repro.models.config import get_config as j_get_config
from repro_torch.configs import smoke_config
from repro_torch.launch.steps import build_decode_step, build_prefill_step
from repro_torch.models import layers as L
from repro_torch.models import transformer as T
from repro_torch.models.config import get_config
from repro_torch.models.convert import params_from_jax, params_to_numpy


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


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def t(a):
    return torch.from_numpy(np.asarray(a, np.float32))


def close(got, want, tol):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def jax_tree(cfg, dtype):
    return jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), cfg, dtype=dtype))


# ---------------------------------------------------------------------------
# layers
# ---------------------------------------------------------------------------

def test_norms_match_reference():
    x, scale, bias = rand(0, 2, 5, 64), rand(1, 64), rand(2, 64)
    close(L.rms_norm(t(x), t(scale)), JL.rms_norm(x, scale), 1e-5)
    close(L.layer_norm(t(x), t(scale), t(bias)), JL.layer_norm(x, scale, bias), 1e-5)


def test_apply_rope_matches_reference():
    x = rand(3, 2, 9, 4, 16)
    pos = np.arange(9) + 5
    close(L.apply_rope(t(x), torch.from_numpy(pos)), JL.apply_rope(x, jnp.asarray(pos)), 1e-5)


@pytest.mark.parametrize("kind", ["swiglu", "geglu", "relu2", "gelu"])
def test_mlp_matches_reference(kind):
    x = rand(4, 2, 3, 32)
    p = {"w_up": rand(5, 32, 48) / 6, "w_down": rand(6, 48, 32) / 7, "w_gate": rand(7, 32, 48) / 6}
    if kind in ("relu2", "gelu"):
        del p["w_gate"]
    close(L.mlp(t(x), {k: t(v) for k, v in p.items()}, kind), JL.mlp(x, p, kind), 1e-5)


@pytest.mark.parametrize("kh,g,window", [(2, 2, None), (1, 4, None), (2, 1, 5)])
def test_chunked_attention_matches_reference(kh, g, window):
    q, k, v = rand(8, 2, 19, kh * g, 16), rand(9, 2, 19, kh, 16), rand(10, 2, 19, kh, 16)
    close(L.chunked_attention(t(q), t(k), t(v), sliding_window=window),
          JL.chunked_attention(q, k, v, sliding_window=window, kv_chunk=8), 2e-5)


def test_chunked_attention_refuses_an_offset():
    q = torch.zeros(1, 4, 2, 8)
    with pytest.raises(NotImplementedError, match="q_offset"):
        L.chunked_attention(q, q, q, q_offset=3)


def test_decode_attention_matches_reference():
    q, k, v = rand(11, 2, 1, 8, 16), rand(12, 2, 24, 2, 16), rand(13, 2, 24, 2, 16)
    n = np.array([24, 7], np.int32)
    close(L.decode_attention(t(q), t(k), t(v), torch.from_numpy(n)),
          JL.decode_attention(q, k, v, jnp.asarray(n)), 1e-5)


# ---------------------------------------------------------------------------
# parameters
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_params_round_trip_bit_exact(dtype):
    cfg = j_smoke_config(j_get_config(ARCH))
    tree = jax_tree(cfg, getattr(jnp, dtype))
    port = params_from_jax(tree, device="cpu")
    assert port["embed"].dtype == getattr(torch, dtype)
    back = params_to_numpy(port)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a, np.float32), b),
                 tree, back)
    again = params_from_jax(back, dtype=getattr(torch, dtype), device="cpu")
    for a, b in zip(jax.tree.leaves(again), jax.tree.leaves(port)):
        assert a.dtype == b.dtype and torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_init_params_has_reference_leaves(dtype):
    cfg = smoke_config(get_config(ARCH))
    port = T.init_params(cfg, torch.Generator().manual_seed(0), dtype=getattr(torch, dtype),
                         device="cpu")
    ref = JT.abstract_params(j_smoke_config(j_get_config(ARCH)), getattr(jnp, dtype))
    got = params_to_numpy(port)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for a, b in zip(jax.tree.leaves(got), jax.tree.leaves(ref)):
        assert a.shape == b.shape
    assert {str(x.dtype).removeprefix("torch.") for x in jax.tree.leaves(port)} == {dtype}
    # the reference's scales: N(0, 1/d) embeddings, unit norms
    assert abs(port["embed"].float().std().item() * np.sqrt(cfg.d_model) - 1) < 0.05
    assert torch.equal(port["final_norm"]["scale"].float(), torch.ones(cfg.d_model))


# ---------------------------------------------------------------------------
# the slice: forward, prefill and decode against the reference
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def fp32_model():
    jcfg = j_smoke_config(j_get_config(ARCH))
    tree = jax_tree(jcfg, jnp.float32)
    return jcfg, tree, smoke_config(get_config(ARCH)), params_from_jax(tree, device="cpu")


def test_forward_matches_reference(fp32_model):
    jcfg, tree, cfg, params = fp32_model
    toks = np.random.default_rng(14).integers(0, cfg.vocab_size, (2, 11))
    close(T.forward(params, {"tokens": torch.from_numpy(toks)}, cfg),
          JT.forward(tree, {"tokens": jnp.asarray(toks)}, jcfg, remat=False), 1e-4)


def _serve_reference(jcfg, tree, toks, gen, max_len, cache_dtype, forced=None):
    """The reference's serving path: T.prefill, the last-position logits of
    launch/steps.py build_prefill_step, then greedy T.decode_step (or the
    ``forced`` tokens (B, gen) in place of the greedy ones)."""
    x, cache = JT.prefill(tree, {"tokens": jnp.asarray(toks)}, jcfg, max_len, dtype=cache_dtype)
    logits = (x[:, -1] @ JT.lm_head_weights(tree, jcfg)).astype(jnp.float32)
    out, tokens = [logits], []
    step = jax.jit(lambda p, c, tk: JT.decode_step(p, c, tk, jcfg))
    for _ in range(gen):
        tok = (jnp.argmax(logits, axis=-1).astype(jnp.int32) if forced is None
               else jnp.asarray(forced[:, len(tokens)]))
        tokens.append(np.asarray(tok))
        logits, cache = step(tree, cache, tok)
        out.append(logits)
    return [np.asarray(lg) for lg in out], np.stack(tokens, axis=1)


def _serve_port(cfg, params, toks, gen, max_len, forced=None):
    logits, cache = build_prefill_step(cfg, max_len)(params, {"tokens": torch.from_numpy(toks)})
    decode = build_decode_step(cfg)
    out, tokens = [logits], []
    for _ in range(gen):
        tok = logits.argmax(dim=-1) if forced is None else torch.from_numpy(forced[:, len(tokens)])
        tokens.append(tok.numpy())
        logits, cache = decode(params, cache, tok)
        out.append(logits)
    assert cache["len"] == toks.shape[1] + gen
    return [lg.numpy() for lg in out], np.stack(tokens, axis=1)


def test_serving_slice_fp32_matches_reference(fp32_model):
    jcfg, tree, cfg, params = fp32_model
    toks = np.random.default_rng(15).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want, want_tokens = _serve_reference(jcfg, tree, toks, 4, 12, jnp.float32)
    got, got_tokens = _serve_port(cfg, params, toks, 4, 12)
    assert len(got) == len(want) == 5
    for g, w in zip(got, want):
        close(torch.from_numpy(g), w, 1e-4)
    np.testing.assert_array_equal(got_tokens, want_tokens)


def test_serving_slice_bf16_matches_reference():
    """In bf16 the two round at other points (the reference's jnp attention
    rounds its probabilities to bf16; the port, like the TPU kernel, keeps
    them in fp32), and each lies up to ~5e-2 (max abs) from an fp32 run of
    the same weights. So the bf16 bar of 2e-2 is taken on the relative norm
    of each step's logits, with the reference's greedy tokens fed to both."""
    jcfg = j_smoke_config(j_get_config(ARCH))
    tree = jax_tree(jcfg, jnp.bfloat16)
    cfg = smoke_config(get_config(ARCH))
    params = params_from_jax(tree, device="cpu")
    toks = np.random.default_rng(16).integers(0, cfg.vocab_size, (2, 8)).astype(np.int32)
    want, want_tokens = _serve_reference(jcfg, tree, toks, 4, 12, jnp.bfloat16)
    got, _ = _serve_port(cfg, params, toks, 4, 12, forced=want_tokens)
    for g, w in zip(got, want):
        assert np.linalg.norm(g - w) <= 2e-2 * np.linalg.norm(w)
