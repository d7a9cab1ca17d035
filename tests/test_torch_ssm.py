"""The port's rwkv6 and hybrid (attention + Mamba) models against the JAX
reference.

For the smoke configs of rwkv6-7b and hymba-1.5b, in fp32, with the
reference's ``init_params`` moved over by ``convert.params_from_jax``: the
port's ``forward``, ``prefill`` and greedy ``decode_step``s against the
reference's, at rtol = atol = 1e-4 (the loss bar of the reference's own ring
harness) in the logits and in every cache leaf, with equal greedy tokens.
hymba's prompt (12) is longer than its smoke window (8), so the window cuts
in prefill and decode wraps the attention ring. On the CPU the scans run
their plain versions (the kernels run only on the card). The launchers serve
both archs on the CPU and refuse to train them.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.models import transformer as JT
from repro.models.config import get_config as j_get_config
from repro_torch.configs import smoke_config
from repro_torch.launch import serve, train
from repro_torch.launch.steps import build_decode_step, build_prefill_step
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


ARCHS = ["rwkv6-7b", "hymba-1.5b"]
PROMPT = {"rwkv6-7b": 9, "hymba-1.5b": 12}   # hymba: longer than the smoke window 8
GEN = 4
BF16_PROMPT = 256
TOL = 1e-4
FP32_LEAVES = {"w0", "u", "a_log"}            # fp32 in every parameter dtype


def close(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float32), np.asarray(want, np.float32),
                               rtol=TOL, atol=TOL)


def jax_tree(jcfg, dtype):
    return jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), jcfg, dtype=dtype))


def cache_leaves(cache, prefix=""):
    """{path: array} of a cache: the reference's, or the port's (same keys)."""
    out = {}
    for key, val in cache.items():
        if isinstance(val, dict):
            out.update(cache_leaves(val, f"{prefix}{key}."))
        else:
            out[prefix + key] = np.asarray(val.numpy() if isinstance(val, torch.Tensor) else val)
    return out


@pytest.fixture(scope="module", params=ARCHS)
def model(request):
    """The smoke model in fp32 on both sides and the reference's outputs,
    built once: ``forward`` on the prompt, then prefill and greedy decode
    with the logits and the cache after every step."""
    arch = request.param
    jcfg, cfg = j_smoke_config(j_get_config(arch)), smoke_config(get_config(arch))
    tree = jax_tree(jcfg, jnp.float32)
    toks = np.random.default_rng(PROMPT[arch]).integers(
        0, cfg.vocab_size, (2, PROMPT[arch])).astype(np.int32)
    max_len = PROMPT[arch] + GEN
    fwd = jax.jit(lambda p, tk: JT.forward(p, {"tokens": tk}, jcfg, remat=False))
    pre = jax.jit(lambda p, tk: JT.prefill(p, {"tokens": tk}, jcfg, max_len, dtype=jnp.float32))
    step = jax.jit(lambda p, c, tk: JT.decode_step(p, c, tk, jcfg))
    x, cache = pre(tree, jnp.asarray(toks))
    logits = (x[:, -1] @ JT.lm_head_weights(tree, jcfg)).astype(jnp.float32)
    steps = [(np.asarray(logits), cache_leaves(cache))]
    tokens = []
    for _ in range(GEN):
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        tokens.append(np.asarray(tok))
        logits, cache = step(tree, cache, tok)
        steps.append((np.asarray(logits), cache_leaves(cache)))
    return {"arch": arch, "cfg": cfg, "tree": tree, "params": params_from_jax(tree, device="cpu"),
            "toks": toks, "max_len": max_len, "forward": np.asarray(fwd(tree, toks)),
            "steps": steps, "tokens": np.stack(tokens, axis=1)}


def test_forward_matches_reference(model):
    got = T.forward(model["params"], {"tokens": torch.from_numpy(model["toks"])}, model["cfg"])
    close(got.detach(), model["forward"])


def test_prefill_and_decode_match_reference(model):
    cfg, params = model["cfg"], model["params"]
    logits, cache = build_prefill_step(cfg, model["max_len"])(
        params, {"tokens": torch.from_numpy(model["toks"])})
    decode = build_decode_step(cfg)
    tokens = []
    for i, (want_logits, want_cache) in enumerate(model["steps"]):
        close(logits, want_logits)
        got_cache = cache_leaves(cache)
        assert set(got_cache) == set(want_cache), f"step {i}: cache leaves differ"
        for name, want in want_cache.items():
            assert got_cache[name].shape == want.shape, f"step {i}: {name}"
            close(got_cache[name], want)
        if i < GEN:
            tok = logits.argmax(dim=-1)
            tokens.append(tok.numpy())
            logits, cache = decode(params, cache, tok)
    np.testing.assert_array_equal(np.stack(tokens, axis=1), model["tokens"])
    if model["arch"] == "hymba-1.5b":   # the ring wrapped: more positions than slots
        assert cache["len"] > cache["k"].shape[2]


def rel(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("arch", ARCHS)
def test_bf16_lies_no_farther_from_fp32_than_the_reference(arch):
    """In bf16 the port's logits lie no farther from the fp32 logits of the
    same (bf16-valued) weights than the reference's bf16 logits do: the
    distance bf16 rounding puts between bf16 and fp32 belongs to the model,
    and the port adds no rounding of its own (a cast the reference does not
    make, such as the decays or the scan state through bf16). A prompt of
    256 lets a drifting decay show: rounding rwkv6's decays through bf16
    puts the port at ~1.5x the reference's distance. The factor 1.25 leaves
    room for the two libraries' different bf16 operation orders (the port
    reads 0.8-1.0x); both distances are ~2e-2 here, against ~1e-6 between
    the two sides in fp32."""
    jcfg, cfg = j_smoke_config(j_get_config(arch)), smoke_config(get_config(arch))
    tree = jax_tree(jcfg, jnp.bfloat16)
    up = jax.tree.map(lambda a: np.asarray(a, np.float32), tree)   # the same values in fp32
    toks = np.random.default_rng(BF16_PROMPT).integers(
        0, cfg.vocab_size, (2, BF16_PROMPT)).astype(np.int32)
    fwd = jax.jit(lambda p, tk: JT.forward(p, {"tokens": tk}, jcfg, remat=False))
    truth = np.asarray(fwd(up, toks), np.float32)
    ref_gap = rel(np.asarray(fwd(tree, toks).astype(jnp.float32)), truth)
    batch = {"tokens": torch.from_numpy(toks)}
    with torch.no_grad():
        port = T.forward(params_from_jax(tree, device="cpu"), batch, cfg).float()
        port32 = T.forward(params_from_jax(up, device="cpu"), batch, cfg)
    close(port32, truth)
    assert ref_gap > 1e-3, "the reference's bf16 run did not run in bf16"
    assert rel(port, truth) <= 1.25 * ref_gap, (rel(port, truth), ref_gap)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_has_reference_leaves(arch):
    """The port's init: the reference's tree, shapes and dtypes (bf16 but
    for the fp32 decay, bonus and A leaves), at smoke width on the CPU."""
    cfg = smoke_config(get_config(arch))
    port = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    ref = JT.abstract_params(j_smoke_config(j_get_config(arch)))
    got = params_to_numpy(port)
    assert jax.tree.structure(got) == jax.tree.structure(ref)
    for (path, a), b in zip(jax.tree_util.tree_flatten_with_path(got)[0], jax.tree.leaves(ref)):
        assert a.shape == b.shape, jax.tree_util.keystr(path)
    for path, leaf in jax.tree_util.tree_flatten_with_path(port["layers"][0])[0]:
        want = torch.float32 if path[-1].key in FP32_LEAVES else torch.bfloat16
        assert leaf.dtype == want, jax.tree_util.keystr(path)


@pytest.mark.parametrize("arch", ARCHS)
def test_params_round_trip_keeps_fp32_leaves(arch):
    """A bf16 reference tree crosses over with its fp32 leaves still fp32
    (the nested rwkv.time / rwkv.channel and mamba trees included), and back
    bit for bit."""
    tree = jax_tree(j_smoke_config(j_get_config(arch)), jnp.bfloat16)
    port = params_from_jax(tree, device="cpu")
    for path, leaf in jax.tree_util.tree_flatten_with_path(port["layers"])[0]:
        want = torch.float32 if path[-1].key in FP32_LEAVES else torch.bfloat16
        assert leaf.dtype == want, jax.tree_util.keystr(path)
    jax.tree.map(lambda a, b: np.testing.assert_array_equal(np.asarray(a, np.float32), b),
                 tree, params_to_numpy(port))


@pytest.mark.parametrize("arch", ARCHS)
def test_serve_smoke_on_cpu(arch, capsys):
    out = serve.main(["--arch", arch, "--smoke", "--device", "cpu", "--batch", "2",
                      "--prompt-len", str(PROMPT[arch]), "--gen", "3"])
    lines = capsys.readouterr().out.splitlines()
    assert lines[0].startswith(f"prefill: 2x{PROMPT[arch]} in ")
    assert lines[1].startswith("decode: 3 steps in ")
    assert tuple(out.tokens.shape) == (2, 3)
    assert all(bool(torch.isfinite(lg).all()) for lg in out.logits)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_refuses_the_recurrent_families(arch):
    with pytest.raises(SystemExit, match="training of the rwkv6/hybrid families"):
        train.main(["--arch", arch, "--smoke", "--strategy", "roundpipe", "--mesh", "1x4",
                    "--steps", "1", "--device", "cpu"])


def test_moe_and_mla_still_raise_by_name():
    """MLA still raises by name; MoE is ported (tests/test_torch_moe.py)."""
    cfg = smoke_config(get_config("hymba-1.5b"))
    with pytest.raises(NotImplementedError, match="Queue 1, item 13"):
        T.init_params(dataclasses.replace(cfg, attn_kind="mla"), torch.Generator(),
                      device="cpu")
