"""The port's quantized pool and compressed deposits against the JAX
reference, on the CPU.

Sizes are the reference ring harness's: the smoke qwen3-1.7b config at 7
layers on the auto plan, b=8, s=16, xent and kv chunks of 8, N=4 ring
workers; weights from the reference's ``init_params`` through
``convert.params_from_jax``, other inputs from numpy seeds. On the CPU the
kernel entry ``ops.dequant_rows`` runs its plain version. Bars:

* the codec (``quantize_rows``, ``pack_int4``, ``unpack_int4``,
  ``dequant_rows_ref``) and the deposit codec (``compress_int8``,
  ``decompress_int8``): bit-exact against the reference (the Pallas
  ``dequant_rows`` in interpret mode and ``ref.dequant_rows_ref``);
* the pool row layout (``RingMachine.quantize_pool``): codes and scales
  bit-exact against the reference's layout, at a width where scale blocks
  span leaf boundaries;
* the int8 and int4 rings against the single-program oracle on the
  dequantized weights: loss rtol 1e-4, worst relative grad error < 5e-3; the
  int8 ring against the fp32 oracle: loss rtol 5e-2, grads < 0.25
  (``tests/roundpipe_subprocess.py`` ``run_quant``);
* code-chunk prefetch with forced chunk splits: bit-identical to the
  whole-block quantized gather;
* error-feedback deposits, ``run_quant``'s bars: the loss bit-identical to
  the exact path, replicated grads within 1e-5, a single shot within 8e-3,
  the mean over 4 steps below half of that, a nonzero residual;
* the train state with its residual: a bit-exact round trip.
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
from repro.kernels import dequant as j_dequant
from repro.kernels import ops as j_ops
from repro.kernels import ref as j_ref
from repro.launch.steps import StepConfig as JStepConfig
from repro.models import transformer as JT
from repro.models.config import get_config as j_get_config
from repro.optim import compress as j_compress
from repro_torch.configs import smoke_config
from repro_torch.core import dispatch, plan
from repro_torch.core.ring import OneCardTransport, RingMachine, flat_leaves
from repro_torch.kernels import dequant, ops, ref
from repro_torch.models.config import get_config
from repro_torch.models.convert import (params_from_jax, params_to_numpy, state_from_jax,
                                        state_to_numpy)
from repro_torch.optim import compress
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


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


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


def configs(**widths):
    j_cfg = dataclasses.replace(j_smoke_config(j_get_config(ARCH)), n_layers=L, **widths)
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)), n_layers=L, **widths)
    return j_cfg, cfg


def _dequantize_pool(layers_tree, bits):
    """The reference ring's quantize -> ship -> dequant round trip, applied to
    the stacked pool host-side: per layer row, flatten and concatenate the
    leaves (blocks span leaf boundaries), quantize, dequantize, split back.
    Copied from ``tests/roundpipe_subprocess.py``."""
    leaves, tdef = jax.tree_util.tree_flatten(layers_tree)
    rows = leaves[0].shape[0]
    cat = jnp.concatenate([l.reshape(rows, -1).astype(jnp.float32) for l in leaves], axis=1)
    codes, scales = j_dequant.quantize_rows(cat, bits=bits)
    flat = j_ops.dequant_rows(codes, scales)[:, :cat.shape[1]]
    out, off = [], 0
    for l in leaves:
        ne = int(np.prod(l.shape[1:]))
        out.append(flat[:, off:off + ne].reshape(l.shape).astype(l.dtype))
        off += ne
    return jax.tree_util.tree_unflatten(tdef, out), (codes, scales)


@functools.cache
def _oracle_fn():
    j_cfg, _ = configs()
    return jax.jit(jax.value_and_grad(lambda p, bt: JT.loss_fn(
        p, bt, j_cfg, remat=False, xent_chunk=8, kv_chunk=8)))


@functools.cache
def setup():
    """Weights, one batch and the reference's single-program oracles: on the
    fp32 weights and on the int8- and int4-dequantized pools."""
    j_cfg, cfg = configs()
    j_params = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), j_cfg,
                                                       dtype=jnp.float32))
    rng = np.random.default_rng(6)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    batch["labels"][:, :2] = -100
    oracle = {"fp32": _oracle_fn()(j_params, batch)}
    for bits in (8, 4):
        dq, _ = _dequantize_pool(j_params["layers"], bits)
        oracle[f"int{bits}"] = _oracle_fn()(dict(j_params, layers=dq), batch)
    params = dispatch.pad_pool(params_from_jax(j_params, device="cpu"), cfg, N)
    return cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()}, oracle


def quant_plan(cfg, pool_dtype):
    return plan.plan_from_config(cfg, N, pool_dtype=pool_dtype)


def forced_chunks(p):
    """The plan's prefetch program with every row split into chunks."""
    biggest = max(int(c.upload_stream_bytes) for c in p.layer_costs[:p.n_layers])
    program = p.prefetch_program(chunk_limit=max(1, biggest // 3))
    n_chunks = sum(1 for table in program.uploads for cu in table if cu.row >= 0)
    assert n_chunks > p.n_layers, "row chunk splitting did not engage"
    return program


# ---------------------------------------------------------------------------
# the codecs
# ---------------------------------------------------------------------------

def _codec_rows(seed):
    rng = np.random.default_rng(seed)
    x = (rng.standard_normal((6, 1000)) * rng.exponential(1.0, (6, 1))).astype(np.float32)
    x[1, :300] = 0.0                           # all-zero blocks
    x[2] = np.round(x[2] * 4) / 4              # exact ties at round(x / scale)
    x[3, ::5] = -x[3].max()
    return x


@pytest.mark.parametrize("bits", [8, 4])
def test_quantize_rows_and_packing_match_reference(bits):
    x = _codec_rows(bits)
    j_codes, j_scales = j_dequant.quantize_rows(jnp.asarray(x), bits=bits)
    codes, scales = dequant.quantize_rows(torch.from_numpy(x), bits=bits)
    assert codes.dtype == (torch.int8 if bits == 8 else torch.uint8)
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(j_scales))
    every = np.random.default_rng(0).integers(-8, 8, (3, 64)).astype(np.int8)
    every[0, :16] = np.arange(-8, 8)           # every nibble
    packed = dequant.pack_int4(torch.from_numpy(every))
    np.testing.assert_array_equal(packed.numpy(), np.asarray(j_dequant.pack_int4(every)))
    np.testing.assert_array_equal(dequant.unpack_int4(packed).numpy(), every)
    np.testing.assert_array_equal(
        dequant.unpack_int4(packed).numpy(),
        np.asarray(j_dequant.unpack_int4(jnp.asarray(packed.numpy()))))


@pytest.mark.parametrize("bits,rows,blocks", [(8, 3, 4), (4, 3, 4), (8, 1, 1), (4, 5, 2)])
def test_dequant_rows_ref_matches_pallas_and_reference_ref(bits, rows, blocks):
    rng = np.random.default_rng(bits * 100 + rows)
    if bits == 8:
        codes = rng.integers(-128, 128, (rows, blocks * 256)).astype(np.int8)
        codes[0, :256] = np.arange(-128, 128)  # every int8 code, -128 included
    else:
        codes = rng.integers(0, 256, (rows, blocks * 128)).astype(np.uint8)
        codes[0, :128] = np.arange(128) * 2    # every nibble in both halves
    scales = np.abs(rand(bits + rows, rows, blocks)) + 1e-3
    scales[-1, 0] = 1e-12
    want = np.asarray(j_dequant.dequant_rows(jnp.asarray(codes), jnp.asarray(scales),
                                             interpret=True))
    np.testing.assert_array_equal(want, np.asarray(j_ref.dequant_rows_ref(codes, scales)))
    got = ref.dequant_rows_ref(torch.from_numpy(codes), torch.from_numpy(scales))
    np.testing.assert_array_equal(got.numpy(), want)
    # the entry takes the plain version on the CPU, cast once to out_dtype
    bf = ops.dequant_rows(torch.from_numpy(codes), torch.from_numpy(scales),
                          out_dtype=torch.bfloat16)
    assert bf.dtype == torch.bfloat16
    assert torch.equal(bf, got.to(torch.bfloat16))
    # the kernel's wrapper launches on the card or raises
    with pytest.raises(ValueError, match="CUDA"):
        dequant.dequant_rows(torch.from_numpy(codes), torch.from_numpy(scales))


@pytest.mark.parametrize("with_residual", [False, True])
def test_compress_int8_matches_reference(with_residual):
    g = rand(31, 7, 33) * 3.0
    g[0] = 0.0
    res = rand(32, 7, 33) * 1e-2 if with_residual else None
    want = j_compress.compress_int8(jnp.asarray(g), None if res is None else jnp.asarray(res))
    got = compress.compress_int8(torch.from_numpy(g),
                                 None if res is None else torch.from_numpy(res))
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    np.testing.assert_array_equal(
        compress.decompress_int8(got[0], got[1], g.shape).numpy(),
        np.asarray(j_compress.decompress_int8(want[0], want[1], g.shape)))


# ---------------------------------------------------------------------------
# the pool row layout
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("pool_dtype,bits", [("int8", 8), ("int4", 4)])
def test_quantize_pool_matches_reference_layout(pool_dtype, bits):
    # odd widths: scale blocks span leaf boundaries everywhere, so a leaf
    # order other than the reference's sorted-key flatten would show
    j_cfg, cfg = configs(d_model=40, n_heads=5, n_kv_heads=1, d_head=8, d_ff=72)
    j_params = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(2), j_cfg,
                                                       dtype=jnp.float32))
    _, (j_codes, j_scales) = _dequantize_pool(jax.tree.map(jnp.asarray, j_params["layers"]),
                                              bits)
    layers = dispatch.pad_pool(params_from_jax(j_params, device="cpu"), cfg, N)["layers"]
    p = plan.plan_from_config(cfg, N, pool_dtype=pool_dtype)
    rm = RingMachine(cfg=cfg, plan=p, n_workers=N, l_pad=len(layers),
                     transport=OneCardTransport(N), pool_template=layers[0],
                     pool_dtype=pool_dtype)
    assert [x.shape for x in flat_leaves(layers[0])] == [
        x.shape[1:] for x in jax.tree.leaves(j_params["layers"])]
    qpool = rm.quantize_pool(rm.shards(layers))
    codes = torch.cat([c for c, _ in qpool])[:L]
    scales = torch.cat([s for _, s in qpool])[:L]
    np.testing.assert_array_equal(codes.numpy(), np.asarray(j_codes))
    np.testing.assert_array_equal(scales.numpy(), np.asarray(j_scales))


# ---------------------------------------------------------------------------
# the quantized rings
# ---------------------------------------------------------------------------

def test_int8_pool_ring_matches_dequantized_and_fp32_oracles():
    cfg, params, batch, oracle = setup()
    fn = dispatch.build_roundpipe_grads_fn(cfg, N, quant_plan(cfg, "int8"), xent_chunk=8,
                                           kv_chunk=8, pool_dtype="int8")
    grads, loss, tokens = fn(params, batch)
    assert int(tokens) == int((batch["labels"] != -100).sum())
    dq_loss, dq_grads = oracle["int8"]
    np.testing.assert_allclose(float(loss), float(dq_loss), rtol=1e-4)
    assert worst_rel(dq_grads, params_to_numpy(grads)) < 5e-3
    fp_loss, fp_grads = oracle["fp32"]
    np.testing.assert_allclose(float(loss), float(fp_loss), rtol=5e-2)
    assert worst_rel(fp_grads, params_to_numpy(grads)) < 0.25


def test_int8_code_prefetch_bit_identical_to_whole_block():
    cfg, params, batch, _ = setup()
    p = quant_plan(cfg, "int8")
    whole = dispatch.build_roundpipe_grads_fn(cfg, N, p, xent_chunk=8, kv_chunk=8,
                                              pool_dtype="int8")(params, batch)
    chunked = dispatch.build_roundpipe_grads_fn(cfg, N, p, xent_chunk=8, kv_chunk=8,
                                                pool_dtype="int8",
                                                prefetch_program=forced_chunks(p))(params, batch)
    assert_bit_equal(whole[:2], chunked[:2])


def test_int4_pool_on_the_dense_ring_matches_dequantized_oracle():
    cfg, params, batch, oracle = setup()
    p = quant_plan(cfg, "int4")
    fn = dispatch.build_roundpipe_grads_fn(cfg, N, p, xent_chunk=8, kv_chunk=8,
                                           pool_dtype="int4", prefetch_program=forced_chunks(p))
    grads, loss, _ = fn(params, batch)
    dq_loss, dq_grads = oracle["int4"]
    np.testing.assert_allclose(float(loss), float(dq_loss), rtol=1e-4)
    assert worst_rel(dq_grads, params_to_numpy(grads)) < 5e-3


def test_error_feedback_deposits():
    cfg, params, batch, oracle = setup()
    p = plan.plan_from_config(cfg, N)
    ex_g, ex_loss, _ = dispatch.build_roundpipe_grads_fn(cfg, N, p, xent_chunk=8,
                                                         kv_chunk=8)(params, batch)
    np.testing.assert_allclose(float(ex_loss), float(oracle["fp32"][0]), rtol=1e-4)
    assert worst_rel(oracle["fp32"][1], params_to_numpy(ex_g)) < 5e-3
    cfn = dispatch.build_roundpipe_grads_fn(cfg, N, p, xent_chunk=8, kv_chunk=8,
                                            grad_compress="int8")
    residual = [tree_map(torch.zeros_like, row) for row in params["layers"]]
    k_steps, sums = 4, None
    for k in range(k_steps):
        c_g, c_loss, _, residual = cfn(params, batch, residual)
        if k == 0:
            first_err = worst_rel(ex_g["layers"], c_g["layers"])
        sums = c_g["layers"] if sums is None else tree_map(torch.add, sums,
                                                                   c_g["layers"])
    mean_err = worst_rel(ex_g["layers"], tree_map(lambda a: a / k_steps, sums))
    # deposits happen after the loss: the forward is untouched
    assert npf(c_loss).tobytes() == npf(ex_loss).tobytes()
    rep_err = max(worst_rel(ex_g[k], c_g[k]) for k in ("embed", "final_norm"))
    assert rep_err < 1e-5
    assert first_err < 8e-3
    assert mean_err < first_err / 2, (mean_err, first_err)
    assert sum(float(x.abs().sum()) for x in tree_leaves(residual)) > 0.0


def test_roundpipe_state_with_residual_round_trip_bit_exact():
    j_cfg, cfg = configs()
    j_step = JStepConfig(strategy="roundpipe", grad_compress="int8", pool_dtype="int8")
    j_state = j_dispatch.init_roundpipe_state(jax.random.PRNGKey(1), j_cfg, j_step, n_workers=N)
    j_state = jax.tree.map(np.asarray, j_state)
    rng = np.random.default_rng(3)
    j_state["opt"]["grad_residual"] = jax.tree.map(
        lambda a: rng.standard_normal(a.shape).astype(np.float32), j_state["opt"]["grad_residual"])
    state = state_from_jax(j_state, device="cpu")
    res = state["opt"]["grad_residual"]
    assert len(res) == 8 and all(x.dtype == torch.float32 for x in tree_leaves(res))
    back = state_to_numpy(state)
    flat_ref, tree_ref = jax.tree.flatten(j_state)
    flat_back, tree_back = jax.tree.flatten(back)
    assert tree_ref == tree_back
    for a, b in zip(flat_ref, flat_back):
        np.testing.assert_array_equal(np.asarray(a, np.float32), b)
    # and the port's own fresh state carries fp32 zeros shaped like the pool
    from repro_torch.launch.steps import StepConfig
    fresh = dispatch.init_roundpipe_state(torch.Generator().manual_seed(0), cfg,
                                          StepConfig(strategy="roundpipe", grad_compress="int8"),
                                          n_workers=N, device="cpu")
    got = fresh["opt"]["grad_residual"]
    assert len(got) == 8
    for r, p in zip(tree_leaves(got), tree_leaves(fresh["params"]["layers"])):
        assert r.dtype == torch.float32 and r.shape == p.shape and not r.any()
