"""Training the recurrent families (rwkv6-7b, hymba-1.5b) on the port's ring
against the JAX reference, on the CPU.

At smoke width and 4 layers, fp32, with the reference's tree drawn from a
numpy seed and moved over by ``params_from_jax``: the RoundPipe ring (N = 4,
the auto plan, batches of 8 x 16 tokens; hymba's 16 past its smoke window of
8) at one round and at R = 2 against the reference's single program
``jax.value_and_grad(T.loss_fn)``; LoRA r = 4 on hymba (targets ``attn`` and
``mlp``) against the reference's merged-dense oracle; the port's
``_mamba_inner`` against ``jax.vjp`` of the reference's; the model's loss and
grads with the scan entries routed through ``RwkvScan`` / ``SsmScan`` (the
card's route, here with the plain callables) against autograd of the plain
scans; the cost model and LoRA targets against the reference's; and the
launcher training both archs for 2 steps with ``--device cpu``. Bars: loss
rtol 1e-4; grads worst relative error < 5e-3 (``worst_rel_tree``). The
reference's own ring is not run here.
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
from repro.models import ssm as j_ssm
from repro.models import transformer as JT
from repro.models.config import get_config as j_get_config
from repro_torch.configs import smoke_config
from repro_torch.core import dispatch, plan
from repro_torch.kernels import ops, ref
from repro_torch.kernels.rwkv_scan import RwkvScan
from repro_torch.kernels.ssm_scan import SsmScan
from repro_torch.launch import train
from repro_torch.models import lora, ssm
from repro_torch.models import transformer as T
from repro_torch.models.config import get_config
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.optim.adam import tree_leaves


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: smoke-width ops gain nothing from more, and the
    suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ARCHS = ["rwkv6-7b", "hymba-1.5b"]
N, B, S, LAYERS = 4, 8, 16, 4
J_LCFG = j_lora.LoraConfig(rank=4, alpha=8.0, target_modules=("attn", "mlp"))
LCFG = lora.LoraConfig(rank=4, alpha=8.0, target_modules=("attn", "mlp"))


def npf(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def worst_rel_tree(ref_tree, got_tree):
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


def _draw(rng):
    def draw(path, a):
        name = jax.tree_util.keystr(path)
        x = rng.standard_normal(a.shape).astype(np.float32)
        if "scale" in name or "ln_x" in name:
            return 1.0 + 0.1 * x
        if "bias" in name:
            return 0.1 * x
        return x / np.float32(np.sqrt(a.shape[-1] if "embed" in name else a.shape[-2]))
    return draw


@functools.cache
def model(arch):
    """(reference config, its fp32 weights as numpy, port config, port
    weights) at smoke width and ``LAYERS`` layers: N(0, 1/fan_in) matrices,
    norm scales near 1, and random decays, bonuses and A (``w0``, ``u``,
    ``a_log``)."""
    j_cfg = dataclasses.replace(j_smoke_config(j_get_config(arch)), n_layers=LAYERS)
    cfg = dataclasses.replace(smoke_config(get_config(arch)), n_layers=LAYERS)
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


def reference_loss_and_grads(j_cfg, tree, batch):
    return run_jitted(jax.value_and_grad(lambda p, bt: JT.loss_fn(
        p, bt, j_cfg, remat=False, xent_chunk=8, kv_chunk=8)), tree, batch)


# ---------------------------------------------------------------------------
# The ring against the reference's single program
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("rounds", [1, 2])
@pytest.mark.parametrize("arch", ARCHS)
def test_ring_matches_single_program(arch, rounds):
    j_cfg, tree, cfg, params = model(arch)
    batch = batch_np(cfg, rounds * B, seed=3 + rounds)
    want_loss, want_grads = reference_loss_and_grads(j_cfg, tree, batch)
    fn = dispatch.build_roundpipe_grads_fn(cfg, N, plan.plan_from_config(cfg, N), xent_chunk=8,
                                           kv_chunk=8, n_microbatches=rounds * N)
    grads, loss, tokens = fn(dispatch.pad_pool(params, cfg, N), torch_batch(batch))
    assert int(tokens) == int((batch["labels"] != -100).sum())
    assert len(grads["layers"]) == LAYERS
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert worst_rel_tree(want_grads, params_to_numpy(grads)) < 5e-3


def test_hymba_lora_ring_matches_merged_single_program():
    j_cfg, tree, cfg, _ = model("hymba-1.5b")
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
    assert set(params["lora"][0]) == {"attn", "mlp"}
    fn = dispatch.build_roundpipe_grads_fn(cfg, N, plan.plan_from_config(cfg, N, lora=LCFG),
                                           xent_chunk=8, kv_chunk=8, lora=LCFG)
    grads, loss, _ = fn(params, torch_batch(batch))
    assert set(grads) == {"lora"}
    np.testing.assert_allclose(float(loss), float(want_loss), rtol=1e-4)
    assert worst_rel_tree(want_grads, params_to_numpy(grads)["lora"]) < 5e-3


# ---------------------------------------------------------------------------
# The Mamba block and the card's route through the autograd Functions
# ---------------------------------------------------------------------------

def test_mamba_inner_grads_match_reference():
    """The port's ``_mamba_inner`` (the scan through ``ops.ssm_scan``) against
    ``jax.vjp`` of the reference's, with cotangents on y, h_T and the conv
    state, over the input, the block's parameters and both states."""
    rng = np.random.default_rng(11)
    b, s, di, n = 2, 13, 24, 5
    p = {"conv": rng.standard_normal((ssm.CONV_W, di)) * 0.5,
         "w_bcdt": rng.standard_normal((di, 2 * n + 1)) / np.sqrt(di),
         "dt_bias": rng.standard_normal((1,)) * 0.1,
         "a_log": rng.standard_normal((di, n)) * 0.5,
         "d_skip": 1.0 + 0.1 * rng.standard_normal((di,))}
    p = {k: v.astype(np.float32) for k, v in p.items()}
    xz = rng.standard_normal((b, s, 2 * di)).astype(np.float32)
    h0 = rng.standard_normal((b, di, n)).astype(np.float32)
    conv0 = rng.standard_normal((b, ssm.CONV_W - 1, di)).astype(np.float32)
    cots = [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, di), (b, di, n), (b, ssm.CONV_W - 1, di))]
    outs, vjp = jax.vjp(lambda xz_, p_, h_, c_: j_ssm._mamba_inner(xz_, p_, n, h_, c_),
                        xz, p, h0, conv0)
    want = vjp(tuple(cots))
    leaves = {"xz": xz, "h0": h0, "conv0": conv0, **p}
    tleaves = {k: torch.from_numpy(v.copy()).requires_grad_() for k, v in leaves.items()}
    got_outs = ssm._mamba_inner(tleaves["xz"], {k: tleaves[k] for k in p}, n, tleaves["h0"],
                                tleaves["conv0"])
    for g, w in zip(got_outs, outs):
        np.testing.assert_allclose(npf(g), np.asarray(w), rtol=1e-4, atol=1e-4)
    total = sum((o * torch.from_numpy(c)).sum() for o, c in zip(got_outs, cots))
    names = ["xz", "h0", "conv0", *p]
    grads = dict(zip(names, torch.autograd.grad(total, [tleaves[k] for k in names])))
    want = {"xz": want[0], "h0": want[2], "conv0": want[3], **want[1]}
    for k in names:
        np.testing.assert_allclose(npf(grads[k]), np.asarray(want[k]), rtol=1e-4, atol=1e-4,
                                   err_msg=k)


def _through_functions(monkeypatch):
    """Route the CPU scan entries through the autograd Functions with the
    plain callables: the card's route, with the plain versions for kernels."""
    monkeypatch.setattr(ops, "rwkv_scan", lambda *a: RwkvScan.apply(
        *a, ref.rwkv_scan_ref, ref.rwkv_scan_bwd_ref))
    monkeypatch.setattr(ops, "ssm_scan", lambda *a, out_dtype=None: SsmScan.apply(
        *a, out_dtype, ref.ssm_scan_ref, ref.ssm_scan_bwd_ref))


def _loss_and_grads(params, cfg, batch):
    leaves = tree_leaves(params)
    for x in leaves:
        x.requires_grad_()
    loss = T.loss_fn(params, torch_batch(batch), cfg, remat=False)
    grads = torch.autograd.grad(loss, leaves)
    for x in leaves:
        x.requires_grad_(False)
    return loss, grads


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["fp32", "bf16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_model_through_the_scan_functions_matches_autograd(arch, dtype, monkeypatch):
    """The model's loss and grads with the scans through ``RwkvScan`` /
    ``SsmScan`` against autograd of the plain scans: the dtypes, casts and
    layouts the card's route hands the Functions (in bf16 too, where x, dt,
    B and C arrive in bf16 beside fp32 A and states)."""
    cfg = model(arch)[2]
    cast = T.init_params(cfg, torch.Generator().manual_seed(1), dtype=dtype, device="cpu")
    batch = batch_np(cfg, 2, 9)
    want_loss, want = _loss_and_grads(cast, cfg, batch)
    _through_functions(monkeypatch)
    loss, got = _loss_and_grads(cast, cfg, batch)
    tol = 1e-4 if dtype == torch.float32 else 2e-2
    np.testing.assert_allclose(loss.item(), want_loss.item(), rtol=tol)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.shape == w.shape
        err = (g.float() - w.float()).norm() / w.float().norm().clamp_min(1e-30)
        assert float(err) <= tol


# ---------------------------------------------------------------------------
# The cost model and the launcher
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("arch", ARCHS)
def test_layer_costs_and_lora_targets_match_reference(arch):
    """At full width: the auto plan's cost model (dense, int4 pool, LoRA;
    the fp32 leaves w0, u and a_log counted as the reference counts them)
    and the default LoRA targets: ``attn`` and ``mlp`` on hymba; none on
    rwkv6-7b, which both packages refuse by name (its LoRA costs are taken
    over ``rwkv.time``)."""
    j_cfg, cfg = j_get_config(arch), get_config(arch)
    if cfg.block_kind == "rwkv6":
        for mod, c in ((lora, cfg), (j_lora, j_cfg)):
            with pytest.raises(ValueError, match=r"none of \['attn', 'mlp'\] matches"):
                mod.applicable_targets(c)
        targets = ("rwkv.time",)
    else:
        targets = lora.applicable_targets(cfg)
        assert targets == j_lora.applicable_targets(j_cfg) == ("attn", "mlp")
    lcfg, j_lcfg = lora.LoraConfig(target_modules=targets), j_lora.LoraConfig(
        target_modules=targets)

    def costs(mod, c, **kw):
        return [dataclasses.asdict(x) for x in mod.default_layer_costs(c, **kw)]

    for kw, j_kw in (({}, {}), ({"pool_dtype": "int4"}, {"pool_dtype": "int4"}),
                     ({"lora": lcfg}, {"lora": j_lcfg})):
        assert costs(plan, cfg, **kw) == costs(j_plan, j_cfg, **j_kw)


@pytest.mark.parametrize("arch", ARCHS)
def test_train_launcher_trains_the_recurrent_families(arch):
    out = train.main(["--arch", arch, "--smoke", "--strategy", "roundpipe", "--mesh", "1x4",
                      "--steps", "2", "--batch", "8", "--seq", "16", "--log-every", "1",
                      "--device", "cpu"])
    assert out["steps"] == 2 and len(out["losses"]) == 2
    assert all(np.isfinite(out["losses"]))


def test_train_launcher_still_refuses_gspmd_and_a_data_axis():
    with pytest.raises(SystemExit, match="--strategy gspmd"):
        train.main(["--arch", "rwkv6-7b", "--smoke", "--strategy", "gspmd", "--steps", "1",
                    "--device", "cpu"])
    with pytest.raises(SystemExit, match="a data axis of 2"):
        train.main(["--arch", "hymba-1.5b", "--smoke", "--strategy", "roundpipe", "--mesh",
                    "2x4", "--steps", "1", "--device", "cpu"])
