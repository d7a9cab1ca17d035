"""The port's checkpoints, fault-tolerant loop and launcher restarts, on the
CPU, against the JAX reference's checkpoint store.

* the store: a round trip keeps bf16, fp32 and int32 leaves bit for bit and
  dtype for dtype; a directory without a manifest is invisible; ``keep``
  retention; a structure mismatch raises;
* cross-reading: a checkpoint the port writes loads through
  ``repro.checkpoint.store.load_checkpoint`` into the reference's
  ``init_roundpipe_state`` tree, leaf for leaf and dtype for dtype, and a
  reference-written one loads into the port's state (dense, and LoRA with an
  error-feedback residual);
* an Adafactor train state (``{master, m, vr, vc, step}``) converts from the
  reference's bit for bit, equals the port's own ``init_opt_state`` over the
  same weights, converts back, and one update of each package lands within
  the bars of the optimizer test (fp32 rtol 1e-5, the bf16 first moment 2^-7);
* ``FaultTolerantLoop`` restores the newest checkpoint and replays after an
  injected step exception;
* the launcher (``--device cpu``, smoke qwen3-1.7b, N = 4, b=8, s=16): 4
  uninterrupted steps are bit-identical to 2 steps, a resume, then 2 more,
  synchronous and chained (K = 2); a fresh directory starts from scratch; a
  synchronous checkpoint off a chain boundary is refused under
  ``--async-opt``.
"""
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as j_store
from repro.configs import smoke_config as j_smoke_config
from repro.core import dispatch as j_dispatch
from repro.launch.steps import StepConfig as JStepConfig
from repro.models import lora as j_lora
from repro.models.config import get_config as j_get_config
from repro.optim import adam as j_adam
from repro_torch.checkpoint import (CheckpointManager, latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.launch import train
from repro_torch.models.convert import state_from_jax, state_to_numpy
from repro_torch.optim.adam import OptConfig, apply_updates, init_opt_state, tree_leaves
from repro_torch.runtime import FaultTolerantLoop


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
N = 4


def _tree(seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"embed": torch.randn((5, 3), generator=g).to(torch.bfloat16),
                       "layers": [{"w": torch.randn((3, 2), generator=g),
                                   "n": {"scale": torch.randn((2,), generator=g)
                                         .to(torch.bfloat16)}} for _ in range(3)]},
            "opt": {"step": torch.tensor(7, dtype=torch.int32),
                    "grad_residual": [{"w": torch.randn((3, 2), generator=g)}
                                      for _ in range(3)]}}


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and x.shape == y.shape
        assert torch.equal(x, y)


def test_store_round_trip_keeps_dtypes_and_bits(tmp_path):
    state = _tree()
    final = save_checkpoint(tmp_path, 4, state)
    manifest = json.loads((final / "manifest.json").read_text())
    by_path = {e["path"]: e for e in manifest["leaves"]}
    assert by_path["['params']['layers']['w']"]["shape"] == [3, 3, 2]
    assert by_path["['params']['layers']['n']['scale']"]["dtype"] == "bfloat16"
    assert by_path["['opt']['step']"] == {"path": "['opt']['step']", "file": "leaf00001.npy",
                                          "shape": [], "dtype": "int32"}
    # jax.tree_util order: dict keys sorted, so 'opt' before 'params'
    assert [e["path"] for e in manifest["leaves"]][:2] == ["['opt']['grad_residual']['w']",
                                                           "['opt']['step']"]
    like = {"params": {"embed": torch.empty((5, 3), device="meta"),
                       "layers": [{"w": torch.empty((3, 2), device="meta"),
                                   "n": {"scale": torch.empty((2,), device="meta")}}] * 3},
            "opt": {"step": torch.empty((), device="meta"),
                    "grad_residual": [{"w": torch.empty((3, 2), device="meta")}] * 3}}
    got, step = load_checkpoint(tmp_path, 4, like, device="cpu")
    assert step == 4
    _same(got, state)
    assert list(got["params"]) == ["embed", "layers"]         # like's own key order


def test_a_directory_without_a_manifest_is_invisible(tmp_path):
    assert latest_step(tmp_path / "absent") is None
    save_checkpoint(tmp_path, 3, _tree())
    (tmp_path / ".tmp-9").mkdir()
    (tmp_path / "step_0000000009").mkdir()          # a crash before the manifest's rename
    assert latest_step(tmp_path) == 3


def test_keep_retains_the_newest(tmp_path):
    for s in range(5):
        save_checkpoint(tmp_path, s, _tree(s), keep=2)
    assert sorted(d.name for d in tmp_path.iterdir()) == ["step_0000000003", "step_0000000004"]
    mgr = CheckpointManager(tmp_path, save_every=2, keep=2)
    assert mgr.maybe_save(6, _tree()) and not mgr.maybe_save(7, _tree())
    state, start = mgr.restore_or_init(lambda: None, _tree(), device="cpu")
    assert start == 7
    _same(state, _tree())


def test_structure_mismatch_raises(tmp_path):
    save_checkpoint(tmp_path, 0, _tree())
    like = _tree()
    like["params"]["extra"] = torch.zeros(1)
    with pytest.raises(ValueError, match="structure mismatch"):
        load_checkpoint(tmp_path, 0, like)
    like = _tree()
    like["params"]["layers"] = like["params"]["layers"][:2]
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(tmp_path, 0, like)


def _states(kind):
    """The reference's and the port's roundpipe train state at smoke width
    (the port's converted from the reference's, so the two hold the same
    numbers), 3 layers padded to 4 rows."""
    import dataclasses
    j_cfg = dataclasses.replace(j_smoke_config(j_get_config(ARCH)), n_layers=3)
    if kind == "dense":
        j_step = JStepConfig(strategy="roundpipe")
    else:
        j_step = JStepConfig(strategy="roundpipe", lora=j_lora.LoraConfig(rank=4, alpha=8.0),
                             grad_compress="int8")
    j_state = j_dispatch.init_roundpipe_state(jax.random.PRNGKey(3), j_cfg, j_step,
                                              n_workers=N)
    # non-zero moments and residual, so a mix-up of leaves shows
    j_state = jax.tree_util.tree_map_with_path(
        lambda p, a: a + jnp.asarray(0.25, a.dtype) * (len(jax.tree_util.keystr(p)) % 7)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, j_state)
    j_state = jax.tree.map(np.asarray, j_state)
    return j_state, state_from_jax(j_state, device="cpu")


def _ref_bits(a):
    a = np.asarray(a)
    return a.view(np.uint16) if a.dtype.itemsize == 2 else a


@pytest.mark.parametrize("kind", ["dense", "lora_ef"])
def test_each_package_reads_the_others_checkpoints(tmp_path, kind):
    j_state, state = _states(kind)
    # the port writes, the reference reads into its own tree
    save_checkpoint(tmp_path / "port", 5, state)
    got, step = j_store.load_checkpoint(tmp_path / "port", 5, j_state)
    assert step == 5
    want_l = jax.tree_util.tree_flatten_with_path(j_state)[0]
    got_l = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [k for k, _ in want_l] == [k for k, _ in got_l]
    for (k, w), (_, g) in zip(want_l, got_l):
        assert np.asarray(g).dtype == w.dtype, jax.tree_util.keystr(k)
        np.testing.assert_array_equal(_ref_bits(g), _ref_bits(w),
                                      err_msg=jax.tree_util.keystr(k))
    # the reference writes, the port reads into its own state
    j_store.save_checkpoint(tmp_path / "ref", 6, j_state)
    back, step = load_checkpoint(tmp_path / "ref", 6, state)
    assert step == 6
    _same(back, state)


def _paths(tree, prefix=""):
    """{dotted path: leaf} of nested dicts and lists."""
    if isinstance(tree, dict):
        return {p: x for k, v in tree.items() for p, x in _paths(v, f"{prefix}.{k}").items()}
    if isinstance(tree, list):
        return {p: x for i, v in enumerate(tree) for p, x in _paths(v, f"{prefix}[{i}]").items()}
    return {prefix: tree}


@pytest.fixture(scope="module")
def adafactor_state():
    """The reference's Adafactor roundpipe state at smoke width, 3 layers in
    a pool of 4 rows."""
    import dataclasses
    j_cfg = dataclasses.replace(j_smoke_config(j_get_config(ARCH)), n_layers=3)
    j_state = j_dispatch.init_roundpipe_state(
        jax.random.PRNGKey(4), j_cfg,
        JStepConfig(strategy="roundpipe", opt=j_adam.OptConfig(mode="adafactor")), n_workers=N)
    return jax.tree.map(np.asarray, j_state)


@pytest.mark.parametrize("check", ["reference", "port_init", "round_trip"])
def test_adafactor_state_converts_bit_exactly(adafactor_state, check):
    j_state = adafactor_state
    assert set(j_state["opt"]) == {"master", "m", "vr", "vc", "step"}
    state = state_from_jax(j_state, device="cpu")
    assert len(state["opt"]["master"]["layers"]) == 4                 # the padded pool
    if check == "reference":   # leaf for leaf against init_opt_state(mode="adafactor")
        want = jax.tree.map(np.asarray, j_adam.init_opt_state(j_state["params"],
                                                              j_adam.OptConfig(mode="adafactor")))
        got = state_to_numpy(state)["opt"]
        for key in ("master", "m", "vr", "vc"):
            w, g = _paths(want[key]), _paths(got[key])
            assert w.keys() == g.keys()
            for p in w:
                np.testing.assert_array_equal(g[p], np.asarray(w[p], np.float32), err_msg=p)
        assert int(got["step"]) == int(want["step"]) == 0
        assert state["opt"]["m"]["embed"].dtype == torch.bfloat16
        assert state["opt"]["vr"]["layers"]["attn"]["w_q"].shape == (4, 64)   # stacked (L, d)
    elif check == "port_init":   # what the port itself keeps for the same weights
        want = _paths(init_opt_state(state["params"], OptConfig(mode="adafactor")))
        got = _paths(state["opt"])
        assert want.keys() == got.keys()
        for p in want:
            assert got[p].dtype == want[p].dtype and got[p].shape == want[p].shape, p
            assert torch.equal(got[p], want[p]), p
    else:
        back = state_to_numpy(state)
        flat_ref, tree_ref = jax.tree.flatten(j_state)
        flat_back, tree_back = jax.tree.flatten(back)
        assert tree_ref == tree_back
        for a, b in zip(flat_ref, flat_back):
            np.testing.assert_array_equal(np.asarray(a, np.float32), b)


def test_adafactor_update_after_conversion_matches_reference(adafactor_state):
    """One Adafactor update of the converted state against one update of the
    reference's, with the same gradients (the padding row's zero): every
    leaf within the optimizer test's bars."""
    j_state = adafactor_state
    rng = np.random.default_rng(5)
    grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32),
                         j_state["params"])
    for leaf in jax.tree.leaves(grads["layers"]):
        leaf[3:] = 0.0                                   # the pool's padding row
    kw = dict(mode="adafactor", lr=1e-2, weight_decay=0.1)
    j_params, j_opt, _ = j_adam.apply_updates(j_state["opt"], grads, j_adam.OptConfig(**kw),
                                              param_like=j_state["params"])
    state = state_from_jax(j_state, device="cpu")
    params, opt, _ = apply_updates(state["opt"], state_from_jax(
        {"params": grads, "opt": j_state["opt"]}, device="cpu")["params"], OptConfig(**kw),
        param_like=state["params"])
    want = state_to_numpy(state_from_jax({"params": jax.tree.map(np.asarray, j_params),
                                          "opt": jax.tree.map(np.asarray, j_opt)},
                                         device="cpu"))
    got = state_to_numpy({"params": params, "opt": opt})
    assert int(got["opt"]["step"]) == int(want["opt"]["step"]) == 1
    for key in ("master", "m", "vr", "vc"):
        tol = dict(rtol=2 ** -7, atol=1e-6) if key == "m" else dict(rtol=1e-5, atol=1e-6)
        w, g = _paths(want["opt"][key]), _paths(got["opt"][key])
        assert w.keys() == g.keys()
        for p in w:
            np.testing.assert_allclose(g[p], w[p], err_msg=f"{key}{p}", **tol)
    w, g = _paths(want["params"]), _paths(got["params"])
    for p in w:
        np.testing.assert_allclose(g[p], w[p], rtol=2 ** -7, atol=1e-6, err_msg=p)


def test_fault_tolerant_loop_restores_and_replays(tmp_path):
    """A step that raises once: the loop restores the newest checkpoint and
    replays from it, landing on the uninterrupted run's state."""
    class Data:
        def batch(self, step):
            return torch.full((2,), float(step + 1))

    def step_fn(state, batch):
        return {"w": state["w"] * 0.5 + batch}, {"loss": state["w"].sum()}

    fail = {"at": 3}

    def flaky(state, batch):
        if fail["at"] is not None and float(batch[0]) == fail["at"] + 1:
            fail["at"] = None
            raise RuntimeError("injected device fault")
        return step_fn(state, batch)

    init = lambda: {"w": torch.ones(2)}       # noqa: E731
    mgr = CheckpointManager(tmp_path, save_every=2)
    loop = FaultTolerantLoop(flaky, mgr, Data(), max_restarts=1)
    seen = []
    state, end = loop.run(init, init(), 6, device="cpu",
                          metrics_cb=lambda s, m, dt: seen.append(s))
    assert end == 6 and loop.restarts == 1
    assert seen == [0, 1, 2, 3, 4, 5]          # step 3 failed; step 2's checkpoint replays 3
    plain = init()
    for s in range(6):
        plain, _ = step_fn(plain, Data().batch(s))
    assert torch.equal(state["w"], plain["w"])
    with pytest.raises(RuntimeError, match="injected"):
        fail["at"] = 0
        FaultTolerantLoop(flaky, CheckpointManager(tmp_path / "b"), Data(),
                          max_restarts=0).run(init, init(), 2, device="cpu")


def _run(ckpt, steps, *extra):
    argv = ["--arch", ARCH, "--smoke", "--strategy", "roundpipe", "--mesh", f"1x{N}",
            "--batch", "8", "--seq", "16", "--steps", str(steps), "--log-every", "100",
            "--device", "cpu", *extra]
    if ckpt is not None:
        argv += ["--ckpt-dir", str(ckpt)]
    return train.run_training(train.build_parser().parse_args(argv))


@pytest.mark.parametrize("mode", ["sync", "async"])
def test_resumed_run_is_bit_identical_to_an_uninterrupted_one(tmp_path, mode):
    extra = ["--ckpt-every", "1"] + (["--async-opt", "--async-steps", "2"]
                                     if mode == "async" else [])
    ref = _run(None, 4, *extra)
    assert ref["resumed_from"] is None and ref["steps"] == 4 and len(ref["losses"]) == 4
    first = _run(tmp_path, 2, *extra)
    assert first["steps"] == 2 and latest_step(tmp_path) == 1
    second = _run(tmp_path, 4, *extra)
    assert second["resumed_from"] == 1 and second["steps"] == 4
    assert second["losses"] == ref["losses"][2:]
    _same(second["state"], ref["state"])


def test_fresh_dir_starts_from_scratch(tmp_path):
    out = _run(tmp_path / "fresh", 2)
    assert out["resumed_from"] is None and len(out["losses"]) == 2
    assert latest_step(tmp_path / "fresh") == 0        # --ckpt-every 50 saves step 0


def test_async_resume_off_a_chain_boundary_is_refused(tmp_path):
    _run(tmp_path, 1, "--ckpt-every", "1")            # holds 1 optimizer step
    with pytest.raises(SystemExit, match="not a multiple of --async-steps 2"):
        _run(tmp_path, 4, "--async-opt", "--async-steps", "2")
    # an async checkpoint resumes synchronously
    _run(tmp_path / "a", 2, "--async-opt", "--async-steps", "2", "--ckpt-every", "2")
    out = _run(tmp_path / "a", 3)
    assert out["resumed_from"] == 1 and len(out["losses"]) == 1
