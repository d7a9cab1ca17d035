"""The port's goodput supervisor, its asynchronous checkpoint writer, the
elastic restore and the ring's rotation, against the JAX reference, on the
CPU.

* ``Supervisor``: the mock-runtime scenarios of the reference's
  ``tests/test_supervisor.py`` (detect -> rotate, a re-scored rotation, a
  healthy run, a dead worker -> re-plan + replay, async infeasible -> sync
  fallback, the restart budget, hang -> restore, asynchronous checkpoints,
  and a clean run) through both packages with a scripted clock: the same
  events, the same ledger, the same factory calls, the same final state;
  ``GoodputMeter``, ``analytic_goodput`` and ``checkpoint_cost_model`` give
  the reference's numbers and refusals;
* ``AsyncCheckpointWriter``: a crash mid-write keeps the old checkpoint the
  newest, a state changed in place after ``submit`` is written as it was, a
  writer error surfaces on ``wait``, many quick submits land in order, and
  an asynchronously written port checkpoint loads with the reference's
  ``load_checkpoint``;
* ``reshape_pooled_state`` against the reference's on the same trees (7
  layers, N = 4 -> 3 -> 4: dense AdamW, LoRA with an error-feedback residual,
  Adafactor with its factored statistics), its refusal below ``n_layers``,
  and ``load_checkpoint(..., elastic=True)`` beside the strict load;
* the rotated ring: at g0 in {1, 2, 3} on the auto 7-layer plan of 4 workers,
  loss and grads against g0 = 0 (relative 1e-5) and the reference's
  single-program oracle (loss rtol 1e-4, worst relative grad error < 5e-3,
  as ``tests/roundpipe_subprocess.py``); the transport's hop, gather, send
  and deposit endpoints are physical and the hops are the reference's
  ``shift_perm``; a searched schedule whose winner rotates trains;
* the chaos scenario of ``run_chaos`` (``chip_smoke.run_chaos``, the same
  code the card runs, here at smoke width): 7 layers, b = 12, worker 2 5x
  slow from step 2, worker 1 dead at step 5, asynchronous checkpoints every
  2 steps; the reference harness's events and bars;
* the launcher with ``--elastic --async-ckpt`` and its refusals.
"""
import dataclasses
import functools
import importlib.util
import itertools
import re
import sys
import threading
import time
from pathlib import Path
from types import SimpleNamespace

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.checkpoint import store as j_store
from repro.configs import smoke_config as j_smoke_config
from repro.core import dispatch as j_dispatch
from repro.core.plan import ReplanResult as JReplanResult
from repro.core.ring import shift_perm as j_shift_perm
from repro.launch.steps import StepConfig as JStepConfig
from repro.models import lora as j_lora
from repro.models import transformer as JT
from repro.models.config import get_config as j_get_config
from repro.optim import OptConfig as JOptConfig
from repro.runtime import fault_tolerance as j_ft
from repro.runtime import supervisor as j_sup
from repro_torch.checkpoint import (AsyncCheckpointWriter, latest_step, load_checkpoint,
                                    save_checkpoint)
from repro_torch.configs import smoke_config
from repro_torch.core import dispatch, plan, simulator
from repro_torch.core.plan import ReplanResult
from repro_torch.core.ring import OneCardTransport
from repro_torch.launch import train
from repro_torch.launch.steps import StepConfig
from repro_torch.models.config import get_config
from repro_torch.models.convert import params_from_jax, params_to_numpy
from repro_torch.optim.adam import init_opt_state, tree_leaves, tree_map
from repro_torch.runtime import fault_tolerance as ft
from repro_torch.runtime import supervisor as sup_mod

ROOT = Path(__file__).resolve().parents[1]
ARCH = "qwen3-1.7b"
N, B, S, L = 4, 8, 16, 7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: smoke-width ops gain nothing from more, and the
    suite's parallel workers share the cores with the JAX package's
    multi-device subprocess tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# ---------------------------------------------------------------------------
# the supervisor against the reference's, on mock runtimes
# ---------------------------------------------------------------------------

PKGS = {
    "ref": SimpleNamespace(Supervisor=j_sup.Supervisor, WorkerFault=j_sup.WorkerFault,
                           ReplanResult=JReplanResult, Policy=j_ft.StragglerPolicy,
                           zero=lambda: np.zeros(()), x=lambda s: float(np.asarray(s["x"])),
                           store=j_store),
    "port": SimpleNamespace(Supervisor=sup_mod.Supervisor, WorkerFault=sup_mod.WorkerFault,
                            ReplanResult=ReplanResult, Policy=ft.StragglerPolicy,
                            zero=lambda: torch.zeros(()), x=lambda s: float(s["x"]),
                            store=SimpleNamespace(latest_step=latest_step,
                                                  load_checkpoint=load_checkpoint)),
}


def fake_clock():
    """+1.0 s a call: every (t0, dt) pair of the supervisor brackets one tick,
    so the ledger is integers and the same in both packages."""
    c = itertools.count()
    return lambda: float(next(c))


def make_factory(pkg, record, step_impl=None, worker_times=None, rescore=None):
    """The reference suite's mock runtime: the state counts committed steps,
    and ``batch_for(step) = step`` replays deterministically."""
    def factory(*, n_workers, g0, use_async, replan=None):
        record.append((n_workers, g0, use_async,
                       None if replan is None else (replan.n_microbatches, replan.rounds,
                                                    replan.async_ok)))
        rt = SimpleNamespace(init_state=lambda: {"x": pkg.zero()}, like={"x": pkg.zero()},
                             shardings=None, batch_for=lambda step: step)

        def default_step(state, batch):
            return {"x": state["x"] + 1}, {"step": batch}

        rt.step_fn = step_impl or default_step
        if worker_times is not None:
            rt.worker_times = worker_times
        if rescore is not None:
            rt.rescore = rescore
        return rt

    return factory


def _killing(pkg, kill_at, killed):
    def step_impl(state, batch):
        if batch == kill_at and not killed:
            killed.append(batch)
            raise pkg.WorkerFault(1, "simulated device loss")
        return {"x": state["x"] + 1}, {"step": batch}
    return step_impl


def _scenario(name, pkg, d):
    """Run one scenario; returns (supervisor, final x or the error, factory
    calls, extra observations)."""
    record, extra = [], {}
    kw = dict(n_workers=4, clock=fake_clock())
    run, n_steps = None, 4
    if name == "clean":
        sup = pkg.Supervisor(make_factory(pkg, record), d, save_every=2, async_ckpt=False, **kw)
    elif name == "detect_rotate":
        def worker_times(metrics):
            return [1.0, 1.0, 5.0 if metrics["step"] >= 3 else 1.0, 1.0]
        sup = pkg.Supervisor(make_factory(pkg, record, worker_times=worker_times), d,
                             save_every=100, async_ckpt=False,
                             straggler=pkg.Policy(factor=2.0, min_samples=2), **kw)
        n_steps = 8
    elif name == "rescore":
        seen = extra.setdefault("scales", [])
        sup = pkg.Supervisor(
            make_factory(pkg, record, worker_times=lambda m: [1, 1, 1, 4.0],
                         rescore=lambda scales: seen.append(list(scales)) or 1),
            d, save_every=100, async_ckpt=False,
            straggler=pkg.Policy(factor=2.0, min_samples=1), **kw)
    elif name == "healthy":
        sup = pkg.Supervisor(make_factory(pkg, record,
                                          worker_times=lambda m: [1.0, 1.1, 0.9, 1.0]),
                             d, save_every=100, async_ckpt=False,
                             straggler=pkg.Policy(factor=2.0, min_samples=1), **kw)
        n_steps = 6
    elif name == "replan_replay":
        replans = extra.setdefault("replans", [])

        def replan_fn(n):
            replans.append(n)
            return pkg.ReplanResult(plan=None, n_microbatches=n, rounds=1, async_ok=True)
        sup = pkg.Supervisor(make_factory(pkg, record, step_impl=_killing(pkg, 5, [])), d,
                             replan_fn=replan_fn, save_every=2, async_ckpt=False, **kw)
        n_steps = 8
    elif name == "async_fallback":
        sup = pkg.Supervisor(
            make_factory(pkg, record, step_impl=_killing(pkg, 3, [])), d, save_every=2,
            async_ckpt=False, use_async=True,
            replan_fn=lambda n: pkg.ReplanResult(plan=None, n_microbatches=n, rounds=1,
                                                 async_ok=False,
                                                 async_refusal="R*S = 1 < N-1 = 2"), **kw)
        n_steps = 6

        def run():
            with pytest.warns(RuntimeWarning, match="async infeasible"):
                return sup.run(n_steps)
    elif name == "restart_budget":
        def always_dies(state, batch):
            raise pkg.WorkerFault(0)
        sup = pkg.Supervisor(make_factory(pkg, record, step_impl=always_dies), d,
                             max_restarts=2, async_ckpt=False, **dict(kw, n_workers=8))
    elif name == "hang_restore":
        hung = []

        def step_impl(state, batch):
            if batch == 3 and not hung:
                hung.append(batch)
                time.sleep(0.5)
            return {"x": state["x"] + 1}, {"step": batch}
        sup = pkg.Supervisor(make_factory(pkg, record, step_impl=step_impl), d,
                             save_every=2, async_ckpt=False, step_timeout_s=0.1, **kw)
    elif name == "async_ckpt":
        sup = pkg.Supervisor(make_factory(pkg, record), d, save_every=2, async_ckpt=True, **kw)
        n_steps = 6
    else:
        raise ValueError(name)
    try:
        state, step = (run or (lambda: sup.run(n_steps)))()
        result = (pkg.x(state), step)
    except RuntimeError as e:
        result = ("raised", str(e))
    newest = pkg.store.latest_step(d)
    if newest is not None:
        st, saved = pkg.store.load_checkpoint(d, newest, {"x": pkg.zero()})
        extra["newest"] = (newest, saved, pkg.x(st))
    return sup, result, record, extra


def _events(sup):
    """(step, kind, detail) of each event; the watchdog's count of firings
    in a hang's message depends on the clock, so it is read as a pattern."""
    out = []
    for e in sup.events:
        detail = dict(e.detail)
        if e.kind == "hang":
            assert re.fullmatch(r"step exceeded the 0\.1s heartbeat timeout \(\d+ watchdog "
                                r"firing\(s\)\)", detail["error"]), detail
            detail["error"] = "heartbeat timeout"
        out.append((e.step, e.kind, detail))
    return out


SCENARIOS = ["clean", "detect_rotate", "rescore", "healthy", "replan_replay",
             "async_fallback", "restart_budget", "hang_restore", "async_ckpt"]


@pytest.mark.parametrize("name", SCENARIOS)
def test_supervisor_matches_the_reference(tmp_path, name):
    got = {k: _scenario(name, pkg, tmp_path / k) for k, pkg in PKGS.items()}
    (j_s, j_res, j_rec, j_extra), (p_s, p_res, p_rec, p_extra) = got["ref"], got["port"]
    assert _events(p_s) == _events(j_s)
    assert p_s.meter.seconds == j_s.meter.seconds
    assert p_s.meter.report() == j_s.meter.report()
    assert p_res == j_res and p_rec == j_rec and p_extra == j_extra
    assert (p_s.g0, p_s.n_workers, p_s.use_async, p_s.restarts) == (
        j_s.g0, j_s.n_workers, j_s.use_async, j_s.restarts)
    # the reference suite's own expectations, on the port
    kinds = [e.kind for e in p_s.events]
    if name == "detect_rotate":
        assert p_s.events_of("rotate")[0].detail == {"g0": 3, "worker": 2, "ratio": 5.0}
        assert [r[1] for r in p_rec] == [0, 3]
    elif name == "rescore":
        assert p_s.g0 == 1 and p_extra["scales"][0] == [1.0, 1.0, 1.0, 4.0]
    elif name == "healthy":
        assert not p_s.events and len(p_rec) == 1
    elif name == "replan_replay":
        assert kinds == ["worker_dead", "replan", "restore"] and p_res == (8.0, 8)
        assert p_s.events_of("restore")[0].detail["resumed_at"] == 4
        assert p_s.meter.seconds["replay"] == 1.0 and p_rec[1] == (3, 0, False, (3, 1, True))
    elif name == "async_fallback":
        assert "sync_fallback" in kinds and [r[2] for r in p_rec] == [True, False]
    elif name == "restart_budget":
        assert p_res[0] == "raised" and "max_restarts" in p_res[1]
    elif name == "hang_restore":
        assert kinds == ["hang", "restore"] and p_s.meter.seconds["replay"] > 0
    elif name == "async_ckpt":
        assert p_extra["newest"] == (5, 5, 6.0) and p_s.ckpt_io["written"] == 3
    else:
        assert p_s.meter.seconds == {"productive": 4.0, "ckpt": 2.0, "replan": 0.0,
                                     "replay": 0.0}


@pytest.mark.parametrize("args", [
    dict(step_s=2.0, mtbf_steps=100, ckpt_every=10, ckpt_cost_s=4.0, replan_s=8.0),
    dict(step_s=0.7, mtbf_steps=5000, ckpt_every=50, ckpt_cost_s=1.3, replay=False),
    dict(step_s=1.0, mtbf_steps=10, ckpt_every=0, ckpt_cost_s=1.0),
    dict(step_s=0.0, mtbf_steps=10, ckpt_every=5, ckpt_cost_s=1.0),
])
def test_goodput_arithmetic_matches_the_reference(args):
    def call(fn):
        try:
            return fn(**args)
        except ValueError as e:
            return ("ValueError", str(e))
    assert call(sup_mod.analytic_goodput) == call(j_sup.analytic_goodput)
    for size in (0.0, 1e9, 10.6e9):
        assert sup_mod.checkpoint_cost_model(size, host_bw=25e9, disk_bw=2e9) == \
            j_sup.checkpoint_cost_model(size, host_bw=25e9, disk_bw=2e9)
    got, want = sup_mod.GoodputMeter(), j_sup.GoodputMeter()
    assert got.goodput == want.goodput == 1.0
    for m in (got, want):
        for cat, dt in zip(m.CATEGORIES, (args["step_s"], 1.0, 2.0, args["ckpt_cost_s"])):
            m.add(cat, dt)
    assert got.report() == want.report() and got.total == want.total


# ---------------------------------------------------------------------------
# the asynchronous writer
# ---------------------------------------------------------------------------

def _state(seed=0, rows=3):
    g = torch.Generator().manual_seed(seed)
    return {"params": {"embed": torch.randn((5, 3), generator=g).to(torch.bfloat16),
                       "layers": [{"w": torch.randn((3, 2), generator=g)} for _ in range(rows)]},
            "opt": {"step": torch.tensor(2, dtype=torch.int32)}}


def _same(a, b):
    la, lb = tree_leaves(a), tree_leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        assert x.dtype == y.dtype and torch.equal(x, y)


def test_writer_crash_mid_write_keeps_the_old_checkpoint(tmp_path):
    d = tmp_path / "ck"
    save_checkpoint(d, 0, _state(0))
    gate, started = threading.Event(), threading.Event()

    def slow_save(directory, step, state, keep=3):
        junk = d / f"step_{step:010d}"          # a half-written directory, no manifest
        junk.mkdir()
        (junk / "leaf00000.npy").write_bytes(b"garbage")
        started.set()
        assert gate.wait(10)
        return save_checkpoint(directory, step, state, keep=keep)

    with AsyncCheckpointWriter(d, save_fn=slow_save) as w:
        assert w.submit(1, _state(1)) >= 0.0
        assert started.wait(10)
        assert latest_step(d) == 0
        st, step = load_checkpoint(d, 0, _state(9), device="cpu")
        assert step == 0
        _same(st, _state(0))
        gate.set()
        w.wait()
        assert latest_step(d) == 1 and (w.submitted, w.completed) == (1, 1)
    _same(load_checkpoint(d, 1, _state(9))[0], _state(1))


def test_writer_snapshot_is_immune_to_changes_in_place(tmp_path):
    """``apply_updates`` updates the state in place right after ``submit``:
    the snapshot owns its buffers (host tensors are cloned, not aliased)."""
    gate = threading.Event()

    def gated_save(directory, step, state, keep=3):
        assert gate.wait(10)
        return save_checkpoint(directory, step, state, keep=keep)

    live, want = _state(3), _state(3)
    with AsyncCheckpointWriter(tmp_path, save_fn=gated_save) as w:
        w.submit(0, live)
        for x in tree_leaves(live):
            x.fill_(-1)
        gate.set()
        w.wait()
    _same(load_checkpoint(tmp_path, 0, _state(9))[0], want)


def test_writer_errors_surface_on_wait(tmp_path):
    def bad_save(directory, step, state, keep=3):
        raise OSError("disk full")

    w = AsyncCheckpointWriter(tmp_path, save_fn=bad_save)
    w.submit(0, _state())
    with pytest.raises(RuntimeError, match="async checkpoint"):
        w.wait()
    w.close()                                   # the error was consumed: a clean close
    w = AsyncCheckpointWriter(tmp_path, save_fn=bad_save)
    w.submit(0, _state())
    time.sleep(0.05)
    with pytest.raises(RuntimeError, match="async checkpoint"):
        w.submit(1, _state())                   # or on the next submit
    w.close()


def test_writer_under_many_quick_submits(tmp_path):
    """A short switch interval and 40 submits from the caller while the
    thread writes: every write lands once, in submission order."""
    order = []

    def record(directory, step, state, keep=3):
        order.append((step, int(state["opt"]["step"])))
        time.sleep(0.001)

    kept = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        w = AsyncCheckpointWriter(tmp_path, save_fn=record)
        for i in range(40):
            st = _state(i, rows=1)
            st["opt"]["step"].fill_(i)
            w.submit(i, st)
            st["opt"]["step"].fill_(-1)
        w.close()
    finally:
        sys.setswitchinterval(kept)
    assert not w._thread.is_alive()
    assert order == [(i, i) for i in range(40)] and w.completed == w.submitted == 40


@functools.cache
def _j_states(kind, n_layers=L, n=N):
    """The reference's roundpipe train state at smoke width, every float leaf
    moved off its initial value so a mix-up of leaves shows."""
    j_cfg = dataclasses.replace(j_smoke_config(j_get_config(ARCH)), n_layers=n_layers)
    kw = {"dense": {}, "lora_ef": dict(lora=j_lora.LoraConfig(rank=4, alpha=8.0),
                                       grad_compress="int8"),
          "adafactor": dict(opt=JOptConfig(mode="adafactor"))}[kind]
    j_state = j_dispatch.init_roundpipe_state(jax.random.PRNGKey(3), j_cfg,
                                              JStepConfig(strategy="roundpipe", **kw),
                                              n_workers=n)
    j_state = jax.tree_util.tree_map_with_path(
        lambda p, a: a + jnp.asarray(0.25, a.dtype) * (1 + len(jax.tree_util.keystr(p)) % 7)
        if jnp.issubdtype(a.dtype, jnp.floating) else a, j_state)
    return j_cfg, jax.tree.map(np.asarray, j_state)


def test_an_async_port_checkpoint_loads_in_the_reference(tmp_path):
    from repro_torch.models.convert import state_from_jax
    _, j_state = _j_states("lora_ef")
    state = state_from_jax(j_state, device="cpu")
    with AsyncCheckpointWriter(tmp_path) as w:
        w.submit(7, state)
    got, step = j_store.load_checkpoint(tmp_path, 7, j_state)
    assert step == 7
    want_l = jax.tree_util.tree_flatten_with_path(j_state)[0]
    got_l = jax.tree_util.tree_flatten_with_path(got)[0]
    assert [k for k, _ in want_l] == [k for k, _ in got_l]
    for (k, a), (_, b) in zip(want_l, got_l):
        a, b = np.asarray(a), np.asarray(b)
        assert a.dtype == b.dtype, jax.tree_util.keystr(k)
        bits = (lambda x: x.view(np.uint16)) if a.dtype.itemsize == 2 else (lambda x: x)
        np.testing.assert_array_equal(bits(b), bits(a), err_msg=jax.tree_util.keystr(k))


# ---------------------------------------------------------------------------
# the elastic restore
# ---------------------------------------------------------------------------

_POOLED = ("layers", "lora", "grad_residual")


def to_port(tree, path=()):
    """A reference tree (numpy, pools stacked) in the port's layout: pooled
    subtrees as lists of per-layer trees, except Adafactor's statistics
    (``vr``/``vc``), which the port keeps stacked; float leaves in fp32."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            if k in _POOLED and not {"vr", "vc"} & set(path):
                n = len(jax.tree.leaves(v)[0])
                out[k] = [jax.tree.map(lambda a, i=i: _t(a[i]), v) for i in range(n)]
            else:
                out[k] = to_port(v, path + (k,))
        return out
    return _t(tree)


def _t(a):
    a = np.asarray(a)
    return torch.from_numpy(np.array(a, np.float32 if jnp.issubdtype(a.dtype, jnp.floating)
                                     else a.dtype))


def from_port(tree):
    if isinstance(tree, dict):
        return {k: from_port(v) for k, v in tree.items()}
    if isinstance(tree, list):
        rows = [from_port(r) for r in tree]
        return jax.tree.map(lambda *xs: np.stack(xs), *rows)
    return tree.numpy()


def _f32(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32), tree)


def _equal_trees(a, b):
    la, lb = jax.tree_util.tree_flatten_with_path(a)[0], jax.tree_util.tree_flatten_with_path(b)[0]
    assert [k for k, _ in la] == [k for k, _ in lb]
    for (k, x), (_, y) in zip(la, lb):
        np.testing.assert_array_equal(x, y, err_msg=jax.tree_util.keystr(k))


@pytest.mark.parametrize("kind", ["dense", "lora_ef", "adafactor"])
def test_reshape_pooled_state_matches_the_reference(kind):
    j_cfg, j_state = _j_states(kind, n_layers=L)
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)), n_layers=L)
    j_state, state = _f32(j_state), to_port(j_state)
    assert len(state["params"]["layers"]) == 8
    for n_new, rows in ((3, 9), (4, 8)):
        j_state = j_dispatch.reshape_pooled_state(j_state, j_cfg, n_new)
        state = dispatch.reshape_pooled_state(state, cfg, n_new)
        assert len(state["params"]["layers"]) == rows
        _equal_trees(from_port(state), _f32(j_state))
    assert dispatch.reshape_pooled_state(state, cfg, 4) is state       # the depth it has


def test_reshape_pooled_state_refuses_a_short_pool():
    """A pool of 4 rows (a 3-layer model's at N = 4) for a 7-layer model."""
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)), n_layers=L)
    j_cfg = dataclasses.replace(j_smoke_config(j_get_config(ARCH)), n_layers=L)
    j_state = {"params": {"embed": np.ones((3, 2), np.float32),
                          "layers": {"w": np.ones((4, 2, 2), np.float32)}}}
    with pytest.raises(ValueError, match="smaller than n_layers=7"):
        j_dispatch.reshape_pooled_state(j_state, j_cfg, 3)
    with pytest.raises(ValueError, match="smaller than n_layers=7"):
        dispatch.reshape_pooled_state(to_port(j_state), cfg, 3)


@pytest.mark.parametrize("kind", ["dense", "adafactor"])
def test_elastic_load_reads_the_depth_as_written(tmp_path, kind):
    """A 4-worker checkpoint (8 pool rows) into a 3-worker state's structure
    (9 rows): the strict load refuses it, the elastic one loads 8 rows, and
    the re-pad gives the reference's 3-worker state."""
    j_cfg, j_state = _j_states(kind, n_layers=L)
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)), n_layers=L)
    state = to_port(j_state)
    save_checkpoint(tmp_path, 3, state)
    like = dispatch.reshape_pooled_state(state, cfg, 3)
    with pytest.raises(ValueError, match="shape"):
        load_checkpoint(tmp_path, 3, like)
    got, step = load_checkpoint(tmp_path, 3, like, device="cpu", elastic=True)
    assert step == 3 and len(got["params"]["layers"]) == 8
    _equal_trees(from_port(got), _f32(j_state))
    _equal_trees(from_port(dispatch.reshape_pooled_state(got, cfg, 3)),
                 _f32(j_dispatch.reshape_pooled_state(j_state, j_cfg, 3)))


# ---------------------------------------------------------------------------
# the rotated ring
# ---------------------------------------------------------------------------

@functools.cache
def ring_setup():
    j_cfg = dataclasses.replace(j_smoke_config(j_get_config(ARCH)), n_layers=L)
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)), n_layers=L)
    j_params = jax.tree.map(np.asarray, JT.init_params(jax.random.PRNGKey(0), j_cfg,
                                                       dtype=jnp.float32))
    oracle = jax.jit(jax.value_and_grad(lambda p, bt: JT.loss_fn(
        p, bt, j_cfg, remat=False, xent_chunk=8, kv_chunk=8)))
    params = dispatch.pad_pool(params_from_jax(j_params, device="cpu"), cfg, N)
    rng = np.random.default_rng(5)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32),
             "labels": rng.integers(0, cfg.vocab_size, (B, S)).astype(np.int32)}
    batch["labels"][::3, :2] = -100
    return cfg, j_params, oracle, params, plan.plan_from_config(cfg, N), batch


def npf(x):
    return np.asarray(x.detach().float() if isinstance(x, torch.Tensor) else x, np.float32)


def worst_rel(ref_tree, got_tree):
    """max over leaves of |got - ref|_inf / (|ref|_inf + 1e-6), as the harness."""
    ref_l, got_l = jax.tree.leaves(ref_tree), jax.tree.leaves(got_tree)
    assert len(ref_l) == len(got_l)
    return max(float(np.abs(npf(g) - npf(r)).max() / (np.abs(npf(r)).max() + 1e-6))
               for r, g in zip(ref_l, got_l))


@functools.cache
def rotated(g0):
    cfg, _, _, params, p, batch = ring_setup()
    fn = dispatch.build_roundpipe_grads_fn(cfg, N, p, xent_chunk=8, kv_chunk=8, g0=g0)
    grads, loss, tokens = fn(params, {k: torch.from_numpy(v) for k, v in batch.items()})
    return params_to_numpy(grads), float(loss), int(tokens)


@pytest.mark.parametrize("g0", [1, 2, 3])
def test_rotated_ring_matches_g0_0_and_the_oracle(g0):
    cfg, j_params, oracle, _, _, batch = ring_setup()
    grads, loss, tokens = rotated(g0)
    grads0, loss0, tokens0 = rotated(0)
    assert tokens == tokens0 == int((batch["labels"] != -100).sum())
    assert abs(loss - loss0) <= 1e-5 * abs(loss0)
    assert worst_rel(grads0, grads) <= 1e-5
    want_loss, want_grads = oracle(j_params, batch)
    np.testing.assert_allclose(loss, float(want_loss), rtol=1e-4)
    assert worst_rel(want_grads, grads) < 5e-3


def test_rotated_lora_ring_matches_g0_0():
    """The adapter ring rotates with the dense one: at g0 = 2 the adapter
    grads are g0 = 0's (adapters away from B = 0, so every leaf moves)."""
    from repro_torch.models.lora import LoraConfig, init_adapters
    cfg, _, _, params, p, batch = ring_setup()
    lcfg = LoraConfig(rank=4, alpha=8.0)
    adapters = init_adapters(torch.Generator().manual_seed(3), params["layers"][:L], lcfg)
    adapters = [tree_map(lambda a: a + 0.05, row) for row in adapters]
    lp = dispatch.pad_pool(dict(params, layers=params["layers"][:L], lora=adapters), cfg, N)
    lplan = plan.plan_from_config(cfg, N, lora=lcfg)
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    out = [dispatch.build_roundpipe_grads_fn(cfg, N, lplan, xent_chunk=8, kv_chunk=8,
                                             lora=lcfg, g0=g0)(lp, tb) for g0 in (0, 2)]
    (g_0, loss_0, _), (g_2, loss_2, _) = out
    assert list(g_2) == ["lora"] and len(g_2["lora"]) == L
    assert abs(float(loss_2) - float(loss_0)) <= 1e-5 * abs(float(loss_0))
    assert worst_rel(params_to_numpy(g_0), params_to_numpy(g_2)) <= 1e-5


class RecordingTransport(OneCardTransport):
    """The one-card transport, logging the physical endpoints of every move."""

    def __init__(self, n):
        super().__init__(n)
        self.log = []

    def shift(self, entries, perm):
        self.log.append(("shift", tuple(perm)))
        return super().shift(entries, perm)

    def gather(self, shards, owner, idx, dst):
        self.log.append(("gather", owner, dst))
        return super().gather(shards, owner, idx, dst)

    def send(self, payload, src, dst):
        self.log.append(("send", src, dst))
        return super().send(payload, src, dst)

    def deposit(self, grad_shards, owner, idx, row, src):
        self.log.append(("deposit", src, owner))
        return super().deposit(grad_shards, owner, idx, row, src)


@pytest.mark.parametrize("g0,mode", [(0, "whole"), (1, "whole"), (2, "whole"), (3, "whole"),
                                     (2, "prefetch_int8_ef")])
def test_transport_endpoints_are_physical(g0, mode):
    cfg, _, _, params, p, batch = ring_setup()
    tx = RecordingTransport(N)
    kw = dict(xent_chunk=8, kv_chunk=8, g0=g0, transport=tx)
    residual = None
    if mode != "whole":
        kw.update(prefetch_program=p.prefetch_program(), pool_dtype="int8",
                  grad_compress="int8")
        residual = [tree_map(lambda a: torch.zeros(a.shape, dtype=torch.float32), row)
                    for row in params["layers"]]
    fn = dispatch.build_roundpipe_grads_fn(cfg, N, p, **kw)
    fn(params, {k: torch.from_numpy(v) for k, v in batch.items()}, residual)
    inj, tail = g0, (g0 + N - 1) % N
    by_kind = {}
    for entry in tx.log:
        by_kind.setdefault(entry[0], []).append(entry[1:])
    assert set(by_kind["shift"]) == {(tuple(map(tuple, j_shift_perm(N, g0))),)}
    assert len(by_kind["shift"]) == 2 * len(p.tick_program(1).records)   # blocks, grads
    deposits = by_kind["deposit"]
    if mode == "whole":
        assert {dst for _, dst in by_kind["gather"]} == {inj}
        assert {src for src, _ in deposits} == {tail}
        assert {owner for owner, _ in by_kind["gather"]} == set(range(N))
        assert "send" not in by_kind
    else:
        sends = by_kind["send"]
        # uploads and the residual row leave each owner for the injection
        # worker or the tail; the compressed rows come back from the tail
        assert {src for src, dst in sends if dst in (inj, tail)} >= set(range(N)) - {inj, tail}
        assert all(src == tail or dst in (inj, tail) for src, dst in sends)
        assert {src for src, owner in deposits} == {owner for _, owner in deposits}
    assert {owner for _, owner in deposits} == set(range(N))
    assert len(deposits) == L


def test_a_rotating_searched_schedule_trains():
    """Under a 5x-slow worker 2 the searched schedule's winner rotates the
    ring (as the supervisor's rescore finds); the step trains with it, on
    the loss and the weights of the unrotated step."""
    from repro_torch.optim import OptConfig
    cfg, _, _, params, p, batch = ring_setup()
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    scale = [1.0, 1.0, 5.0, 1.0]
    assert simulator.search_schedule(p, N, device_scale=scale).program.g0 == 3
    outs = []
    for sel in ("searched", "hand"):
        scfg = StepConfig(strategy="roundpipe", partition=p, schedule=sel, device_scale=scale,
                          kv_chunk=8, xent_chunk=8, opt=OptConfig(lr=1e-2))
        step, _ = dispatch.build_roundpipe_train_step(cfg, N, scfg, B, S, plan=p)
        state = {"params": params, "opt": init_opt_state(params, scfg.opt)}
        outs.append(step(state, tb))
    (s_state, s_m), (h_state, h_m) = outs
    assert abs(float(s_m["loss"]) - float(h_m["loss"])) <= 1e-5 * float(h_m["loss"])
    assert worst_rel(params_to_numpy(h_state["params"]), params_to_numpy(s_state["params"])) \
        < 5e-3


# ---------------------------------------------------------------------------
# the chaos scenario, with the chip's harness at smoke width
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke", ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chaos_harness(tmp_path):
    cs = _chip_smoke()
    cfg = dataclasses.replace(smoke_config(get_config(ARCH)), n_layers=L)
    out = cs.run_chaos(cfg, seq=S, ckpt_dir=tmp_path, device="cpu", dtype=torch.float32,
                       lr=1e-2, save_every=2, kv_chunk=8, xent_chunk=8)
    sup, losses = out["sup"], out["losses"]
    assert out["end"] == 8 and sup.n_workers == 3
    assert [(e.step, e.kind) for e in sup.events] == [
        (2, "straggler"), (3, "straggler"), (3, "rotate"), (5, "worker_dead"),
        (5, "replan"), (5, "restore")]
    assert sup.events_of("straggler")[0].detail["worker"] == 2
    rotation = sup.events_of("rotate")[0].detail
    assert rotation["g0"] == 3 and rotation["worker"] == 2
    replan = sup.events_of("replan")[0].detail
    assert replan["n_workers"] == 3 and replan["n_microbatches"] == 3 and replan["async_ok"]
    assert sup.events_of("restore")[0].detail["resumed_at"] == 4
    assert out["ring_steps"] == {4: 5, 3: 4}            # steps 0-4, then 4-7 replayed
    assert len(losses[4]) == 2
    np.testing.assert_allclose(losses[4][1], losses[4][0], rtol=1e-4)
    rep = sup.meter.report()
    assert 0.0 < rep["goodput"] < 1.0 and rep["replay_s"] > 0 and rep["replan_s"] > 0
    assert sup.ckpt_io["written"] == 4                  # steps 1, 3, 5 (N=3) and 7
    real = [cs._real_params(s, L) for s in (out["ref_state"], out["state"])]
    assert worst_rel(params_to_numpy(real[0]), params_to_numpy(real[1])) < 5e-3


# ---------------------------------------------------------------------------
# the launcher
# ---------------------------------------------------------------------------

def _launch(*extra):
    argv = ["--arch", ARCH, "--smoke", "--strategy", "roundpipe", "--mesh", f"1x{N}",
            "--batch", "8", "--seq", "16", "--log-every", "100", "--device", "cpu", *extra]
    return train.run_training(train.build_parser().parse_args(argv))


def test_launcher_runs_the_supervisor(tmp_path, capsys):
    out = _launch("--steps", "4", "--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                  "--elastic", "--async-ckpt")
    text = capsys.readouterr().out
    assert re.search(r"^done: 4 steps in [\d.]+s on N=4; goodput 0\.\d+ \(ckpt [\d.]+s replan "
                     r"[\d.]+s replay [\d.]+s\); events=\[\]$", text, re.MULTILINE), text
    assert "async checkpoints: 2 written" in text
    assert out["steps"] == 4 and len(out["losses"]) == 4 and latest_step(tmp_path) == 3
    assert out["supervisor"].ckpt_io["written"] == 2
    # the same run under the synchronous loop lands on the same state
    plain = _launch("--steps", "4")
    assert out["losses"] == plain["losses"]
    _same(out["state"], plain["state"])


@pytest.mark.parametrize("extra,message", [
    (["--elastic"], "need --ckpt-dir"),
    (["--async-ckpt"], "need --ckpt-dir"),
    (["--elastic", "--ckpt-dir", "D", "--async-opt", "--async-steps", "2"], "drop --async-opt"),
])
def test_launcher_refuses_what_the_supervisor_cannot_run(extra, message):
    with pytest.raises(SystemExit, match=message):
        _launch("--steps", "2", *extra)
