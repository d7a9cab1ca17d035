"""The port's plan layer against the reference's, and the port's isolation.

``repro_torch/core/{partition,schedule,transfer,plan,simulator}.py`` and
``repro_torch/data/pipeline.py`` are copies of the reference's modules: each
top-level definition must equal the original's (compared as syntax trees),
apart from the few that must differ because the original imports JAX or the
reference (named in ``DIFFERS``). The compiled plans must then agree exactly
with the reference's: ``describe()``, ``tick_program(1).to_json()``,
``pool_layout``, ``default_layer_costs`` and the simulated bubble, for the
plans the ring tests run (all at N=4).
"""
import ast
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import jax
import pytest
import torch

from repro.configs import smoke_config as j_smoke_config
from repro.core import partition as j_partition
from repro.core import plan as j_plan
from repro.core import simulator as j_simulator
from repro.models.config import REGISTRY as J_REGISTRY
from repro.models.config import get_config as j_get_config
from repro_torch.configs import smoke_config
from repro_torch.core import partition, plan
from repro_torch.core import simulator
from repro_torch.models.config import ModelConfig, get_config


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: smoke-width ops gain nothing from more, and the
    suite's parallel workers share the cores with the JAX package's
    multi-device subprocess tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


ROOT = Path(__file__).resolve().parents[1]
COPIES = ["core/partition.py", "core/schedule.py", "core/transfer.py", "core/plan.py",
          "core/simulator.py", "data/pipeline.py"]
DIFFERS = {"core/plan.py": {"default_layer_costs"},
           "data/pipeline.py": {"sharded_batches"}}
N = 4


def _definitions(path):
    tree = ast.parse(path.read_text())
    out = {}
    for i, node in enumerate(tree.body):
        name = getattr(node, "name", None) or f"<statement {i}>"
        out[name] = ast.dump(node)
    return out


@pytest.mark.parametrize("rel", COPIES)
def test_copies_equal_the_reference(rel):
    ref = _definitions(ROOT / "src" / "repro" / rel)
    got = _definitions(ROOT / "src" / "repro_torch" / rel)
    assert set(ref) == set(got)
    differ = {name for name in ref if ref[name] != got[name]}
    assert differ == DIFFERS.get(rel, set())


def _port_cfg(j_cfg):
    return ModelConfig(**dataclasses.asdict(j_cfg))


def _dense(j_cfg):
    return j_cfg.block_kind == "attn" and j_cfg.attn_kind == "gqa" and not j_cfg.is_moe


DENSE = sorted(name for name, c in J_REGISTRY.items() if _dense(c))


@pytest.mark.parametrize("arch", DENSE)
def test_default_layer_costs_match_every_dense_config(arch):
    j_cfg = j_get_config(arch)

    def costs(mod, cfg, **kw):
        return [dataclasses.asdict(c) for c in mod.default_layer_costs(cfg, **kw)]

    for kw in ({}, {"head_stage": False}, {"pool_dtype": "int8"}):
        assert costs(plan, _port_cfg(j_cfg), **kw) == costs(j_plan, j_cfg, **kw)


RECURRENT = ["rwkv6-7b", "hymba-1.5b"]


@pytest.mark.parametrize("arch", RECURRENT)
def test_layer_costs_and_param_shapes_match_the_recurrent_configs(arch):
    """The rwkv6 and hybrid layers at full width: the cost model, counted
    from the port's ``init_layer``, equals the reference's, and the port's
    ``init_params`` on the meta device has the shapes and dtypes of the
    reference's ``abstract_params``, leaf for leaf (layers stacked)."""
    from repro.models import transformer as JT
    from repro_torch.models import transformer as T

    j_cfg = j_get_config(arch)

    def costs(mod, cfg, **kw):
        return [dataclasses.asdict(c) for c in mod.default_layer_costs(cfg, **kw)]

    for kw in ({}, {"head_stage": False}, {"pool_dtype": "int8"}):
        assert costs(plan, _port_cfg(j_cfg), **kw) == costs(j_plan, j_cfg, **kw)

    def leaves(node, path=()):
        """(path, (shape, dtype)) in the reference's flatten order (sorted keys)."""
        if isinstance(node, dict):
            for key in sorted(node):
                yield from leaves(node[key], path + (key,))
        else:
            yield path, node

    port = T.init_params(get_config(arch), None, device="meta")
    layers = port.pop("layers")
    port["layers"] = {path: (len(layers),) + tuple(leaf.shape) for path, leaf in
                      leaves(layers[0])}
    got = [(path, tuple(leaf.shape), str(leaf.dtype).removeprefix("torch."))
           for path, leaf in leaves({k: v for k, v in port.items() if k != "layers"})]
    got += [(("layers",) + path, port["layers"][path], str(leaf.dtype).removeprefix("torch."))
            for path, leaf in leaves(layers[0])]
    got.sort()
    want = sorted((tuple(k.key for k in path), tuple(leaf.shape), str(leaf.dtype))
                  for path, leaf in jax.tree_util.tree_flatten_with_path(
                      JT.abstract_params(j_cfg))[0])
    assert got == want


def _cfg(n_layers=None, smoke=True):
    j_cfg = j_get_config("qwen3-1.7b")
    cfg = get_config("qwen3-1.7b")
    if smoke:
        j_cfg, cfg = j_smoke_config(j_cfg), smoke_config(cfg)
    if n_layers is not None:
        j_cfg = dataclasses.replace(j_cfg, n_layers=n_layers)
        cfg = dataclasses.replace(cfg, n_layers=n_layers)
    return j_cfg, cfg


def _uniform(mod, part_mod, cfg):
    part = mod.uniform_partition(cfg.n_layers)
    costs = [part_mod.LayerCost(1.0, 2.0) for _ in range(cfg.n_layers)]
    return mod.compile_plan(part, costs, n_workers=N, n_body_layers=cfg.n_layers)


def _uneven(mod, part_mod, cfg):
    part = part_mod.Partition(fwd_stages=((0, 1), (2, 3)),
                              bwd_stages=((4, 5, 6), (3,), (0, 1, 2)),
                              t_max=9.0, objective=0.0, n_stages=5)
    costs = [part_mod.LayerCost(1.0, 2.0) for _ in range(6)] + [part_mod.LayerCost(2.0, 4.0)]
    return mod.compile_plan(part, costs, n_workers=N, n_body_layers=cfg.n_layers)


def plan_pair(kind):
    """(reference plan, port plan) for one of the ring tests' plans."""
    if kind == "auto-full":
        j_cfg, cfg = _cfg(smoke=False)
    elif kind == "auto-smoke":
        j_cfg, cfg = _cfg()
    elif kind == "auto-7":
        j_cfg, cfg = _cfg(7)
    elif kind == "uniform-8":
        j_cfg, cfg = _cfg(8)
        return _uniform(j_plan, j_partition, j_cfg), _uniform(plan, partition, cfg)
    elif kind == "uniform-8-cfg":
        j_cfg, cfg = _cfg(8)
        return (j_plan.plan_from_config(j_cfg, N, partition=j_plan.uniform_partition(8)),
                plan.plan_from_config(cfg, N, partition=plan.uniform_partition(8)))
    else:
        j_cfg, cfg = _cfg(6)
        return _uneven(j_plan, j_partition, j_cfg), _uneven(plan, partition, cfg)
    return j_plan.plan_from_config(j_cfg, N), plan.plan_from_config(cfg, N)


PLANS = ["auto-full", "auto-smoke", "auto-7", "uniform-8", "uniform-8-cfg", "uneven-6"]


@pytest.mark.parametrize("kind", PLANS)
def test_plans_match_the_reference(kind):
    ref, got = plan_pair(kind)
    got.validate()
    assert got.describe() == ref.describe()
    assert got.tick_program(1).to_json() == ref.tick_program(1).to_json()
    assert plan.pool_layout(got.n_layers, N) == j_plan.pool_layout(ref.n_layers, N)
    assert got.stage_bytes == ref.stage_bytes
    assert (simulator.simulate_plan(got, N, round_size=N).bubble_ratio
            == j_simulator.simulate_plan(ref, N, round_size=N).bubble_ratio)


def test_pool_layout_matches_the_reference():
    for layers in range(1, 30):
        for n in range(1, 9):
            assert plan.pool_layout(layers, n) == j_plan.pool_layout(layers, n)


def test_unported_parts_of_the_plan_layer_raise():
    """The plan layer generates rotated tick programs (``g0 != 0``), which
    ``search_schedule`` may pick; the ring runs them now, and a program whose
    rotation names no worker of the plan raises."""
    from repro_torch.core import dispatch
    _, cfg = _cfg(7)
    p = plan.plan_from_config(cfg, N)
    assert simulator.search_schedule(p).program.g0 == 0
    assert simulator.search_schedule(p, device_scale=[1.0, 1.0, 5.0, 1.0]).program.g0 == 3
    for g0 in range(N):
        program = p.tick_program(1, 2, g0=g0)
        assert dispatch._check_program(program, p, 1, 2) is program
    bad = dataclasses.replace(p.tick_program(1, 2), g0=N)
    with pytest.raises(ValueError, match=f"g0={N} out of range"):
        dispatch._check_program(bad, p, 1, 2)


def test_port_trains_with_jax_and_the_reference_blocked():
    port = ROOT / "src" / "repro_torch"
    modules = sorted(".".join(p.relative_to(port.parent).with_suffix("").parts)
                     for p in port.rglob("*.py"))
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "from repro_torch.launch import train\n"
        "out = train.main(['--arch', 'qwen3-1.7b', '--smoke', '--strategy', 'roundpipe',\n"
        "                  '--mesh', '1x4', '--steps', '1', '--batch', '4', '--seq', '8',\n"
        "                  '--device', 'cpu'])\n"
        "assert len(out['losses']) == 1\n"
        "print('ISOLATED_OK')\n")
    env = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
    r = subprocess.run([sys.executable, "-c", code], cwd=ROOT, env=env, capture_output=True,
                       text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert "ISOLATED_OK" in r.stdout
