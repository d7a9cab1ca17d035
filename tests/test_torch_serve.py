"""The port's serving entry point and its isolation from JAX.

``python -m repro_torch.launch.serve`` runs on the CPU only when asked to;
nothing under ``src/repro_torch/``, nor ``chip_smoke.py``, imports ``jax`` or
the reference package ``repro``; ``chip_smoke.py`` refuses to run without a
card.
"""
import os
import re
import shutil
import subprocess
import sys
from pathlib import Path

import pytest
import torch


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
PORT = ROOT / "src" / "repro_torch"
ENV = {**os.environ, "PYTHONPATH": str(ROOT / "src"), "OMP_NUM_THREADS": "1"}
FORBIDDEN = re.compile(r"^\s*(?:import|from)\s+(jax|repro)(?:\.|\s|,|$)", re.MULTILINE)


def run(*args, cwd=ROOT):
    return subprocess.run([sys.executable, *args], cwd=cwd, env=ENV, capture_output=True,
                          text=True, timeout=120)


def test_serve_smoke_on_cpu():
    r = run("-m", "repro_torch.launch.serve", "--arch", "qwen3-1.7b", "--smoke",
            "--device", "cpu", "--batch", "2", "--prompt-len", "8", "--gen", "4")
    assert r.returncode == 0, r.stderr
    lines = r.stdout.splitlines()
    assert lines[0].startswith("prefill: 2x8 in ")
    assert lines[1].startswith("decode: 4 steps in ")
    ids = eval(lines[2].removeprefix("generated token ids (first sequence): "))
    assert len(ids) == 4 and all(0 <= i < 128 for i in ids)


def test_serve_refuses_the_cpu_unless_asked():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present, so the default device is usable")
    r = run("-m", "repro_torch.launch.serve", "--arch", "qwen3-1.7b", "--smoke")
    assert r.returncode != 0
    assert "CUDA is not available" in r.stderr and "--device cpu" in r.stderr
    assert "prefill:" not in r.stdout


def test_serve_refuses_a_multi_card_mesh():
    r = run("-m", "repro_torch.launch.serve", "--arch", "qwen3-1.7b", "--smoke",
            "--device", "cpu", "--mesh", "2x1")
    assert r.returncode != 0 and "multi-card serving is not ported" in r.stderr


def test_no_source_of_the_port_imports_jax_or_the_reference():
    sources = sorted(PORT.rglob("*.py")) + [ROOT / "chip_smoke.py"]
    assert len(sources) > 15
    offenders = {str(p.relative_to(ROOT)): FORBIDDEN.findall(p.read_text()) for p in sources}
    assert {p: m for p, m in offenders.items() if m} == {}


def test_port_imports_and_serves_with_jax_and_the_reference_blocked():
    modules = sorted(".".join(p.relative_to(PORT.parent).with_suffix("").parts)
                     for p in PORT.rglob("*.py"))
    assert {"repro_torch.checkpoint.store", "repro_torch.runtime.fault_tolerance",
            "repro_torch.runtime.supervisor",
            "repro_torch.optim.async_opt", "repro_torch.core.consistency",
            "repro_torch.configs.__init__",
            *(f"repro_torch.configs.{c}" for c in ("llama_3_1_8b", "qwen3_32b", "starcoder2_7b",
                                                   "stablelm_12b", "gemma_2b",
                                                   "nemotron_4_340b"))} <= set(modules)
    code = (
        "import sys, importlib\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['repro'] = None\n"
        f"for m in {modules!r}:\n"
        "    importlib.import_module(m.removesuffix('.__init__'))\n"
        "from repro_torch.launch import serve\n"
        "out = serve.main(['--arch', 'qwen3-1.7b', '--smoke', '--device', 'cpu',\n"
        "                  '--batch', '1', '--prompt-len', '4', '--gen', '2'])\n"
        "assert tuple(out.tokens.shape) == (1, 2)\n"
        "out = serve.main(['--arch', 'gemma-2b', '--smoke', '--device', 'cpu',\n"
        "                  '--batch', '1', '--prompt-len', '4', '--gen', '2'])\n"
        "assert tuple(out.tokens.shape) == (1, 2)\n"
        f"sys.path.insert(0, {str(ROOT)!r})\n"
        "import chip_smoke\n"
        "print('ISOLATED_OK')\n")
    r = run("-c", code)
    assert r.returncode == 0, r.stderr
    assert "ISOLATED_OK" in r.stdout


def test_chip_smoke_refuses_to_run_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    r = run(str(ROOT / "chip_smoke.py"))
    assert r.returncode != 0 and r.stdout == ""
    alone = tmp_path / "chip_smoke.py"            # outside the repository, with nothing of it
    shutil.copy(ROOT / "chip_smoke.py", alone)
    r = run(str(alone), cwd=tmp_path)
    assert r.returncode != 0 and r.stdout == ""
