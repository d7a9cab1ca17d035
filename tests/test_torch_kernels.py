"""The port's attention entries on the CPU against the JAX reference.

On the CPU ``repro_torch.kernels.ops`` takes the plain PyTorch versions; they
are held against both the Pallas kernels (interpret mode) and the jnp
oracles of ``repro.kernels.ref``, over the shapes of ``tests/test_kernels.py``
at its tolerances (fp32 2e-5, bf16 2e-2). The CUDA kernels themselves run
only on the card: ``chip_smoke.py`` holds them against the same plain
versions there. Inputs come from numpy seeds; both sides get the same values.
"""
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro_torch.kernels import _build, ops
from repro_torch.kernels.decode_attention import decode_attention as decode_kernel
from repro_torch.kernels.flash_attention import flash_attention as flash_kernel


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: smoke-width ops gain nothing from more, and the
    suite's parallel workers share the cores with the JAX package's
    multi-device subprocess tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = {"float32": dict(rtol=2e-5, atol=2e-5), "bfloat16": dict(rtol=2e-2, atol=2e-2)}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}


def make(seed, shapes, dtype):
    """The same values as (jnp arrays, torch tensors), rounded to ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32) for s in shapes]
    js = [jnp.asarray(a).astype(JNP[dtype]) for a in arrs]
    ts = [torch.from_numpy(np.array(j.astype(jnp.float32))).to(TORCH[dtype]) for j in js]
    return js, ts


def close(got, want, dtype):
    np.testing.assert_allclose(got.float().numpy(), np.asarray(want, np.float32),
                               **TOL[dtype])


# (b, s, h, kh, dh, dv, causal, window, block_q, block_k, dtype) from tests/test_kernels.py
FLASH = ([(2, s, h, kh, d, d, True, None, bq, bk, dt)
          for dt in ("float32", "bfloat16")
          for s, h, kh, d, bq, bk in [(128, 4, 4, 32, 64, 64), (256, 8, 2, 16, 64, 128),
                                      (192, 4, 1, 64, 64, 64), (128, 2, 2, 48, 32, 32)]]
         + [(1, 256, 4, 2, 32, 32, True, w, 64, 64, "float32") for w in (32, 100, 1000)]
         + [(2, 128, 4, 4, 32, 32, False, None, 64, 64, "float32"),
            (1, 128, 4, 4, 40, 32, True, None, 64, 64, "float32")])


@pytest.mark.parametrize("b,s,h,kh,dh,dv,causal,window,bq,bk,dtype", FLASH)
def test_flash_attention_plain_matches_pallas_and_oracle(b, s, h, kh, dh, dv, causal, window,
                                                         bq, bk, dtype):
    (jq, jk, jv), (tq, tk, tv) = make(s * h + dh, [(b, s, h, dh), (b, s, kh, dh),
                                                   (b, s, kh, dv)], dtype)
    got = ops.flash_attention(tq, tk, tv, causal=causal, sliding_window=window)
    assert got.dtype == TORCH[dtype] and got.shape == (b, s, h, dv)
    close(got, pallas_flash(jq, jk, jv, causal=causal, sliding_window=window, block_q=bq,
                            block_k=bk, interpret=True), dtype)
    close(got, jref.flash_attention_ref(jq, jk, jv, causal=causal, sliding_window=window),
          dtype)


# (b, s, h, kh, dh, dv, n_valid, block_k, dtype) from tests/test_kernels.py
DECODE = ([(2, s, h, kh, d, d, [s, s // 3], bk, dt)
           for dt in ("float32", "bfloat16")
           for s, h, kh, d, bk in [(512, 8, 2, 32, 128), (1024, 4, 4, 64, 256),
                                   (384, 8, 1, 16, 128)]]
          + [(1, 256, 4, 2, 32, 32, 1, 64, "float32")])


@pytest.mark.parametrize("b,s,h,kh,dh,dv,n_valid,bk,dtype", DECODE)
def test_decode_attention_plain_matches_pallas_and_oracle(b, s, h, kh, dh, dv, n_valid, bk,
                                                          dtype):
    (jq, jk, jv), (tq, tk, tv) = make(s + h + dh, [(b, h, dh), (b, s, kh, dh),
                                                   (b, s, kh, dv)], dtype)
    if isinstance(n_valid, int):
        jn, tn = jnp.int32(n_valid), n_valid
    else:
        jn, tn = jnp.array(n_valid, jnp.int32), torch.tensor(n_valid, dtype=torch.int32)
    got = ops.decode_attention(tq, tk, tv, tn)
    assert got.dtype == TORCH[dtype] and got.shape == (b, h, dv)
    close(got, pallas_decode(jq, jk, jv, jn, block_k=bk, interpret=True), dtype)
    close(got, jref.decode_attention_ref(jq, jk, jv, jn), dtype)


def test_decode_attention_value_dim_differs():
    """Dv != Dh: held against the Pallas kernel only, because the jnp oracle
    reshapes its output with Dh and fails there."""
    (jq, jk, jv), (tq, tk, tv) = make(5, [(2, 8, 40), (2, 96, 2, 40), (2, 96, 2, 32)],
                                      "float32")
    got = ops.decode_attention(tq, tk, tv, torch.tensor([96, 10], dtype=torch.int32))
    assert got.shape == (2, 8, 32)
    close(got, pallas_decode(jq, jk, jv, jnp.array([96, 10], jnp.int32), block_k=32,
                             interpret=True), "float32")


def test_cpu_tensors_take_the_plain_version_and_never_the_kernel():
    _, (q, k, v) = make(0, [(1, 16, 2, 8), (1, 16, 2, 8), (1, 16, 2, 8)], "float32")
    before = (flash_kernel.launches, decode_kernel.launches)
    ops.flash_attention(q, k, v)
    ops.decode_attention(q[:, 0], k, v, 3)
    assert (flash_kernel.launches, decode_kernel.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        flash_kernel(q, k, v)
    with pytest.raises(ValueError, match="CUDA tensors"):
        decode_kernel(q[:, 0], k, v, 3)
    assert (flash_kernel.launches, decode_kernel.launches) == before


def test_kernel_wrappers_refuse_autograd_inputs():
    _, (q, k, v) = make(1, [(1, 16, 2, 8), (1, 16, 2, 8), (1, 16, 2, 8)], "float32")
    q.requires_grad_(True)
    with pytest.raises(RuntimeError, match="forward only"):
        flash_kernel(q, k, v)
    with pytest.raises(RuntimeError, match="forward only"):
        decode_kernel(q[:, 0], k, v, 3)


def test_build_raises_when_nvcc_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(_build, "_nvcc", lambda: "false")   # a compiler that always fails
    with pytest.raises(RuntimeError, match="nvcc failed for flash_attention"):
        _build.build(("flash_attention",))
    assert list(tmp_path.iterdir()) == []


def test_build_is_cached_by_a_hash_of_the_sources(tmp_path, monkeypatch):
    csrc = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, csrc)
    monkeypatch.setattr(_build, "CSRC", csrc)
    monkeypatch.setattr(_build, "BUILD_DIR", tmp_path / "build")
    (tmp_path / "build").mkdir()
    for name in _build.KERNELS:
        _build.library_path(name).write_bytes(b"")
    assert _build.build() == {}                            # built already: nothing to do
    before = {n: _build.library_path(n) for n in _build.KERNELS}
    with open(csrc / "common.cuh", "a") as f:              # a shared header changes
        f.write("// edited\n")
    assert all(_build.library_path(n) != before[n] for n in _build.KERNELS)
