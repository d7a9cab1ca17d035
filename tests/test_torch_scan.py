"""The port's scan entries on the CPU against the JAX reference.

On the CPU ``repro_torch.kernels.ops.rwkv_scan`` and ``ops.ssm_scan`` take
the plain PyTorch versions; they are held against both the Pallas kernels
(interpret mode) and the jnp oracles of ``repro.kernels.ref``, over the
shapes of ``tests/test_kernels.py`` (``TestRwkvScan``, ``TestSsmScan``) with
a non-zero initial state, at its tolerance (rtol = atol = 1e-4). The CUDA
kernels themselves run only on the card: ``chip_smoke.py`` holds them against
the same plain versions there. Inputs come from numpy seeds; both sides get
the same values.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.rwkv_scan import rwkv_scan as pallas_rwkv
from repro.kernels.ssm_scan import ssm_scan as pallas_ssm
from repro_torch.kernels import ops
from repro_torch.kernels.rwkv_scan import rwkv_scan as rwkv_kernel
from repro_torch.kernels.rwkv_scan import rwkv_scan_bwd as rwkv_bwd_kernel
from repro_torch.kernels.ssm_scan import ssm_scan as ssm_kernel
from repro_torch.kernels.ssm_scan import ssm_scan_bwd as ssm_bwd_kernel


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: smoke-width ops gain nothing from more, and the
    suite's parallel workers share the cores with the JAX package's
    multi-device subprocess tests."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_kernels.py, TestRwkvScan / TestSsmScan


def close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


def rwkv_inputs(seed, b, s, h, n):
    """r, k, v (normal), w in (0, 1) (a sigmoid, as the reference test), u,
    and a non-zero s0, as numpy fp32."""
    rng = np.random.default_rng(seed)
    r, k, v, wl = (rng.standard_normal((b, s, h, n)).astype(np.float32) for _ in range(4))
    w = (1 / (1 + np.exp(-wl))).astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    s0 = (0.5 * rng.standard_normal((b, h, n, n))).astype(np.float32)
    return r, k, v, w, u, s0


def ssm_inputs(seed, b, s, di, n):
    """x, dt > 0 (a softplus, as the reference test), B, C, A < 0 and a
    non-zero h0, as numpy fp32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, 1)))).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    a = (-np.exp(0.5 * rng.standard_normal((di, n)))).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((b, di, n))).astype(np.float32)
    return x, dt, bm, cm, a, h0


def torch_of(arrays):
    return [torch.from_numpy(a) for a in arrays]


# (s, h, n, chunk): tests/test_kernels.py TestRwkvScan.test_sweep, then S=1 (decode)
RWKV = [(64, 2, 16, 16), (128, 4, 32, 64), (96, 1, 64, 32), (1, 3, 64, 1)]


@pytest.mark.parametrize("s,h,n,chunk", RWKV)
def test_rwkv_scan_plain_matches_pallas_and_oracle(s, h, n, chunk):
    arrays = rwkv_inputs(s * h + n, 2, s, h, n)
    y, s_t = ops.rwkv_scan(*torch_of(arrays))
    assert y.shape == (2, s, h, n) and y.dtype == torch.float32
    assert s_t.shape == (2, h, n, n) and s_t.dtype == torch.float32
    jy, js = pallas_rwkv(*map(jnp.asarray, arrays), chunk=chunk, interpret=True)
    close(y, jy)
    close(s_t, js)
    ry, rs = jref.rwkv_scan_ref(*map(jnp.asarray, arrays))
    close(y, ry)
    close(s_t, rs)


# (s, di, n, block_d, chunk): tests/test_kernels.py TestSsmScan.test_sweep, then S=1
SSM = [(64, 32, 8, 32, 16), (128, 64, 16, 32, 64), (96, 128, 8, 64, 32), (1, 64, 16, 32, 1)]


@pytest.mark.parametrize("s,di,n,bd,chunk", SSM)
def test_ssm_scan_plain_matches_pallas_and_oracle(s, di, n, bd, chunk):
    arrays = ssm_inputs(s + di + n, 2, s, di, n)
    y, h_t = ops.ssm_scan(*torch_of(arrays))
    assert y.shape == (2, s, di) and y.dtype == torch.float32
    assert h_t.shape == (2, di, n) and h_t.dtype == torch.float32
    jy, jh = pallas_ssm(*map(jnp.asarray, arrays), block_d=bd, chunk=chunk, interpret=True)
    close(y, jy)
    close(h_t, jh)
    ry, rh = jref.ssm_scan_ref(*map(jnp.asarray, arrays))
    close(y, ry)
    close(h_t, rh)


def test_ssm_scan_takes_a_ragged_d_inner():
    """d_inner 40 with the Pallas default block_d: the Pallas kernel refuses
    it (as it refuses hymba's 3200 = 12.5 x 256), so the plain version is
    held against the jnp oracle alone."""
    arrays = ssm_inputs(7, 2, 24, 40, 16)
    with pytest.raises(ValueError, match="block_d"):
        pallas_ssm(*map(jnp.asarray, arrays), block_d=32, chunk=8, interpret=True)
    y, h_t = ops.ssm_scan(*torch_of(arrays))
    ry, rh = jref.ssm_scan_ref(*map(jnp.asarray, arrays))
    close(y, ry)
    close(h_t, rh)


def test_scans_write_the_requested_types():
    """y in the inputs' type (bf16 here) or in ``out_dtype``; the states fp32."""
    r, k, v, w, u, s0 = torch_of(rwkv_inputs(3, 1, 5, 2, 16))
    y, s_t = ops.rwkv_scan(*(t.bfloat16() for t in (r, k, v, w)), u, s0)
    assert y.dtype == torch.bfloat16 and s_t.dtype == torch.float32
    x, dt, bm, cm, a, h0 = torch_of(ssm_inputs(4, 1, 5, 8, 4))
    bf = [t.bfloat16() for t in (x, dt, bm, cm)]
    y, h_t = ops.ssm_scan(*bf, a, h0)
    assert y.dtype == torch.bfloat16 and h_t.dtype == torch.float32
    y32, _ = ops.ssm_scan(*bf, a, h0, out_dtype=torch.float32)
    assert y32.dtype == torch.float32
    assert torch.equal(y32.bfloat16(), y)


def test_cpu_scans_are_differentiable_against_jax_grad():
    """On the CPU autograd runs through the plain versions; their gradients
    match jax.grad of the jnp oracles."""
    arrays = rwkv_inputs(5, 1, 6, 2, 16)
    ts = [t.requires_grad_() for t in torch_of(arrays)]
    gy = np.random.default_rng(6).standard_normal((1, 6, 2, 16)).astype(np.float32)
    y, s_t = ops.rwkv_scan(*ts)
    grads = torch.autograd.grad((y * torch.from_numpy(gy)).sum() + s_t.sum(), ts)
    want = jax.grad(lambda *xs: (jref.rwkv_scan_ref(*xs)[0] * gy).sum()
                    + jref.rwkv_scan_ref(*xs)[1].sum(), argnums=tuple(range(6)))(
        *map(jnp.asarray, arrays))
    for g, w in zip(grads, want):
        close(g, w)

    arrays = ssm_inputs(8, 1, 6, 8, 4)
    ts = [t.requires_grad_() for t in torch_of(arrays)]
    gy = np.random.default_rng(9).standard_normal((1, 6, 8)).astype(np.float32)
    y, h_t = ops.ssm_scan(*ts)
    grads = torch.autograd.grad((y * torch.from_numpy(gy)).sum() + h_t.sum(), ts)
    want = jax.grad(lambda *xs: (jref.ssm_scan_ref(*xs)[0] * gy).sum()
                    + jref.ssm_scan_ref(*xs)[1].sum(), argnums=tuple(range(6)))(
        *map(jnp.asarray, arrays))
    for g, w in zip(grads, want):
        close(g, w)


def test_cpu_tensors_take_the_plain_version_and_never_the_kernel():
    rwkv_args = torch_of(rwkv_inputs(10, 1, 4, 1, 16))
    ssm_args = torch_of(ssm_inputs(11, 1, 4, 8, 4))
    before = (rwkv_kernel.launches, ssm_kernel.launches)
    ops.rwkv_scan(*rwkv_args)
    ops.ssm_scan(*ssm_args)
    assert (rwkv_kernel.launches, ssm_kernel.launches) == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        rwkv_kernel(*rwkv_args)
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssm_kernel(*ssm_args)
    assert (rwkv_kernel.launches, ssm_kernel.launches) == before


def test_off_cpu_scans_refuse_gradients_by_name():
    """Off the CPU a scan whose inputs need gradients goes through its
    autograd Function (``RwkvScan``, ``SsmScan``) to the forward and backward
    kernels, with no fallback: with meta tensors standing in for the card's,
    the Function's forward calls the kernel wrapper, which raises its ``CUDA
    tensors`` error before any launch. Without gradients the entries call the
    wrapper directly, outside any Function."""
    def meta(arrays):
        return [torch.empty(a.shape, device="meta") for a in arrays]

    def through_function(info, module):
        return any(e.name == "forward" and e.path.name == module for e in info.traceback)

    rwkv_args = meta(rwkv_inputs(12, 1, 4, 1, 16))
    ssm_args = meta(ssm_inputs(13, 1, 4, 8, 4))
    kernels = (rwkv_kernel, ssm_kernel, rwkv_bwd_kernel, ssm_bwd_kernel)
    before = [k.launches for k in kernels]
    rwkv_args[1].requires_grad_()
    ssm_args[0].requires_grad_()
    with pytest.raises(ValueError, match="CUDA tensors") as info:
        ops.rwkv_scan(*rwkv_args)
    assert through_function(info, "rwkv_scan.py")
    with pytest.raises(ValueError, match="CUDA tensors") as info:
        ops.ssm_scan(*ssm_args)
    assert through_function(info, "ssm_scan.py")
    with torch.no_grad():
        with pytest.raises(ValueError, match="CUDA tensors") as info:
            ops.rwkv_scan(*rwkv_args)
        assert not through_function(info, "rwkv_scan.py")
        with pytest.raises(ValueError, match="CUDA tensors") as info:
            ops.ssm_scan(*ssm_args)
        assert not through_function(info, "ssm_scan.py")
    assert [k.launches for k in kernels] == before
