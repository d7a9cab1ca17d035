"""CPU rehearsal of the scan kernels' decompositions (``csrc/rwkv_scan.cu``,
``csrc/ssm_scan.cu``).

``ref.rwkv_scan_tiled_ref`` and ``ref.ssm_scan_tiled_ref`` compute the scans
the way the kernels split them: the state padded to a width of 16, 32 or 64,
the RWKV6 state in 8 row groups of 4-column tiles with Σ r u k formed once a
step, the Mamba state split over 4 lanes a channel with the decay as
2^(dt A log2 e), and every sum in the kernels' order (a thread's terms one
after another, then the xor shuffles). Each is held against the plain
version and against the Pallas kernel in interpret mode at
``tests/test_kernels.py``'s tolerance (rtol = atol = 1e-4), on the edges of
the tiling: ragged S, N and d_inner, a non-zero initial state, decays near 0
and near 1. The wrappers' launch geometry (state width and chunk) is checked
at the main shapes.
Inputs come from numpy seeds; both sides get the same values.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.rwkv_scan import rwkv_scan as pallas_rwkv
from repro.kernels.ssm_scan import ssm_scan as pallas_ssm
from repro_torch.kernels import ref
from repro_torch.kernels import rwkv_scan as rwkv_mod
from repro_torch.kernels import ssm_scan as ssm_mod


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: smoke-width ops gain nothing from more, and the
    suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = dict(rtol=1e-4, atol=1e-4)     # tests/test_kernels.py, TestRwkvScan / TestSsmScan


def close(got, want):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **TOL)


def rwkv_inputs(seed, b, s, h, n, decays):
    """r, k, v, u normal; w in (0, 1): a sigmoid, or squeezed near 0 or near
    1; a non-zero s0; numpy fp32."""
    rng = np.random.default_rng(seed)
    r, k, v, z = (rng.standard_normal((b, s, h, n)).astype(np.float32) for _ in range(4))
    sig = 1 / (1 + np.exp(-z))
    w = {"sigmoid": sig, "near0": 1e-3 * sig, "near1": 1 - 1e-3 * sig}[decays]
    u = rng.standard_normal((h, n)).astype(np.float32)
    s0 = (0.5 * rng.standard_normal((b, h, n, n))).astype(np.float32)
    return r, k, v, w.astype(np.float32), u, s0


def ssm_inputs(seed, b, s, di, n, decays):
    """x, B, C normal; dt > 0 (a softplus); A < 0 scaled so that exp(dt A)
    is spread over (0, 1), near 0 or near 1; a non-zero h0; numpy fp32."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, 1)))).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    scale = {"spread": 1.0, "near0": 50.0, "near1": 1e-3}[decays]
    a = (-scale * np.exp(0.5 * rng.standard_normal((di, n)))).astype(np.float32)
    h0 = (0.5 * rng.standard_normal((b, di, n))).astype(np.float32)
    return x, dt, bm, cm, a, h0


def torch_of(arrays):
    return [torch.from_numpy(a) for a in arrays]


# (n, s, h, decays): n on and off the widths 16/32/64 (1 row a group at n = 1;
# pieces of 2 and 4 rows; two pieces at 64), s = 1, a chunk of 32 - 1 and + 1,
# two chunks + 7, and a single (batch, head) pair
RWKV = [(1, 33, 2, "sigmoid"), (4, 31, 3, "near0"), (17, 71, 2, "near1"),
        (33, 1, 2, "sigmoid"), (64, 71, 1, "near1"), (64, 33, 2, "near0")]


@pytest.mark.parametrize("n,s,h,decays", RWKV)
def test_rwkv_tiled_matches_plain_and_pallas(n, s, h, decays):
    b = 1 if h == 1 else 2
    arrays = rwkv_inputs(n * 100 + s, b, s, h, n, decays)
    y, s_t = ref.rwkv_scan_tiled_ref(*torch_of(arrays), chunk=rwkv_mod.geometry(n)[1])
    assert y.shape == (b, s, h, n) and s_t.shape == (b, h, n, n)
    py, ps = ref.rwkv_scan_ref(*torch_of(arrays))
    close(y, py.numpy())
    close(s_t, ps.numpy())
    jy, js = pallas_rwkv(*map(jnp.asarray, arrays), chunk=s, interpret=True)
    close(y, jy)
    close(s_t, js)


# (n, s, di, decays): n on and off the widths, s on and off the 64-step chunk
# (32 at n > 32), d_inner 1, 31, 33 and 3201 (the Pallas kernel takes only a
# d_inner its block divides; 3201 is held against the plain version alone)
SSM = [(1, 63, 1, "spread"), (4, 65, 31, "near0"), (17, 135, 33, "near1"),
       (33, 31, 40, "spread"), (64, 33, 17, "near1"), (16, 1, 3201, "spread"),
       (16, 71, 3201, "near0")]


@pytest.mark.parametrize("n,s,di,decays", SSM)
def test_ssm_tiled_matches_plain_and_pallas(n, s, di, decays):
    arrays = ssm_inputs(n * 1000 + s + di, 2, s, di, n, decays)
    y, h_t = ref.ssm_scan_tiled_ref(*torch_of(arrays))
    assert y.shape == (2, s, di) and h_t.shape == (2, di, n)
    py, ph = ref.ssm_scan_ref(*torch_of(arrays))
    close(y, py.numpy())
    close(h_t, ph.numpy())
    if di <= 256:
        jy, jh = pallas_ssm(*map(jnp.asarray, arrays), block_d=di, chunk=s, interpret=True)
        close(y, jy)
        close(h_t, jh)


def test_tiled_refs_keep_the_input_type():
    """bf16 in: y in bf16 (rwkv) or in the requested type (ssm), the state
    fp32, as the plain versions return them."""
    r, k, v, w, u, s0 = torch_of(rwkv_inputs(1, 2, 5, 2, 16, "sigmoid"))
    y, s_t = ref.rwkv_scan_tiled_ref(*(t.bfloat16() for t in (r, k, v, w)), u, s0)
    assert y.dtype == torch.bfloat16 and s_t.dtype == torch.float32
    x, dt, bm, cm, a, h0 = torch_of(ssm_inputs(2, 2, 5, 8, 16, "spread"))
    y, h_t = ref.ssm_scan_tiled_ref(*(t.bfloat16() for t in (x, dt, bm, cm)), a, h0,
                                    out_dtype=torch.float32)
    assert y.dtype == torch.float32 and h_t.dtype == torch.float32


@pytest.mark.parametrize("n,width", [(1, 16), (16, 16), (17, 32), (32, 32), (33, 64), (64, 64)])
def test_scan_width(n, width):
    assert ref.scan_width(n) == width
    assert rwkv_mod.geometry(n) == (width, 32)
    assert ssm_mod.geometry(n) == (width, 32 if width == 64 else 64)


@pytest.mark.parametrize("s,chunks", [(1024, 32), (1, 1)])
def test_rwkv_geometry_at_rwkv6_7b(s, chunks):
    """rwkv6-7b's prefill and decode (N=64): the full width, 32-step chunks."""
    width, chunk = rwkv_mod.geometry(64)
    assert (width, chunk) == (64, 32)
    assert -(-s // chunk) == chunks


@pytest.mark.parametrize("s,chunks", [(1536, 24), (1, 1)])
def test_ssm_geometry_at_hymba_1_5b(s, chunks):
    """hymba-1.5b's prefill and decode (N=16): width 16, 64-step chunks."""
    width, chunk = ssm_mod.geometry(16)
    assert (width, chunk) == (16, 64)
    assert -(-s // chunk) == chunks
