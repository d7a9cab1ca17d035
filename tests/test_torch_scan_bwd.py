"""The scans' backward: the plain versions against the JAX reference, the
kernels' decompositions, and the autograd Functions, on the CPU.

``ref.rwkv_scan_bwd_ref`` and ``ref.ssm_scan_bwd_ref`` (explicit reverse
walks over time) against ``jax.vjp`` of the reference's
``repro.kernels.ref.rwkv_scan_ref`` and ``ssm_scan_ref`` over all six inputs,
with cotangents on y and on the final state, non-zero initial states, decays
near 0 and near 1, and ragged N, S and d_inner; and against torch autograd of
the port's plain forwards. Inputs come from numpy seeds; fp32, rtol = atol =
1e-4. ``ref.*_bwd_tiled_ref`` (the
kernels' local, carry and walk passes over chunks, blocks of channels and the
order their partials are added in) against the plain backwards, at the
wrappers' ``bwd_geometry`` and at chunks of 4 and 8 steps. ``RwkvScan`` and ``SsmScan`` run
with the plain callables: their gradients equal autograd of the plain
forward, also when the final state's gradient never arrives. The backward
wrappers take CUDA tensors only and count nothing else. The CUDA kernels
themselves run only on the card (``chip_smoke.py``).
"""
from unittest import mock

import jax
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro_torch.kernels import ref
from repro_torch.kernels.rwkv_scan import RwkvScan, rwkv_scan_bwd
from repro_torch.kernels.rwkv_scan import bwd_geometry as rwkv_geometry
from repro_torch.kernels.ssm_scan import SsmScan, ssm_scan_bwd
from repro_torch.kernels.ssm_scan import bwd_geometry as ssm_geometry

TOL = 1e-4
RWKV_NAMES = ("r", "k", "v", "w", "u", "s0")
SSM_NAMES = ("x", "dt", "B", "C", "a", "h0")


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One intra-op thread: these shapes gain nothing from more, and the
    suite's parallel workers share the cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, want, name):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, name
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL, err_msg=name)


def rwkv_case(seed, b, s, h, n, decays):
    """Inputs (r, k, v, w, u, s0) and cotangents (dy, dS_T), fp32 numpy.
    ``near1``: the model's decays (w ~ 0.9975); ``near0``: w = exp(-exp(3 +
    z)), most of them below 1e-8; ``sigmoid`` in between."""
    rng = np.random.default_rng(seed)
    r, k, v = (rng.standard_normal((b, s, h, n)).astype(np.float32) for _ in range(3))
    z = rng.standard_normal((b, s, h, n))
    w = {"near1": np.exp(-np.exp(-6.0 + 0.6 * z)), "near0": np.exp(-np.exp(3.0 + z)),
         "sigmoid": 1.0 / (1.0 + np.exp(-z))}[decays].astype(np.float32)
    u = rng.standard_normal((h, n)).astype(np.float32)
    s0 = rng.standard_normal((b, h, n, n)).astype(np.float32)
    dy = rng.standard_normal((b, s, h, n)).astype(np.float32)
    ds_t = rng.standard_normal((b, h, n, n)).astype(np.float32)
    return (r, k, v, w, u, s0), (dy, ds_t)


def ssm_case(seed, b, s, di, n, decays):
    """Inputs (x, dt, B, C, a, h0) and cotangents (dy, dh_T), fp32 numpy; A
    scaled for decays near 1 (|A| ~ 1e-3), random (|A| ~ 1) or near 0 (|A| ~
    50: e^(dt A) underflows)."""
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((b, s, di)).astype(np.float32)
    dt = np.log1p(np.exp(rng.standard_normal((b, s, 1)))).astype(np.float32)
    bm, cm = (rng.standard_normal((b, s, n)).astype(np.float32) for _ in range(2))
    scale = {"near1": 1e-3, "random": 1.0, "near0": 50.0}[decays]
    a = (-np.exp(0.5 * rng.standard_normal((di, n))) * scale).astype(np.float32)
    h0 = rng.standard_normal((b, di, n)).astype(np.float32)
    dy = rng.standard_normal((b, s, di)).astype(np.float32)
    dh_t = rng.standard_normal((b, di, n)).astype(np.float32)
    return (x, dt, bm, cm, a, h0), (dy, dh_t)


def in_float64(fn, *args, **kwargs):
    """``fn`` (a plain or tiled backward) with its math in float64: its
    ``.float()`` casts made ``.double()``. The tiled backwards add in another
    order than the plain walk (products over a chunk, sums over chunks), and
    where the gradients reach ~1e3 (N = 64, decays near 1) fp32 rounding
    alone, in either of them, is of the order of the elementwise tolerance;
    in float64 the comparison holds the decomposition itself. The kernels'
    fp32 arithmetic is held on the card (``chip_smoke.py``)."""
    with mock.patch.object(torch.Tensor, "float", torch.Tensor.double):
        return fn(*(None if a is None else a.double() for a in args), **kwargs)


def torch_of(arrays):
    return [torch.from_numpy(a.copy()) for a in arrays]


def autograd_grads(fn, args, cotangents):
    leaves = [a.clone().requires_grad_() for a in args]
    outs = fn(*leaves)
    total = sum((o * c).sum() for o, c in zip(outs, cotangents))
    return torch.autograd.grad(total, leaves)


# (seed, B, S, H or Di, N, decays): ragged N and S, a single step, a chunk and
# a half of the kernels' 32, decays near 0 and 1
RWKV_CASES = [(0, 2, 45, 3, 7, "sigmoid"), (1, 1, 1, 2, 16, "near1"),
              (2, 2, 33, 2, 5, "near0"), (3, 1, 70, 1, 17, "near1")]
SSM_CASES = [(4, 2, 45, 11, 7, "random"), (5, 1, 1, 3, 16, "near1"),
             (6, 2, 33, 5, 4, "near0"), (7, 1, 70, 33, 3, "random")]


@pytest.mark.parametrize("case", RWKV_CASES, ids=lambda c: "-".join(map(str, c[1:])))
def test_rwkv_plain_backward_matches_jax_vjp_and_autograd(case):
    args, cots = rwkv_case(*case)
    _, vjp = jax.vjp(jref.rwkv_scan_ref, *args)
    want = vjp(cots)
    targs, tcots = torch_of(args), torch_of(cots)
    got = ref.rwkv_scan_bwd_ref(*targs, *tcots)
    auto = autograd_grads(ref.rwkv_scan_ref, targs, tcots)
    for name, g, w, a in zip(RWKV_NAMES, got, want, auto):
        close(g, w, f"d{name} vs jax.vjp")
        close(g, a, f"d{name} vs autograd")


@pytest.mark.parametrize("case", SSM_CASES, ids=lambda c: "-".join(map(str, c[1:])))
def test_ssm_plain_backward_matches_jax_vjp_and_autograd(case):
    args, cots = ssm_case(*case)
    _, vjp = jax.vjp(jref.ssm_scan_ref, *args)
    want = vjp(cots)
    targs, tcots = torch_of(args), torch_of(cots)
    got = ref.ssm_scan_bwd_ref(*targs, *tcots)
    auto = autograd_grads(ref.ssm_scan_ref, targs, tcots)
    for name, g, w, a in zip(SSM_NAMES, got, want, auto):
        close(g, w, f"d{name} vs jax.vjp")
        close(g, a, f"d{name} vs autograd")


def test_plain_backwards_take_a_missing_state_gradient_as_zero():
    args, (dy, _) = rwkv_case(8, 2, 20, 2, 6, "sigmoid")
    targs = torch_of(args)
    zero = torch.zeros((2, 2, 6, 6))
    for g, w in zip(ref.rwkv_scan_bwd_ref(*targs, torch.from_numpy(dy)),
                    ref.rwkv_scan_bwd_ref(*targs, torch.from_numpy(dy), zero)):
        assert torch.equal(g, w)
    args, (dy, _) = ssm_case(9, 2, 20, 5, 6, "random")
    targs = torch_of(args)
    zero = torch.zeros((2, 5, 6))
    for g, w in zip(ref.ssm_scan_bwd_ref(*targs, torch.from_numpy(dy)),
                    ref.ssm_scan_bwd_ref(*targs, torch.from_numpy(dy), zero)):
        assert torch.equal(g, w)


# (case, chunk, dS_T given): the wrapper's chunk (None) on ragged N and S, a
# single step and decays near 0; then chunks of 4 and 8 steps at S ~ 40, which
# drive the carry pass across many chunks, with decays near 0 (a chunk's
# product underflows to 0) and a final-state gradient that is None
@pytest.mark.parametrize("case,chunk,with_state", [
    ((10, 2, 71, 2, 64, "near1"), None, True), ((11, 2, 33, 3, 17, "near0"), None, True),
    ((12, 1, 40, 2, 9, "sigmoid"), None, False), ((13, 2, 1, 2, 64, "sigmoid"), None, True),
    ((22, 2, 41, 2, 6, "near0"), 4, True), ((23, 1, 39, 3, 20, "sigmoid"), 8, False),
    ((24, 2, 40, 1, 5, "near1"), 8, True)])
def test_rwkv_tiled_backward_matches_plain(case, chunk, with_state):
    """The kernel's decomposition: per chunk the decay product, the local
    state and adjoint from zero; the carry in chunk order from s0 and dS_T;
    the walk from each chunk's true start and end (dv summed over the whole
    head), du's partials added by batch row, then chunk."""
    args, (dy, ds_t) = rwkv_case(*case)
    targs = torch_of(args)
    tcots = [torch.from_numpy(dy), torch.from_numpy(ds_t) if with_state else None]
    got = in_float64(ref.rwkv_scan_bwd_tiled_ref, *targs, *tcots,
                     chunk=chunk or rwkv_geometry(case[4])[1])
    want = in_float64(ref.rwkv_scan_bwd_ref, *targs, *tcots)
    for name, g, w in zip(RWKV_NAMES, got, want):
        close(g, w, f"d{name}")


@pytest.mark.parametrize("case,chunk,channels,with_state", [
    ((14, 2, 71, 37, 16, "random"), None, None, True),
    ((15, 2, 33, 9, 33, "near0"), None, None, True),
    ((16, 1, 40, 20, 5, "near1"), None, 8, False),
    ((17, 2, 1, 3, 64, "random"), None, None, True),
    ((25, 2, 41, 7, 6, "near0"), 4, 3, True), ((26, 1, 39, 5, 17, "random"), 8, None, False),
    ((27, 2, 40, 4, 3, "near1"), 8, 2, True)])
def test_ssm_tiled_backward_matches_plain(case, chunk, channels, with_state):
    """The kernel's decomposition: per chunk the local state and adjoint from
    zero with e_t = 2^(dt A log2 e); the carry in chunk order with the
    chunk's decay as one exponential of the summed dt; the walk from each
    chunk's true start and end; the blocks' dB, dC, ddt (the wrapper's
    channels a block, the last one ragged, or another) and dA's partials by
    batch row, then chunk, added in order."""
    args, (dy, dh_t) = ssm_case(*case)
    targs = torch_of(args)
    tcots = [torch.from_numpy(dy), torch.from_numpy(dh_t) if with_state else None]
    _, wrapper_chunk, per = ssm_geometry(case[4])
    got = in_float64(ref.ssm_scan_bwd_tiled_ref, *targs, *tcots, chunk=chunk or wrapper_chunk,
                     channels=channels or per)
    want = in_float64(ref.ssm_scan_bwd_ref, *targs, *tcots)
    for name, g, w in zip(SSM_NAMES, got, want):
        close(g, w, f"d{name}")


def test_backward_geometry_at_the_training_shapes():
    """rwkv6-7b's heads of 64: the state at width 64, chunks of 32 steps (32
    chunks of S = 1024, 4096 (b, h, chunk) items at B = 2, H = 64), each
    block all 64 rows of a head;
    hymba-1.5b's state of 16: blocks of 32 channels (two a thread), 100 a
    batch row of 3200, chunks of 32 steps (48 of S = 1536)."""
    assert rwkv_geometry(64) == (64, 32)
    assert rwkv_geometry(20) == (32, 32)
    assert rwkv_geometry(3) == (16, 32)
    assert 2 * 64 * -(-1024 // rwkv_geometry(64)[1]) == 4096
    assert ssm_geometry(16) == (16, 32, 32)
    assert ssm_geometry(17) == (32, 32, 16)
    assert ssm_geometry(64) == (64, 32, 8)
    assert -(-3200 // ssm_geometry(16)[2]) == 100
    assert -(-1536 // ssm_geometry(16)[1]) == 48


@pytest.mark.parametrize("use_state", [True, False])
def test_rwkv_function_on_the_cpu_matches_autograd(use_state):
    """``RwkvScan`` with the plain callables (and the tiled backward): the
    same gradients as autograd of the plain forward. Without S_T in the loss
    its gradient never arrives and counts as zero."""
    args, (dy, ds_t) = rwkv_case(18, 2, 37, 2, 8, "sigmoid")
    targs = torch_of(args)
    cots = [torch.from_numpy(dy)] + ([torch.from_numpy(ds_t)] if use_state else [])

    def loss(outs):
        return sum((o * c).sum() for o, c in zip(outs, cots))

    leaves = [a.clone().requires_grad_() for a in targs]
    want = torch.autograd.grad(loss(ref.rwkv_scan_ref(*leaves)), leaves)
    tiled = lambda *a: ref.rwkv_scan_bwd_tiled_ref(*a, chunk=8)   # noqa: E731
    for bwd in (ref.rwkv_scan_bwd_ref, tiled):
        leaves = [a.clone().requires_grad_() for a in targs]
        outs = RwkvScan.apply(*leaves, ref.rwkv_scan_ref, bwd)
        got = torch.autograd.grad(loss(outs), leaves)
        for name, g, w in zip(RWKV_NAMES, got, want):
            close(g, w, f"d{name}")


@pytest.mark.parametrize("use_state", [True, False])
def test_ssm_function_on_the_cpu_matches_autograd(use_state):
    """``SsmScan`` with the plain callables, y in fp32 as the model asks:
    the same gradients as autograd of the plain forward."""
    args, (dy, dh_t) = ssm_case(19, 2, 37, 6, 5, "random")
    targs = torch_of(args)
    cots = [torch.from_numpy(dy)] + ([torch.from_numpy(dh_t)] if use_state else [])

    def loss(outs):
        return sum((o * c).sum() for o, c in zip(outs, cots))

    leaves = [a.clone().requires_grad_() for a in targs]
    want = torch.autograd.grad(loss(ref.ssm_scan_ref(*leaves, out_dtype=torch.float32)),
                               leaves)
    leaves = [a.clone().requires_grad_() for a in targs]
    outs = SsmScan.apply(*leaves, torch.float32, ref.ssm_scan_ref, ref.ssm_scan_bwd_ref)
    got = torch.autograd.grad(loss(outs), leaves)
    for name, g, w in zip(SSM_NAMES, got, want):
        close(g, w, f"d{name}")


def test_backward_wrappers_take_cuda_tensors_only():
    """On CPU tensors the backward wrappers raise before any launch and count
    nothing: the CPU path differentiates the plain versions instead."""
    before = (rwkv_scan_bwd.launches, ssm_scan_bwd.launches)
    args, (dy, ds_t) = rwkv_case(20, 1, 4, 1, 4, "sigmoid")
    with pytest.raises(ValueError, match="CUDA tensors"):
        rwkv_scan_bwd(*torch_of(args), torch.from_numpy(dy), torch.from_numpy(ds_t))
    args, (dy, dh_t) = ssm_case(21, 1, 4, 3, 4, "random")
    with pytest.raises(ValueError, match="CUDA tensors"):
        ssm_scan_bwd(*torch_of(args), torch.from_numpy(dy), torch.from_numpy(dh_t))
    assert (rwkv_scan_bwd.launches, ssm_scan_bwd.launches) == before
