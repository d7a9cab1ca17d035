"""The Python around the Hopper attention kernels, on the CPU.

Flash-decode splits the cache over blocks and merges the splits' partials;
``ref.decode_split_partials_ref`` and ``ref.decode_combine_ref`` write that
algorithm out plainly. Here it is held against the port's plain
``decode_attention_ref``, the jnp oracle and the Pallas ``decode_attention``
(interpret mode, as ``tests/test_kernels.py`` runs it) on the cases the split
kernel must get right: splits that n_valid ends before, n_valid 0 and past S,
n_valid on a split edge, S off the split size, groups of 5 and 16, Dv != Dh,
and the head dims above 128 (160, 192 with a group of 12, 256 under MQA,
MLA's Dh 192 with Dv 128).
The wrapper's split plan and the padding of inputs that 16-byte copies cannot
read (the flash forward's TMA loads, flash-decode's cp.async) are plain
Python too, and are checked here; the kernels themselves run in
``chip_smoke.py`` on the card. Inputs come from numpy seeds.
"""
import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import aligned_caches, decode_plan
from repro_torch.kernels.flash_attention import pad_head_dim, tma_describable, tma_inputs

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


# (label, b, s, h, kh, dh, dv, n_valid, chunk, pallas block_k, dtype)
SPLIT = [
    ("empty-splits", 2, 256, 8, 2, 32, 32, [70, 256], 64, 256, "float32"),
    ("none-and-over", 2, 96, 4, 2, 32, 32, [0, 1000], 32, 96, "float32"),
    ("on-split-edge", 2, 192, 8, 2, 16, 16, [64, 65], 64, 192, "float32"),
    ("ragged-s", 2, 161, 8, 2, 32, 32, [161, 100], 64, 161, "float32"),
    ("group-5", 2, 200, 25, 5, 64, 64, [200, 129], 64, 100, "float32"),
    ("group-16", 2, 130, 16, 1, 32, 32, [130, 64], 64, 130, "float32"),
    ("dv-ne-dh", 2, 150, 8, 2, 40, 24, [150, 20], 32, 150, "float32"),
    ("bf16-edges", 3, 129, 8, 2, 64, 64, [64, 0, 129], 64, 129, "bfloat16"),
    ("wide-160", 2, 130, 8, 2, 160, 160, [130, 64], 64, 130, "float32"),
    ("wide-192-group-12", 2, 100, 24, 2, 192, 192, [100, 37], 64, 100, "float32"),
    ("wide-256-mqa", 2, 150, 8, 1, 256, 256, [150, 0], 64, 150, "float32"),
    ("mla-192-128", 2, 120, 4, 4, 192, 128, [120, 60], 64, 120, "float32"),
    ("wide-256-bf16", 2, 129, 8, 1, 256, 256, [64, 129], 64, 129, "bfloat16"),
]


@pytest.mark.parametrize("label,b,s,h,kh,dh,dv,n_valid,chunk,bk,dtype", SPLIT,
                         ids=[c[0] for c in SPLIT])
def test_split_and_combine_matches_plain_pallas_and_oracle(label, b, s, h, kh, dh, dv, n_valid,
                                                           chunk, bk, dtype):
    (jq, jk, jv), (tq, tk, tv) = make(s + h + dh, [(b, h, dh), (b, s, kh, dh),
                                                   (b, s, kh, dv)], dtype)
    tn = torch.tensor(n_valid, dtype=torch.int32)
    splits = -(-s // chunk)
    m, l, acc = ref.decode_split_partials_ref(tq, tk, tv, tn, splits, chunk)
    assert m.shape == (b, h, splits) and acc.shape == (b, h, splits, dv)
    for bi, n in enumerate(n_valid):
        for sp in range(splits):
            lo, hi = sp * chunk, min((sp + 1) * chunk, s)
            if n <= 0:       # every slot masked: l counts them, the merge is uniform
                assert torch.all(l[bi, :, sp] == hi - lo)
            elif lo >= n:    # the split starts past n_valid: it adds nothing
                assert torch.all(m[bi, :, sp] == ref.NEG_INF)
                assert torch.all(l[bi, :, sp] == 0) and torch.all(acc[bi, :, sp] == 0)
    got = ref.decode_combine_ref(m, l, acc, TORCH[dtype])
    assert got.shape == (b, h, dv) and got.dtype == TORCH[dtype]
    plain = ref.decode_attention_ref(tq, tk, tv, tn)
    np.testing.assert_allclose(got.float().numpy(), plain.float().numpy(),
                               **TOL["float32" if dtype == "float32" else "bfloat16"])
    jn = jnp.array(n_valid, jnp.int32)
    close(got, pallas_decode(jq, jk, jv, jn, block_k=bk, interpret=True), dtype)
    if dv == dh:   # the jnp oracle reshapes its output with Dh
        close(got, jref.decode_attention_ref(jq, jk, jv, jn), dtype)


@pytest.mark.parametrize("shape,want", [((1056, 4, 8), (9, 128)), ((1024, 4, 5), (16, 64))],
                         ids=["qwen3-1.7b-serve", "hymba-1.5b-ring"])
def test_decode_plan_at_the_main_shapes(shape, want):
    """qwen3-1.7b's serving cache (prompt 1024 + 32 tokens, B=4, 8 kv heads)
    and hymba-1.5b's ring (window 1024, B=4, 5 kv heads) on an H100's 132
    SMs: whole 64-slot tiles per split and ~2 blocks of the (KH, B, splits)
    grid per SM. (gemma-2b's single kv head: ``test_decode_plan_of_one_kv_head``.)"""
    s, b, kh = shape
    splits, chunk = decode_plan(s, b, kh, 132)
    assert (splits, chunk) == want
    assert chunk % 64 == 0 and (splits - 1) * chunk < s <= splits * chunk
    assert 1.5 * 132 <= b * kh * splits <= 2.5 * 132


def test_decode_plan_of_one_kv_head():
    """gemma-2b's serving cache (1056 slots, B=4, one kv head) and
    stablelm-12b's (8 kv heads): one-tile splits give gemma every 64-slot
    tile of the cache as a block of its own, 17 splits x 4 = 68 blocks, the
    most whole tiles allow (half-tile splits, 132 blocks, measured no faster
    on the card); stablelm's grid is qwen3-1.7b's."""
    assert decode_plan(1056, 4, 1, 132) == (17, 64)
    assert decode_plan(1056, 4, 8, 132) == (9, 128)


@pytest.mark.parametrize("s,b,kh", [(1, 1, 1), (64, 2, 2), (300, 2, 1), (4096, 1, 8),
                                    (32768, 1, 1), (1056, 16, 8)])
def test_decode_plan_covers_the_cache_in_whole_tiles(s, b, kh):
    splits, chunk = decode_plan(s, b, kh, 132)
    assert chunk >= 64 and chunk % 64 == 0
    assert (splits - 1) * chunk < s <= splits * chunk


def bf16(*shape, seed=0):
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(torch.bfloat16)


def test_tma_describability_of_views():
    q = bf16(2, 64, 4, 128)
    assert tma_describable(q)                                     # dense (B,S,H,D)
    head_major = bf16(2, 4, 64, 128).transpose(1, 2)              # (B,H,S,D) storage
    assert head_major.stride() == (4 * 64 * 128, 128, 64 * 128, 1)
    assert tma_describable(head_major)
    assert not tma_describable(bf16(2, 100, 4, 36))               # head stride 72 bytes
    assert not tma_describable(bf16(2, 100, 2, 20))               # 40 bytes
    flat = bf16(2 * 64 * 4 * 128 + 1)
    misaligned = flat[1:].view(2, 64, 4, 128)                     # base 2 bytes off
    assert misaligned.data_ptr() % 16 == 2 and not tma_describable(misaligned)
    assert not tma_describable(bf16(2, 64, 4, 256)[..., :128][..., ::2])   # not dense


@pytest.mark.parametrize("causal,window", [(True, None), (True, 32), (False, None)])
def test_tma_padding_leaves_the_output_unchanged(causal, window):
    """The unaligned-bf16 case of chip_smoke (Dh 36, Dv 20) and a misaligned
    base: the padded copies give the same output through the plain version,
    at the logit scale of the original Dh, once the padded dims are cut."""
    flat = bf16(2 * 100 * 4 * 36 + 1, seed=1)
    cases = [(bf16(2, 100, 4, 36, seed=2), bf16(2, 100, 2, 36, seed=3),
              bf16(2, 100, 2, 20, seed=4)),
             (flat[1:].view(2, 100, 4, 36), bf16(2, 100, 2, 36, seed=5),
              bf16(2, 100, 2, 24, seed=6))]
    for q, k, v in cases:
        qp, kp, vp = tma_inputs(q, k, v)
        assert all(tma_describable(t) for t in (qp, kp, vp))
        assert qp.shape[-1] % 8 == 0 and kp.shape[-1] == qp.shape[-1] and vp.shape[-1] % 8 == 0
        want = ref.flash_attention_ref(q, k, v, causal=causal, sliding_window=window)
        got = ref.flash_attention_ref(qp, kp, vp, causal=causal, sliding_window=window,
                                      logit_scale=1.0 / math.sqrt(q.shape[-1]))
        assert torch.equal(got[..., :v.shape[-1]], want)
    q, k, v = bf16(1, 16, 2, 64), bf16(1, 16, 2, 64), bf16(1, 16, 2, 64)
    assert all(a is b for a, b in zip(tma_inputs(q, k, v), (q, k, v)))   # no copy when fine


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("layout", ["dense", "sliced", "unaligned", "misaligned"])
def test_decode_caches_the_copies_cannot_read_are_padded(dtype, layout):
    """Flash-decode's caches: aligned ones (dense, views into wider rows) go
    to the kernel as they are; Dh 36 / Dv 20 (72 and 40 bytes in bf16) and a
    base 4 bytes off become padded copies whose zero dims leave the output
    unchanged at the logit scale of the original Dh."""
    dh, dv = (36, 20) if layout in ("unaligned", "misaligned") else (64, 32)
    width = 2 if layout == "sliced" else 1
    _, (q, kw, vw) = make(7, [(2, 4, dh), (2, 50, 2, width * dh), (2, 50, 2, width * dv)],
                          dtype)
    k, v = kw[..., :dh], vw[..., :dv]
    if layout == "misaligned":
        flat = torch.zeros(k.numel() + 4, dtype=k.dtype)
        k = flat[4 // k.element_size():][:k.numel()].view(k.shape)
        k.copy_(kw)
        assert k.data_ptr() % 16 == 4
    kp, vp = aligned_caches(k, v)
    fine = layout in ("dense", "sliced") or (layout == "unaligned" and dtype == "float32")
    assert fine == (kp is k and vp is v)
    assert tma_describable(kp) and tma_describable(vp)
    assert torch.equal(kp[..., :dh], k) and torch.equal(vp[..., :dv], v)
    n_valid = torch.tensor([50, 17])
    want = ref.decode_attention_ref(q, k, v, n_valid)
    got = ref.decode_attention_ref(pad_head_dim(q)[..., :kp.shape[-1]], kp, vp, n_valid,
                                   logit_scale=1.0 / math.sqrt(dh))
    assert torch.equal(got[..., :dv], want)
