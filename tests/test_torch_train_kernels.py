"""The Python around the Hopper training kernels, on the CPU.

The bf16 flash backward walks blocks of 128 kv rows (64 when the padded head
dim is above 128, where a block may take a share of its group's query heads
and add its dK and dV to the others') and query tiles of 64 within its causal
and window bounds, summing dQ over the blocks; the fused
cross-entropy forward splits the vocabulary into runs of 256-column tiles and
merges the splits' partials. ``ref.flash_attention_bwd_tiled_ref``,
``ref.xent_split_partials_ref`` and ``ref.xent_combine_ref`` write those
decompositions out plainly. Here they are held against the port's plain
versions, ``jax.vjp`` of the reference's ``chunked_attention`` and the Pallas
``fused_xent`` (interpret mode) on the edges the kernels must get right:
ragged S and V, window bounds on a tile edge and off it, a GQA group of 5,
Dv != Dh, the head dims above 128 (160, 192 and 256, and MLA's Dh 192 with
Dv 128), query heads split over items. The wrappers' split plans, their
head-dim bounds and their padding
of operands that TMA cannot read are plain Python too, and are checked here; the kernels
themselves run in ``chip_smoke.py`` on the card. Inputs come from numpy
seeds.
"""
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.kernels.fused_xent import fused_xent as pallas_xent
from repro.models import layers as JL
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import decode_attention as decode_kernel
from repro_torch.kernels.flash_attention import (bwd_block_kv, bwd_plan, flash_attention,
                                                 flash_attention_bwd, padded_head_dim,
                                                 tma_bwd_inputs, tma_describable)
from repro_torch.kernels.fused_xent import (TOKENS_PER_BLOCK, VOCAB_TILE, head_rows,
                                            vocab_splits)


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(np.float32)


def npf(x):
    return x.detach().float().numpy()


# (label, b, s, h, kh, dh, dv, causal, window, head splits): S off the
# 64/128 tiles, a window whose bound lands on a query-tile edge (65: 127 + 65
# = 3 x 64) and one off it, a group of 5, Dv != Dh, no mask; and the head
# dims above 128 (blocks of 64 kv rows): stablelm-12b's 160, nemotron-4-340b's
# 192 with a window on a tile edge (65: 63 + 65 = 2 x 64), gemma-2b's 256
# under MQA, MLA's (192, 128); the wide ones also with their group's query
# heads split over items, as bwd_plan splits them on the card: gemma's MQA
# into 2 and 4, groups of 3 that 2 items do not divide (2 heads and 1)
BWD = [
    ("causal-ragged", 1, 200, 4, 2, 32, 32, True, None, 1),
    ("window-on-edge", 1, 320, 2, 1, 16, 16, True, 65, 1),
    ("window-off-edge", 1, 320, 2, 1, 16, 16, True, 64, 1),
    ("group-5", 1, 150, 10, 2, 16, 16, True, None, 1),
    ("dv-ne-dh", 2, 140, 4, 2, 40, 24, True, None, 1),
    ("bidirectional", 1, 200, 2, 2, 16, 16, False, None, 1),
    ("wide-160", 1, 150, 4, 2, 160, 160, True, None, 1),
    ("wide-192-window", 1, 200, 6, 2, 192, 192, True, 65, 1),
    ("wide-256-mqa", 1, 140, 4, 1, 256, 256, True, None, 1),
    ("mla-192-128", 1, 130, 2, 2, 192, 128, True, None, 1),
    ("wide-256-mqa-split2", 1, 140, 4, 1, 256, 256, True, None, 2),
    ("wide-256-mqa-split4", 1, 140, 4, 1, 256, 256, True, None, 4),
    ("wide-192-window-split2", 1, 200, 6, 2, 192, 192, True, 65, 2),
    ("mla-192-128-split2", 1, 130, 6, 2, 192, 128, True, None, 2),
]


@functools.cache
def reference_vjp(s, causal, window):
    """The jitted ``jax.vjp`` of the reference's ``chunked_attention``: one
    compile a shape, shared by the cases that differ only in head splits."""
    kw = dict(causal=causal, sliding_window=window)
    return jax.jit(lambda a, c, e, g: jax.vjp(
        lambda a, c, e: JL.chunked_attention(a, c, e, kv_chunk=s, **kw), a, c, e)[1](g))


@pytest.mark.parametrize("label,b,s,h,kh,dh,dv,causal,window,splits", BWD,
                         ids=[c[0] for c in BWD])
def test_bwd_tiles_match_plain_and_reference_vjp(label, b, s, h, kh, dh, dv, causal, window,
                                                 splits):
    q, k, v = rand(1, b, s, h, dh), rand(2, b, s, kh, dh), rand(3, b, s, kh, dv)
    do = rand(4, b, s, h, dv)
    tq, tk, tv, tdo = (torch.from_numpy(a) for a in (q, k, v, do))
    kw = dict(causal=causal, sliding_window=window)
    o, lse = ref.flash_attention_ref(tq, tk, tv, return_lse=True, **kw)
    block = bwd_block_kv(dh, dv)
    assert block == (64 if max(dh, dv) > 128 else 128)
    tiled = ref.flash_attention_bwd_tiled_ref(tq, tk, tv, o, lse, tdo, block_kv=block,
                                              head_splits=splits, **kw)
    plain = ref.flash_attention_bwd_ref(tq, tk, tv, o, lse, tdo, **kw)
    oracle = reference_vjp(s, causal, window)(q, k, v, do)
    for name, got, want, jwant in zip(("dq", "dk", "dv"), tiled, plain, oracle):
        np.testing.assert_allclose(npf(got), npf(want), rtol=1e-5, atol=1e-5, err_msg=name)
        np.testing.assert_allclose(npf(got), np.asarray(jwant), rtol=1e-4, atol=1e-4,
                                   err_msg=name)
    if max(dh, dv) > 128 and splits == 1:   # the forward: the Pallas kernel, one block
        np.testing.assert_allclose(npf(o), np.asarray(pallas_flash(
            jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=s, block_k=s,
            interpret=True, **kw)), rtol=2e-5, atol=2e-5)


@pytest.mark.parametrize("causal,window", [(True, None), (True, 65), (True, 64),
                                           (False, None), (False, 100)])
def test_bwd_bounds_skip_only_masked_tiles(causal, window):
    """Each kv block's query range (``ref.bwd_query_range``, the kernel's
    bounds; blocks of 128 rows, or 64 above 128 dims): every query tile
    outside it is wholly masked for the block, and its first and last rows
    each see a kv row of the block."""
    sq = skv = 1000
    q_pos = torch.arange(sq)[:, None]
    kv_pos = torch.arange(skv)[None, :]
    live = torch.ones((sq, skv), dtype=torch.bool)
    if causal:
        live &= kv_pos <= q_pos
    if window is not None:
        live &= kv_pos > q_pos - window
    for block_kv in (128, 64):
        for kv0 in range(0, skv, block_kv):
            block = live[:, kv0:kv0 + block_kv]
            q_begin, q_end = ref.bwd_query_range(kv0, block_kv, sq, causal, window)
            assert q_begin % 64 == 0
            assert not block[:q_begin].any() and not block[q_end:].any()
            assert block[q_begin].any() and block[q_end - 1].any()


# (label, T, D, V, ignore every, sms)
XENT = [
    ("ragged-v", 37, 40, 333, 3, 132),
    ("many-splits", 70, 24, 1100, 5, 132),
    ("one-split", 300, 16, 600, 0, 2),
    ("tile-multiple", 64, 32, 512, 4, 132),
]


@pytest.mark.parametrize("label,t,d,v,every,sms", XENT, ids=[c[0] for c in XENT])
def test_xent_splits_match_plain_and_pallas(label, t, d, v, every, sms):
    x, w = rand(5, t, d), rand(6, d, v) * 0.3
    labels = np.random.default_rng(7).integers(0, v, t).astype(np.int64)
    if every:
        labels[::every] = -100
    tx, tw, tl = torch.from_numpy(x), torch.from_numpy(w), torch.from_numpy(labels)
    n_split, per = vocab_splits(t, v, sms)
    m, l, gold = ref.xent_split_partials_ref(tx, tw, tl, n_split, per, tile=VOCAB_TILE)
    loss, lse = ref.xent_combine_ref(m, l, gold, tl)
    want_loss, want_lse = ref.fused_xent_ref(tx, tw, tl, return_lse=True)
    np.testing.assert_allclose(npf(loss), npf(want_loss), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(npf(lse), npf(want_lse), rtol=1e-5, atol=1e-5)
    assert torch.all(loss[tl == -100] == 0)
    # the Pallas kernel knows no ignore_index: compare the labelled tokens
    pallas = np.asarray(pallas_xent(jnp.asarray(x), jnp.asarray(w),
                                    jnp.asarray(np.where(labels < 0, 0, labels).astype(np.int32)),
                                    t, v, True))
    keep = labels >= 0
    np.testing.assert_allclose(npf(loss)[keep], pallas[keep], rtol=2e-5, atol=2e-5)


def test_vocab_splits_fill_one_wave_at_the_main_shape():
    """T = 2 x 1024 tokens of one ring worker, qwen3-1.7b's vocabulary: 16
    token blocks x 8 splits of 75 tiles = 128 blocks for 132 SMs."""
    t, v = 2048, 151936
    n_split, per = vocab_splits(t, v, 132)
    assert (n_split, per) == (8, 75)
    assert -(-t // TOKENS_PER_BLOCK) * n_split <= 132
    for t, v, sms in [(2048, 151936, 132), (37, 333, 132), (17000, 151936, 132),
                      (128, 256, 132), (300, 600, 2)]:
        n_split, per = vocab_splits(t, v, sms)
        n_tiles = -(-v // VOCAB_TILE)
        assert (n_split - 1) * per < n_tiles <= n_split * per   # every split has a tile
        assert n_split == 1 or -(-t // TOKENS_PER_BLOCK) * n_split <= sms


def test_xent_head_rows_are_read_in_place_or_padded():
    """The tied (V,D) head is read where it lies; a head or x whose rows TMA
    cannot describe (rows of 200 bytes) is padded along D, which leaves the
    loss unchanged."""
    emb = torch.from_numpy(rand(8, 300, 64)).to(torch.bfloat16)
    x = torch.from_numpy(rand(9, 20, 64)).to(torch.bfloat16)
    xr, rows = head_rows(x, emb.T)
    assert xr is x and rows.data_ptr() == emb.data_ptr() and rows.shape == (300, 64)
    dense = torch.from_numpy(rand(10, 64, 300)).to(torch.bfloat16)
    _, rows = head_rows(x, dense)
    assert rows.is_contiguous() and torch.equal(rows, dense.T)
    labels = torch.from_numpy(np.random.default_rng(11).integers(0, 300, 20))
    for d in (100, 36):
        xs = torch.from_numpy(rand(12, 20, d)).to(torch.bfloat16)
        ws = torch.from_numpy(rand(13, 300, d)).to(torch.bfloat16)
        assert not tma_describable(xs)
        xp, rows = head_rows(xs, ws.T)
        assert xp.shape[1] % 8 == 0 and tma_describable(xp) and tma_describable(rows)
        np.testing.assert_array_equal(npf(ref.fused_xent_ref(xp, rows.T, labels)),
                                      npf(ref.fused_xent_ref(xs, ws.T, labels)))


def test_bwd_inputs_the_loads_cannot_read_are_padded():
    """Describable inputs pass as they are; otherwise all five are padded
    along the head dims, and the plain backward of the padded copies, sliced,
    is the backward of the originals (at the original Dh's logit scale)."""
    def bf16(seed, *shape):
        return torch.from_numpy(rand(seed, *shape)).to(torch.bfloat16)
    q, k, v, do = bf16(1, 2, 70, 4, 32), bf16(2, 2, 70, 2, 32), bf16(3, 2, 70, 2, 32), \
        bf16(4, 2, 70, 4, 32)
    o = bf16(5, 2, 70, 4, 32)
    assert all(a is b for a, b in zip(tma_bwd_inputs(q, k, v, o, do), (q, k, v, o, do)))
    q, k, v, do = bf16(1, 2, 70, 4, 36), bf16(2, 2, 70, 2, 36), bf16(3, 2, 70, 2, 20), \
        bf16(4, 2, 70, 4, 20)
    o, lse = ref.flash_attention_ref(q, k, v, return_lse=True)
    padded = tma_bwd_inputs(q, k, v, o, do)
    assert [t.shape[-1] for t in padded] == [40, 40, 24, 24, 24]
    assert all(tma_describable(t) for t in padded)
    scale = 1.0 / math.sqrt(36)
    got = ref.flash_attention_bwd_ref(*padded[:4], lse, padded[4], logit_scale=scale)
    want = ref.flash_attention_bwd_ref(q, k, v, o, lse, do)
    for g, w, n in zip(got, want, (36, 36, 20)):
        assert torch.all(g[..., n:] == 0)
        np.testing.assert_allclose(npf(g[..., :n]), npf(w), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("dh,dv", [(256, 256), (160, 160), (192, 128), (257, 256), (256, 257),
                                   (0, 64)])
def test_wrappers_take_head_dims_up_to_256(dh, dv):
    """The three attention wrappers check Dh and Dv on the host before the
    tensors' device: up to 256 the check passes and the CPU tensors are then
    refused as not CUDA (there is no fallback); 257 (or 0) is refused by
    name."""
    q, k, v = torch.zeros(1, 4, 2, dh), torch.zeros(1, 4, 1, dh), torch.zeros(1, 4, 1, dv)
    o, lse = torch.zeros(1, 4, 2, dv), torch.zeros(1, 2, 4)
    calls = [lambda: flash_attention(q, k, v), lambda: flash_attention_bwd(q, k, v, o, lse, o),
             lambda: decode_kernel(q[:, 0], k, v, 4)]
    for call in calls:
        with pytest.raises(ValueError) as err:
            call()
        if 1 <= dh <= 256 and 1 <= dv <= 256:
            assert "CUDA tensors" in str(err.value)
        else:
            assert f"head dims ({dh}, {dv}) outside 1..256" in str(err.value)


@pytest.mark.parametrize("dh,dv,want", [(1, 1, 64), (64, 64, 64), (65, 8, 128), (128, 128, 128),
                                        (160, 160, 192), (192, 128, 192), (200, 256, 256)])
def test_padded_head_dim_and_bwd_blocks(dh, dv, want):
    """The bf16 kernels' padded head dim (dQ's fp32 buffer has this many
    columns a row, not 256 for every call) and the backward's kv block."""
    assert padded_head_dim(dh, dv) == want
    assert bwd_block_kv(dh, dv) == (64 if want > 128 else 128)


# (label, b, skv, h, kh, dh, dv, splits, heads): one ring worker's training
# shapes (B=2, S=1024) and chip_smoke.py's kernel cases (B=1, S=256) of the
# wide configs, and Dh <= 128 shapes, on 132 SMs
PLANS = [
    ("gemma-2b-train", 2, 1024, 8, 1, 256, 256, 8, 1),        # 32 items -> 256
    ("gemma-2b-case", 1, 256, 8, 1, 256, 256, 8, 1),          # 4 -> 32, all it has
    ("nemotron-train", 2, 1024, 96, 8, 192, 192, 1, 12),      # 256 items already
    ("nemotron-case", 1, 256, 96, 8, 192, 192, 6, 2),         # 32 -> 192
    ("nemotron-s1024", 1, 1024, 96, 8, 192, 192, 2, 6),       # 128 -> 256
    ("stablelm-train", 2, 1024, 32, 8, 160, 160, 1, 4),
    ("stablelm-case", 1, 256, 32, 8, 160, 160, 4, 1),         # 32 -> 128, the whole group
    ("mla-case", 1, 300, 8, 8, 192, 128, 1, 1),
    ("group-7", 3, 1024, 7, 1, 256, 256, 4, 2),               # 48 -> 192: 2, 2, 2, 1
    ("qwen3-1.7b-train", 2, 1024, 16, 8, 128, 128, 1, 2),
    ("hymba-d64", 1, 77, 25, 5, 64, 64, 1, 5),
    ("gemma-like-d128", 1, 256, 8, 1, 128, 128, 1, 8),
]


@pytest.mark.parametrize("label,b,skv,h,kh,dh,dv,splits,heads", PLANS,
                         ids=[c[0] for c in PLANS])
def test_bwd_plan_fills_a_wave_above_128_dims(label, b, skv, h, kh, dh, dv, splits, heads):
    """``bwd_plan``: above 128 padded dims a group's query heads are split
    over enough items to fill one wave of 132 SMs where the group allows,
    evenly (the kernel's ceil(G / heads) items, every one with a head); up to
    128 every shape keeps its 128-row blocks and whole groups."""
    plan = bwd_plan(b, skv, h, kh, dh, dv, 132)
    assert (plan.splits, plan.heads) == (splits, heads)
    assert plan.block_kv == bwd_block_kv(dh, dv)
    group = h // kh
    assert -(-group // plan.heads) == plan.splits and (plan.splits - 1) * plan.heads < group
    items = -(-skv // plan.block_kv) * kh * b
    if padded_head_dim(dh, dv) <= 128:
        assert plan.splits == 1 and plan.block_kv == 128
    else:
        assert items * plan.splits >= 132 or plan.splits == group
