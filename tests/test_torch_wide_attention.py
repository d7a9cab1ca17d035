"""The wide attention kernels' algorithms (bf16, head dims padded to 192 and
256), written out plainly and held against the JAX package on the CPU.

The kernels themselves run only on the card (``chip_smoke.py``); what they
compute differently from the plain versions is rehearsed here:

* flash-decode's one-launch plan (``decode_wide_plan``: clusters of splits,
  rounds of slots, a ring of stages) at the wide configs' serving shapes and
  at edge shapes, and ``decode_plan`` left as it was for Dh <= 128;
* the wide decode kernel's arithmetic: each split scores its slots round by
  round (one maximum a round for all its warps, P rounded to bf16 before P V),
  then the cluster merges the splits in rank order, checked against the
  port's plain ``decode_attention_ref``, the Pallas ``decode_attention`` in
  interpret mode and the jnp oracle at D = 160, 192 (group 12) and 256 (MQA),
  with n_valid 0, on a split edge and past S, on one round and on the ring;
* the wide forward's rescale rule, tile by tile: 128-row query tiles, kv
  tiles of 64 rows (and, to show the rule does not lean on the width, of 80,
  96 and 112), each 16-row warp rescaling only where one of its rows'
  maxima rose, checked against rescaling every tile (bit for bit, in bf16
  too), the Pallas ``flash_attention`` in interpret mode and
  ``repro.models.layers.chunked_attention`` on keys that grow along S, so
  that row maxima rise across many tiles.

Inputs come from numpy seeds.
"""
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.decode_attention import decode_attention as pallas_decode
from repro.kernels.flash_attention import flash_attention as pallas_flash
from repro.models.layers import chunked_attention
from repro_torch.kernels import ref
from repro_torch.kernels.decode_attention import (WIDE_BLOCKS_PER_SM, WIDE_CLUSTER_MAX,
                                                  WIDE_PAIR_SLOTS, WIDE_ROUND_MAX, WidePlan,
                                                  decode_plan, decode_wide_plan, wide_ring)
from repro_torch.kernels.flash_attention import padded_head_dim

NEG_INF = -1e30
LOG2E = 1.4426950408889634
SMS = 132                  # an H100's SMs
SMEM = 232448              # the shared memory a block may take (227 KB)
WIDE_KV_TILE = 64          # kv rows a tile of the bf16 forward above 128 padded head dims


def fwd_kv_rows(dh, dv):
    """The kv rows a tile of the bf16 forward (csrc/flash_attention.cu
    ``launch_wgmma``'s instances)."""
    return WIDE_KV_TILE if padded_head_dim(dh, dv) > 128 else 128


def make(seed, shapes, dtype=np.float32):
    """The same values as (jnp arrays, torch tensors) in fp32."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(dtype) for s in shapes]
    return [jnp.asarray(a) for a in arrs], [torch.from_numpy(a) for a in arrs]


def to_bf16(t):
    return t.to(torch.bfloat16).float()


# ---------------------------------------------------------------------------
# flash-decode's plan
# ---------------------------------------------------------------------------

def wide_smem(d, rows, stages):
    """csrc/decode_attention.cu WideSmem::bytes for a ring of rows * stages:
    K and V, q and P tiles, fp32 maxima, sums and weights, 8 barriers and 1
    KB for the 1024-byte alignment."""
    return 2 * rows * stages * d * 2 + 16 * (d + 8) * 2 + 16 * (8 * 16 + 8) * 2 \
        + (2 * 8 * 16 + 16 * 16) * 4 + 8 * 8 + 1024


@pytest.mark.parametrize("arch,s,b,h,kh,d,want", [
    ("gemma-2b", 1056, 4, 8, 1, 256, WidePlan(16, 80, 80, 1)),
    ("stablelm-12b", 1056, 4, 32, 8, 160, WidePlan(2, 528, 128, 2)),
    ("nemotron-4-340b", 1056, 4, 96, 8, 192, WidePlan(2, 528, 128, 2))])
def test_wide_plan_at_the_serving_shapes(arch, s, b, h, kh, d, want):
    """Prompt 1024 + 32 tokens at B=4 on 132 SMs: 64 blocks, about one per two
    SMs. gemma-2b's one kv head takes clusters of 16 blocks of 80 slots (one
    round each, two blocks to an SM); stablelm-12b's and nemotron-4-340b's
    eight take pairs of blocks of 528 slots through two stages of 128."""
    plan = decode_wide_plan(s, b, kh, padded_head_dim(d, d), SMS)
    assert plan == want
    assert plan.cluster * plan.chunk >= s > (plan.cluster - 3) * plan.chunk   # at most 2 idle
    assert b * kh * plan.cluster <= WIDE_BLOCKS_PER_SM * SMS < 2 * b * kh * plan.cluster
    smem = wide_smem(padded_head_dim(d, d), plan.rows, plan.stages)
    assert (2 if plan.cluster > 8 else 1) * smem <= SMEM


@pytest.mark.parametrize("s,b,kh,d", [
    (1, 1, 1, 256), (17, 2, 1, 256), (100, 2, 2, 192), (1201, 4, 1, 256),
    (1057, 4, 8, 192), (4096, 1, 1, 256), (4096, 2, 2, 192), (32768, 1, 1, 256),
    (32768, 4, 8, 192), (1056, 16, 16, 256), (1056, 8, 8, 256), (300, 64, 8, 192)])
def test_wide_plan_covers_the_cache_within_its_caps(s, b, kh, d):
    """Edge shapes (S = 1, S off a chunk, 32k slots, B x KH far above the SM
    count): power-of-two clusters of at most 16 blocks and at most half a
    block an SM, never more blocks than 16-slot groups, whole groups a block,
    the cache covered; a cluster above 8 only where its blocks fit two to an
    SM; longer splits go through the ring (128 slots by 2 stages at 192
    dims, 64 by 3 at 256) within 227 KB."""
    c, chunk, rows, stages = decode_wide_plan(s, b, kh, d, SMS)
    assert c & (c - 1) == 0 and 1 <= c <= WIDE_CLUSTER_MAX
    assert c <= max(1, -(-s // 16)) and (c == 1 or b * kh * c <= WIDE_BLOCKS_PER_SM * SMS)
    assert chunk % 16 == 0 and c * chunk >= s and (c - 1) * chunk < s + 16 * c
    if c > 8:
        assert chunk <= WIDE_PAIR_SLOTS
    if chunk <= WIDE_ROUND_MAX:
        assert (rows, stages) == (chunk, 1)
    else:
        ring_rows, ring_stages = wide_ring(d)
        assert rows == ring_rows and 2 <= stages <= ring_stages
        assert stages <= -(-chunk // rows)
    assert wide_smem(d, rows, stages) <= SMEM
    assert decode_wide_plan(s, b, kh, d, SMS) == (c, chunk, rows, stages)   # shapes only


def test_decode_plan_keeps_its_dh128_results():
    """The split pass of Dh <= 128 keeps its plans: qwen3-1.7b's serving
    cache (9 splits of 128) and hymba-1.5b's ring (16 of 64)."""
    assert decode_plan(1056, 4, 8, SMS) == (9, 128)
    assert decode_plan(1024, 4, 5, SMS) == (16, 64)


# ---------------------------------------------------------------------------
# flash-decode's in-kernel merge
# ---------------------------------------------------------------------------

def wide_decode_emulation(q, k, v, n_valid, plan, *, p_bf16, logit_scale=None):
    """What ``decode_wide_kernel`` computes, in fp32 on the CPU: for each
    (batch row, kv head) and each of the cluster's ``plan.cluster`` splits of
    ``plan.chunk`` slots, rounds of ``plan.rows`` slots, each taking one new
    maximum per head for the round (base 2) and adding P V (P rounded to bf16
    when ``p_bf16``; the sums from fp32 P); then the merge of the splits in
    rank order: weights 2^(m_c - M) / sum_c l_c 2^(m_c - M)."""
    b, h, dh = q.shape
    s, kh = k.shape[1], k.shape[2]
    g = h // kh
    scale = (logit_scale if logit_scale is not None else 1.0 / math.sqrt(dh)) * LOG2E
    out = torch.zeros(b, h, v.shape[-1])
    for bi in range(b):
        nv = int(n_valid[bi])
        none_valid = nv <= 0
        n = s if none_valid else min(nv, s)
        for khi in range(kh):
            qg = q[bi, khi * g:(khi + 1) * g].float()
            ms, ls, accs = [], [], []
            for c in range(plan.cluster):
                s0 = c * plan.chunk
                end = min(s0 + plan.chunk, s, n)
                m = torch.full((g,), NEG_INF)
                l = torch.zeros(g)
                acc = torch.zeros(g, v.shape[-1])
                for first in range(s0, end, plan.rows):
                    rend = min(first + plan.rows, end)
                    x = qg @ k[bi, first:rend, khi].float().T * scale
                    if none_valid:
                        x = torch.full_like(x, NEG_INF)
                    new = torch.maximum(m, x.max(dim=1).values)
                    corr = torch.exp2(m - new)
                    p = torch.exp2(x - new[:, None])
                    l = l * corr + p.sum(1)
                    pv = to_bf16(p) if p_bf16 else p
                    acc = acc * corr[:, None] + pv @ v[bi, first:rend, khi].float()
                    m = new
                ms.append(m)
                ls.append(l)
                accs.append(acc)
            big = torch.stack(ms).max(0).values
            w = [torch.exp2(mc - big) for mc in ms]
            den = sum(lc * wc for lc, wc in zip(ls, w)).clamp_min(1e-30)
            out[bi, khi * g:(khi + 1) * g] = sum(a * (wc / den)[:, None]
                                                 for a, wc in zip(accs, w))
    return out


# (label, b, s, h, kh, d, n_valid, sms, Pallas block_k): the plan is the
# wrapper's at `sms`; block_k divides S (the interpret mode reads no padding)
DECODE = [
    ("stablelm-160", 2, 300, 8, 2, 160, [300, 0], SMS, 300),
    ("nemotron-192-group-12", 2, 200, 24, 2, 192, [129, 200], SMS, 200),
    ("gemma-256-mqa", 3, 333, 8, 1, 256, [80, 81, 500], SMS, 333),
    ("gemma-256-ring", 2, 2000, 8, 1, 256, [1999, 0], 4, 500),
    ("mla-192-128", 2, 150, 4, 2, 192, [150, 33], SMS, 150),
]


@pytest.mark.parametrize("label,b,s,h,kh,d,n_valid,sms,bk", DECODE, ids=[c[0] for c in DECODE])
def test_wide_decode_merge_matches_plain_pallas_and_oracle(label, b, s, h, kh, d, n_valid, sms,
                                                           bk):
    dv = 128 if label.startswith("mla") else d
    (jq, jk, jv), (tq, tk, tv) = make(s + h + d, [(b, h, d), (b, s, kh, d), (b, s, kh, dv)])
    plan = decode_wide_plan(s, b, kh, padded_head_dim(d, dv), sms)
    if label.endswith("ring"):
        assert plan.stages >= 2 and plan.chunk > plan.rows     # the ring of rounds
    tn = torch.tensor(n_valid, dtype=torch.int32)
    got = wide_decode_emulation(tq, tk, tv, tn, plan, p_bf16=False)
    plain = ref.decode_attention_ref(tq, tk, tv, tn)
    np.testing.assert_allclose(got.numpy(), plain.numpy(), rtol=2e-5, atol=2e-5)
    jn = jnp.array(n_valid, jnp.int32)
    pallas = pallas_decode(jq, jk, jv, jn, block_k=bk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-5, atol=2e-5)
    if dv == d:   # the jnp oracle reshapes its output with Dh
        np.testing.assert_allclose(got.numpy(), np.asarray(jref.decode_attention_ref(
            jq, jk, jv, jn)), rtol=2e-5, atol=2e-5)
    # in bf16 (inputs and P rounded as the kernel rounds them) within its bar
    bq, bk, bv = to_bf16(tq), to_bf16(tk), to_bf16(tv)
    got16 = wide_decode_emulation(bq, bk, bv, tn, plan, p_bf16=True)
    np.testing.assert_allclose(got16.numpy(), ref.decode_attention_ref(bq, bk, bv, tn).numpy(),
                               rtol=2e-2, atol=2e-2)


# ---------------------------------------------------------------------------
# the wide forward's rescale rule
# ---------------------------------------------------------------------------

def wide_fwd_emulation(q, k, v, *, causal, window, kv_rows, skip, p_bf16):
    """What ``flash_fwd_wgmma_kernel`` computes above 128 head dims, in fp32
    on the CPU: 128-row query tiles each visiting the kv tiles of ``kv_rows``
    rows that any of its rows can see; per 16-row warp the row maxima (base
    2), the sums and the output rescaled on every tile, or with ``skip`` only
    where one of the warp's rows' maxima rose; P rounded to bf16 before P V when
    ``p_bf16``. Returns the output and (rescales, tiles) over all warps."""
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    dv = v.shape[-1]
    g = h // kh
    scale = LOG2E / math.sqrt(dh)
    out = torch.zeros(b, sq, h, dv)
    rescales = visits = 0
    kpos = torch.arange(skv)
    for q0 in range(0, sq, 128):
        lo = max(0, q0 - window + 1) if window else 0
        hi = min(skv, q0 + 128) if causal else skv
        rows = torch.arange(q0, q0 + 128)
        qt = torch.zeros(b, 128, h, dh)
        qt[:, :min(128, sq - q0)] = q[:, q0:q0 + 128]
        qt = qt.permute(0, 2, 1, 3).reshape(b, h, 8, 16, dh)      # (b, h, warp, row, d)
        m = torch.full((b, h, 8, 16), NEG_INF)
        l = torch.zeros(b, h, 8, 16)
        acc = torch.zeros(b, h, 8, 16, dv)
        for kv0 in range((lo // kv_rows) * kv_rows, hi, kv_rows):
            kk = k[:, kv0:kv0 + kv_rows].permute(0, 2, 1, 3).repeat_interleave(g, 1)
            vv = v[:, kv0:kv0 + kv_rows].permute(0, 2, 1, 3).repeat_interleave(g, 1)
            x = torch.einsum("bhwrd,bhkd->bhwrk", qt, kk) * scale
            pos = kpos[kv0:kv0 + kv_rows]
            live = torch.ones(128, pos.numel(), dtype=torch.bool)
            if causal:
                live &= pos[None, :] <= rows[:, None]
            if window:
                live &= pos[None, :] > rows[:, None] - window
            x = torch.where(live.reshape(8, 16, -1), x, torch.tensor(NEG_INF))
            mx = torch.maximum(m, x.max(-1).values)
            rise = (mx > m).any(-1, keepdim=True)                   # one vote a warp
            if not skip:
                rise = torch.ones_like(rise)
            corr = torch.where(rise, torch.exp2(m - mx), torch.ones(()))
            m = torch.where(rise, mx, m)
            p = torch.exp2(x - m[..., None])
            l = l * corr + p.sum(-1)
            pv = to_bf16(p) if p_bf16 else p
            acc = acc * corr[..., None] + torch.einsum("bhwrk,bhkd->bhwrd", pv, vv)
            rescales += int(rise.sum())
            visits += rise.numel()
        o = (acc / l.clamp_min(1e-30)[..., None]).reshape(b, h, 128, dv).permute(0, 2, 1, 3)
        out[:, q0:q0 + 128] = o[:, :min(128, sq - q0)]
    return out, (rescales, visits)


def rising_inputs(seed, b, s, h, kh, d):
    """Keys 1x to 4x as long along S (as chip_smoke's "rising" layout), so
    each row's maximum keeps rising with the kv tiles."""
    (jq, jk, jv), (tq, tk, tv) = make(seed, [(b, s, h, d), (b, s, kh, d), (b, s, kh, d)])
    ramp = 1 + 3 * np.arange(s, dtype=np.float32) / s
    tk = tk * torch.from_numpy(ramp)[None, :, None, None]
    jk = jnp.asarray(tk.numpy())
    return (jq, jk, jv), (tq, tk, tv)


# (label, b, s, h, kh, d, causal, window, kv rows (None: the wrapper's),
# Pallas block): S is off the 128-row query tiles and the kv tiles; the
# Pallas block divides it (the interpret mode reads no padding)
FWD = [
    ("gemma-256-causal", 1, 333, 4, 1, 256, True, None, None, 111),
    ("gemma-256-causal-80", 1, 333, 4, 1, 256, True, None, 80, 111),
    ("stablelm-160-window", 1, 300, 4, 2, 160, True, 150, None, 100),
    ("stablelm-160-window-112", 1, 300, 4, 2, 160, True, 150, 112, 100),
    ("nemotron-192-bidirectional-96", 1, 250, 6, 2, 192, False, None, 96, 125),
]


@pytest.mark.parametrize("label,b,s,h,kh,d,causal,window,rows,blk", FWD,
                         ids=[c[0] for c in FWD])
def test_wide_forward_rescale_rule_matches_pallas_and_chunked(label, b, s, h, kh, d, causal,
                                                              window, rows, blk):
    kv_rows = rows or fwd_kv_rows(d, d)
    (jq, jk, jv), (tq, tk, tv) = rising_inputs(s + d, b, s, h, kh, d)
    outs, counts = {}, {}
    for order, keys in (("rising", tk), ("falling", tk.flip(1))):
        outs[order], counts[order] = wide_fwd_emulation(tq, keys, tv, causal=causal, window=window,
                                                kv_rows=kv_rows, skip=True, p_bf16=False)
        every, (always, visits) = wide_fwd_emulation(tq, keys, tv, causal=causal,
                                                     window=window, kv_rows=kv_rows,
                                                     skip=False, p_bf16=False)
        assert always == visits
        np.testing.assert_array_equal(outs[order].numpy(), every.numpy())  # skipped factors are 1
    assert counts["rising"][0] > 0                           # the rule rescales
    assert counts["falling"][0] < counts["falling"][1]       # and skips
    got = outs["rising"]
    pallas = pallas_flash(jq, jk, jv, causal=causal, sliding_window=window, block_q=blk,
                          block_k=blk, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-5, atol=2e-5)
    chunked = jax.jit(lambda a, b_, c: chunked_attention(
        a, b_, c, causal=causal, sliding_window=window, kv_chunk=128))(jq, jk, jv)
    np.testing.assert_allclose(got.numpy(), np.asarray(chunked), rtol=2e-5, atol=2e-5)
    # bf16 inputs and P, rounded as the kernel rounds them: the same bits as
    # rescaling every tile (each row's largest P stays an exact 1), within
    # the forward's bar of 1.6e-2 max abs
    bq, bk, bv = to_bf16(tq), to_bf16(tk), to_bf16(tv)
    plain = ref.flash_attention_ref(bq, bk, bv, causal=causal, sliding_window=window)
    got16, _ = wide_fwd_emulation(bq, bk, bv, causal=causal, window=window, kv_rows=kv_rows,
                                  skip=True, p_bf16=True)
    every16, _ = wide_fwd_emulation(bq, bk, bv, causal=causal, window=window, kv_rows=kv_rows,
                                    skip=False, p_bf16=True)
    np.testing.assert_array_equal(got16.numpy(), every16.numpy())
    assert (got16 - plain).abs().max().item() < 1.6e-2


@pytest.mark.parametrize("d,want", [(64, 128), (128, 128), (160, 64), (192, 64), (196, 64),
                                    (256, 64)])
def test_wide_forward_tiles_fit_shared_memory(d, want):
    """The forward's kv tile rows by padded head dim, in shared memory: Q's
    two 64-row tiles and two stages of K and V tiles within 227 KB (with 1
    KB for alignment and the barriers)."""
    assert fwd_kv_rows(d, d) == want
    dp = padded_head_dim(d, d)
    assert (2 * 64 + 4 * want) * dp * 2 + 2048 <= SMEM
