"""Plain PyTorch versions of the ported kernels (the allclose targets).

Deliberately naive, as ``repro/kernels/ref.py``: everything is materialised
and the math is fp32. They define correctness, not speed. The CPU path of
``ops`` runs them, and ``chip_smoke.py`` holds each kernel against them on
the card.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F

NEG_INF = -1e30


def _scores(q, k, causal, sliding_window, scale):
    """fp32 scaled scores (B,KH,G,Sq,Skv) with masked entries at NEG_INF, and
    the mask itself."""
    b, sq, h, dh = q.shape
    skv, kh = k.shape[1], k.shape[2]
    qg = q.reshape(b, sq, kh, h // kh, dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) * scale
    q_pos = torch.arange(sq, device=q.device)[:, None]
    kv_pos = torch.arange(skv, device=q.device)[None, :]
    mask = torch.ones((sq, skv), dtype=torch.bool, device=q.device)
    if causal:
        mask &= kv_pos <= q_pos
    if sliding_window is not None:
        mask &= kv_pos > q_pos - sliding_window
    return torch.where(mask, s, torch.tensor(NEG_INF, device=q.device)), mask


def flash_attention_ref(q, k, v, *, causal=True, sliding_window=None, logit_scale=None,
                        return_lse=False):
    """q: (B,Sq,H,Dh); k,v: (B,Skv,KH,Dh|Dv) -> (B,Sq,H,Dv), and with
    ``return_lse`` also each row's log-sum-exp of its scaled scores (B,H,Sq)
    fp32.  fp32 softmax."""
    b, sq, h, dh = q.shape
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(dh)
    s, _ = _scores(q, k, causal, sliding_window, scale)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    o = o.reshape(b, sq, h, v.shape[-1]).to(q.dtype)
    if return_lse:
        return o, torch.logsumexp(s, dim=-1).reshape(b, h, sq)
    return o


def flash_attention_bwd_ref(q, k, v, o, lse, do, *, causal=True, sliding_window=None,
                            logit_scale=None):
    """The gradients (dq, dk, dv) of ``flash_attention_ref`` at output
    gradient ``do``, written out as the backward kernel computes them: P =
    exp(S - lse), dV = Pᵀ dO, dP = dO Vᵀ, D = rowsum(dO * O), dS = P (dP - D),
    dQ = scale dS K, dK = scale dSᵀ Q.  fp32 throughout; the gradients come
    back in the inputs' dtype."""
    b, sq, h, dh = q.shape
    skv, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kh
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(dh)
    s, mask = _scores(q, k, causal, sliding_window, scale)
    lse = lse.float().reshape(b, kh, g, sq)
    p = torch.where(mask, torch.exp(s - lse[..., None]), torch.zeros((), device=q.device))
    dog = do.float().reshape(b, sq, kh, g, dv)
    dvv = torch.einsum("bkgqs,bqkgd->bskd", p, dog)
    dp = torch.einsum("bqkgd,bskd->bkgqs", dog, v.float())
    dsum = (dog * o.float().reshape(b, sq, kh, g, dv)).sum(-1).permute(0, 2, 3, 1)
    ds = p * (dp - dsum[..., None])
    dq = torch.einsum("bkgqs,bskd->bqkgd", ds, k.float()) * scale
    dk = torch.einsum("bkgqs,bqkgd->bskd", ds, q.float().reshape(b, sq, kh, g, dh)) * scale
    return dq.reshape(b, sq, h, dh).to(q.dtype), dk.to(k.dtype), dvv.to(v.dtype)


def bwd_query_range(kv0, block_kv, sq, causal, sliding_window):
    """The query rows [q_begin, q_end) that can see a kv row of the block
    [kv0, kv0 + block_kv), as the backward kernel bounds them: from kv0 when
    causal, and below the block's last row plus the window."""
    q_begin = kv0 if causal else 0
    q_end = sq if sliding_window is None else min(sq, kv0 + block_kv - 1 + sliding_window)
    return q_begin, q_end


def flash_attention_bwd_tiled_ref(q, k, v, o, lse, do, *, causal=True, sliding_window=None,
                                  logit_scale=None, block_kv=128, block_q=64, head_splits=1):
    """The bf16 backward kernel's work decomposition
    (``csrc/flash_attention_bwd.cu``) written out plainly, in fp32: work
    items of ``block_kv`` kv rows of one kv head and a share of its group's
    query heads (``head_splits`` items of ceil(G / head_splits) heads, the
    last the rest, as ``flash_attention.bwd_plan`` cuts them), each visiting
    only the query tiles of ``block_q`` rows its causal and window bounds give
    (q from the block's first kv row, below its last kv row plus the window).
    An item sums dK and dV over its own heads' tiles; the items' partials are
    then added in turn, and dQ is summed over the kv blocks. Masked entries
    inside a visited tile count 0. Returns (dq, dk, dv) in the inputs' dtype."""
    b, sq, h, dh = q.shape
    skv, kh, dv = k.shape[1], k.shape[2], v.shape[3]
    g = h // kh
    per = -(-g // head_splits)
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(dh)
    qf = q.float().reshape(b, sq, kh, g, dh)
    dof = do.float().reshape(b, sq, kh, g, dv)
    dsum = (dof * o.float().reshape(b, sq, kh, g, dv)).sum(-1)       # (B,Sq,KH,G)
    lse = lse.float().reshape(b, kh, g, sq)
    kf, vf = k.float(), v.float()
    dq = torch.zeros((b, sq, kh, g, dh), device=q.device)
    dk = torch.zeros((b, skv, kh, dh), device=q.device)
    dvv = torch.zeros((b, skv, kh, dv), device=q.device)
    for kv0 in range(0, skv, block_kv):
        kv1 = min(kv0 + block_kv, skv)
        q_begin, q_end = bwd_query_range(kv0, block_kv, sq, causal, sliding_window)
        kvp = torch.arange(kv0, kv1, device=q.device)[None, :]
        kt, vt = kf[:, kv0:kv1], vf[:, kv0:kv1]
        for g0 in range(0, g, per):
            heads = slice(g0, min(g0 + per, g))
            part_dk = torch.zeros((b, kv1 - kv0, kh, dh), device=q.device)
            part_dv = torch.zeros((b, kv1 - kv0, kh, dv), device=q.device)
            for q0 in range(q_begin // block_q * block_q, q_end, block_q):
                q1 = min(q0 + block_q, sq)
                qp = torch.arange(q0, q1, device=q.device)[:, None]
                mask = torch.ones((q1 - q0, kv1 - kv0), dtype=torch.bool, device=q.device)
                if causal:
                    mask &= kvp <= qp
                if sliding_window is not None:
                    mask &= kvp > qp - sliding_window
                qt, dot = qf[:, q0:q1, :, heads], dof[:, q0:q1, :, heads]
                s = torch.einsum("bqkgd,bskd->bkgqs", qt, kt) * scale
                p = torch.where(mask, torch.exp(s - lse[:, :, heads, q0:q1, None]),
                                torch.zeros((), device=q.device))
                dp = torch.einsum("bqkgd,bskd->bkgqs", dot, vt)
                ds = p * (dp - dsum[:, q0:q1, :, heads].permute(0, 2, 3, 1)[..., None])
                part_dv += torch.einsum("bkgqs,bqkgd->bskd", p, dot)
                part_dk += torch.einsum("bkgqs,bqkgd->bskd", ds, qt)
                dq[:, q0:q1, :, heads] += torch.einsum("bkgqs,bskd->bqkgd", ds, kt)
            dk[:, kv0:kv1] += part_dk
            dvv[:, kv0:kv1] += part_dv
    return ((dq * scale).reshape(b, sq, h, dh).to(q.dtype), (dk * scale).to(k.dtype),
            dvv.to(v.dtype))


def fused_xent_ref(x, w, labels, *, ignore_index=-100, return_lse=False):
    """x: (T,D); w: (D,V); labels: (T,) int -> per-token loss (T,) fp32, 0
    where the label is ``ignore_index``; with ``return_lse`` also the
    per-token log-sum-exp (T,) fp32.  Materialises the (T,V) logits."""
    logits = x.float() @ w.float()
    lse = torch.logsumexp(logits, dim=-1)
    valid = labels != ignore_index
    gold = logits.gather(1, torch.where(valid, labels, 0).long()[:, None])[:, 0]
    loss = torch.where(valid, lse - gold, torch.zeros((), device=x.device))
    return (loss, lse) if return_lse else loss


def xent_split_partials_ref(x, w, labels, n_split, tiles_per_split, *, tile=256):
    """The split pass of ``csrc/fused_xent.cu`` written out plainly: split s
    covers the vocabulary tiles of ``tile`` columns [s * tiles_per_split,
    (s + 1) * tiles_per_split), clipped to V, and carries per token the
    running max m, the running sum l of exp(logit - m) and the gold logit
    over them, one tile at a time (base e; the kernel keeps m in base 2).
    Returns m, l, gold, each (n_split, T) fp32."""
    t, v = x.shape[0], w.shape[1]
    xf = x.float()
    n_tiles = -(-v // tile)
    out = torch.zeros((3, n_split, t), device=x.device)
    for sp in range(n_split):
        m = torch.full((t,), NEG_INF, device=x.device)
        l = torch.zeros((t,), device=x.device)
        gold = torch.zeros((t,), device=x.device)
        for vt in range(sp * tiles_per_split, min(n_tiles, (sp + 1) * tiles_per_split)):
            c0, c1 = vt * tile, min(v, (vt + 1) * tile)
            logits = xf @ w[:, c0:c1].float()
            cols = torch.arange(c0, c1, device=x.device)
            gold += torch.where(cols[None, :] == labels[:, None], logits,
                                torch.zeros((), device=x.device)).sum(1)
            mx = torch.maximum(m, logits.max(1).values)
            l = l * torch.exp(m - mx) + torch.exp(logits - mx[:, None]).sum(1)
            m = mx
        out[:, sp] = torch.stack([m, l, gold])
    return out[0], out[1], out[2]


def xent_combine_ref(m, l, gold, labels, *, ignore_index=-100):
    """The merge of the splits' partials (``xent_split_partials_ref``), as
    the kernel's merge does it: lse = M + log(sum_s l_s e^(m_s - M)), loss =
    lse - gold, 0 where the label is ``ignore_index``. Returns (loss, lse)."""
    mx = m.max(0).values
    lse = mx + torch.log(torch.clamp((l * torch.exp(m - mx)).sum(0), min=1e-30))
    loss = torch.where(labels == ignore_index, torch.zeros((), device=m.device),
                       lse - gold.sum(0))
    return loss, lse


def xent_block_grad(logits, lse, labels, v0, g):
    """One vocabulary block of the cross-entropy gradient with respect to the
    logits: (softmax - onehot) * g, for logits (T,bv) of columns [v0, v0+bv),
    the rows' full log-sum-exp (T,), and g (T,) already zero on ignored
    tokens."""
    p = torch.exp(logits - lse[:, None])
    cols = torch.arange(v0, v0 + logits.shape[1], device=logits.device)
    p = p - (cols[None, :] == labels[:, None]).to(p.dtype)
    return p * g[:, None]


def dequant_rows_ref(codes, scales, *, block=256):
    """(R, nb*block) int8 codes, or (R, nb*block//2) uint8 nibble pairs (element
    2i in the low nibble of byte i), with (R, nb) fp32 per-block scales ->
    (R, nb*block) fp32 rows: one fp32 multiply per element."""
    if codes.dtype == torch.uint8:
        p = codes.to(torch.int32)
        lo, hi = p & 0xF, (p >> 4) & 0xF
        lo, hi = lo - 16 * (lo >> 3), hi - 16 * (hi >> 3)
        codes = torch.stack([lo, hi], dim=-1).reshape(codes.shape[0], -1)
    r, nb = scales.shape
    blocks = codes.reshape(r, nb, block).float()
    return (blocks * scales.float()[..., None]).reshape(r, nb * block)


def decode_attention_ref(q, k_cache, v_cache, n_valid, *, logit_scale=None):
    """q: (B,H,Dh); caches: (B,S,KH,Dh|Dv); n_valid: an int, or an int tensor
    of shape () or (B,) -> (B,H,Dv).

    The output is reshaped with Dv. ``repro/kernels/ref.py`` reshapes it with
    Dh, which fails when Dv != Dh; no test compares the two there."""
    b, h, dh = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(dh)
    qg = q.reshape(b, kh, g, dh)
    scores = torch.einsum("bkgd,bskd->bkgs", qg.float(), k_cache.float()) * scale
    nv = torch.as_tensor(n_valid, device=q.device).reshape(-1, 1).expand(b, 1)
    valid = torch.arange(s, device=q.device)[None, :] < nv
    scores = torch.where(valid[:, None, None, :], scores,
                         torch.tensor(NEG_INF, device=q.device))
    p = torch.softmax(scores, dim=-1)
    o = torch.einsum("bkgs,bskd->bkgd", p, v_cache.float())
    return o.reshape(b, h, v_cache.shape[-1]).to(q.dtype)


def decode_split_partials_ref(q, k_cache, v_cache, n_valid, splits, chunk, *,
                              logit_scale=None):
    """The split pass of flash-decode as ``csrc/decode_attention.cu`` computes
    it, written out plainly (the kernel keeps m in base 2, here it is base e):
    for each split of ``chunk`` slots, the fp32 partial (m, l, acc) of every
    (b, head). Slots at or past n_valid[b] add
    nothing, so a split that starts past a positive n_valid[b] holds m =
    NEG_INF, l = 0, acc = 0; where n_valid[b] <= 0 every slot scores NEG_INF
    and a split holds m = NEG_INF, l = its slot count, acc = the sum of its V
    rows. Returns m, l (B,H,splits) and acc (B,H,splits,Dv)."""
    b, h, dh = q.shape
    s, kh = k_cache.shape[1], k_cache.shape[2]
    g = h // kh
    scale = logit_scale if logit_scale is not None else 1.0 / math.sqrt(dh)
    nv = torch.as_tensor(n_valid, device=q.device).reshape(-1).expand(b)
    count = torch.where(nv <= 0, s, nv.clamp(max=s))                       # (B,)
    scores = torch.einsum("bkgd,bskd->bkgs", q.reshape(b, kh, g, dh).float(),
                          k_cache.float()) * scale
    scores = torch.where((nv <= 0)[:, None, None, None],
                         torch.tensor(NEG_INF, device=q.device), scores)
    ms, ls, accs = [], [], []
    for sp in range(splits):
        lo, hi = sp * chunk, min((sp + 1) * chunk, s)
        live = (torch.arange(lo, hi, device=q.device)[None, :] < count[:, None])  # (B,n)
        sc = torch.where(live[:, None, None, :], scores[..., lo:hi],
                         torch.tensor(NEG_INF, device=q.device))
        m = sc.max(dim=-1).values
        p = torch.where(live[:, None, None, :], torch.exp(sc - m[..., None]),
                        torch.zeros((), device=q.device))
        ms.append(m.reshape(b, h))
        ls.append(p.sum(-1).reshape(b, h))
        accs.append(torch.einsum("bkgs,bskd->bkgd", p, v_cache[:, lo:hi].float())
                    .reshape(b, h, -1))
    return torch.stack(ms, -1), torch.stack(ls, -1), torch.stack(accs, 2)


def decode_combine_ref(m, l, acc, dtype):
    """The merge of the splits' partials (``decode_split_partials_ref``), in
    fp32: sum_s acc_s e^(m_s - M) / sum_s l_s e^(m_s - M) -> (B,H,Dv) in
    ``dtype``."""
    mx = m.max(dim=-1, keepdim=True).values
    f = torch.exp(m - mx)
    den = (l * f).sum(-1).clamp_min(1e-30)
    return ((acc * f[..., None]).sum(2) / den[..., None]).to(dtype)


def rwkv_scan_ref(r, k, v, w, u, s0):
    """The RWKV6 recurrence, one step at a time.  r,k,v,w: (B,S,H,N); u:
    (H,N); s0: (B,H,N,N).
    y_t = r_t · (diag(u) k_t v_tᵀ + S_{t-1});  S_t = diag(w_t) S_{t-1} + k_t v_tᵀ
    fp32 math and state.  Returns (y (B,S,H,N) in r's dtype, S_T (B,H,N,N)
    fp32)."""
    rf, kf, vf, wf = (t.float() for t in (r, k, v, w))
    uf, s = u.float(), s0.float()
    ys = []
    for t in range(r.shape[1]):
        kv = kf[:, t, :, :, None] * vf[:, t, :, None, :]              # (B,H,N,N)
        ys.append(torch.einsum("bhn,bhnm->bhm", rf[:, t], uf[..., None] * kv + s))
        s = wf[:, t, :, :, None] * s + kv
    y = torch.stack(ys, dim=1) if ys else rf.new_zeros(r.shape)
    return y.to(r.dtype), s


def ssm_scan_ref(x, dt, bmat, cmat, a, h0, *, out_dtype=None):
    """The Mamba selective scan, one step at a time.  x: (B,S,Di); dt:
    (B,S,1); bmat,cmat: (B,S,N); a: (Di,N); h0: (B,Di,N).
    h_t = exp(dt_t a) ⊙ h_{t-1} + (dt_t x_t) ⊗ B_t;  y_t = h_t · C_t
    fp32 math and state.  Returns (y (B,S,Di) in ``out_dtype``, x's dtype by
    default, h_T (B,Di,N) fp32)."""
    xf, dtf, bf, cf = (t.float() for t in (x, dt, bmat, cmat))
    af, h = a.float(), h0.float()
    ys = []
    for t in range(x.shape[1]):
        decay = torch.exp(dtf[:, t, :, None] * af)                      # (B,Di,N)
        h = decay * h + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :]
        ys.append(torch.einsum("bdn,bn->bd", h, cf[:, t]))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(x.shape)
    return y.to(out_dtype or x.dtype), h


def scan_width(n):
    """The state width the scan kernels compute at: n padded to 16, 32 or 64."""
    return 16 if n <= 16 else 32 if n <= 32 else 64


def _xor_sum(parts, masks):
    """The sum over the last axis that xor shuffles form: for each mask in
    turn, part i adds part i ^ mask (the lanes' own order of additions)."""
    idx = torch.arange(parts.shape[-1])
    for mask in masks:
        parts = parts + parts[..., idx ^ mask]
    return parts[..., 0]


def _sequential(terms):
    """Sum the last axis one term after another, as a thread's loop does."""
    acc = torch.zeros_like(terms[..., 0])
    for i in range(terms.shape[-1]):
        acc = acc + terms[..., i]
    return acc


def rwkv_scan_tiled_ref(r, k, v, w, u, s0, *, chunk=32, groups=8):
    """``rwkv_scan_ref`` in the decomposition of ``csrc/rwkv_scan.cu``.

    The state is padded to ``scan_width(n)`` and its rows are split into
    ``groups`` row groups of R = width / groups rows, each group's rows in
    pieces of min(R, 4) (piece m of group q: rows m*groups*P + q*P + [0, P)).
    ruk_t = sum_i r_t[i] u[i] k_t[i] is formed per chunk of ``chunk`` steps,
    as 16-term partial sums combined by xor 1, 2 shuffles; each group's
    partial sum_i r_i S[i, j] runs over its rows in order, the groups'
    partials are combined by xor 16, 8, 4 shuffles (groups 4, 2, 1 apart), and
    y_t[j] = v_t[j] ruk_t + that sum. fp32 math and state; returns what
    ``rwkv_scan_ref`` returns."""
    b, s, h, n = r.shape
    nt = scan_width(n)
    rows = nt // groups
    piece = min(rows, 4)
    order = torch.tensor([m * groups * piece + q * piece + e for q in range(groups)
                          for m in range(rows // piece) for e in range(piece)])
    pad = (0, nt - n)
    rf, kf, vf, wf = (F.pad(t.float(), pad) for t in (r, k, v, w))
    uf = F.pad(u.float(), pad)
    st = F.pad(s0.float(), (0, nt - n, 0, nt - n))[:, :, order]   # rows in group order
    rp, kp, wp = rf[..., order], kf[..., order], wf[..., order]
    ys = []
    for c0 in range(0, s, chunk):
        terms = (rf[:, c0:c0 + chunk] * uf) * kf[:, c0:c0 + chunk]        # (B,C,H,NT)
        parts = _sequential(terms.reshape(*terms.shape[:-1], nt // 16, 16))
        ruk = _xor_sum(parts, [m for m in (1, 2) if m < nt // 16])
        for t in range(terms.shape[1]):
            rt = rp[:, c0 + t].reshape(b, h, groups, rows, 1)
            part = _sequential((rt * st.reshape(b, h, groups, rows, nt)).transpose(-1, -2))
            y = vf[:, c0 + t] * ruk[:, t, :, None] + _xor_sum(part.transpose(-1, -2), (4, 2, 1))
            ys.append(y)
            kv = kp[:, c0 + t, :, :, None] * vf[:, c0 + t, :, None, :]
            st = wp[:, c0 + t, :, :, None] * st + kv
    y = torch.stack(ys, dim=1)[..., :n] if ys else rf.new_zeros(r.shape)
    s_t = torch.empty_like(st)
    s_t[:, :, order] = st
    return y.to(r.dtype), s_t[:, :, :n, :n].contiguous()


def ssm_scan_tiled_ref(x, dt, bmat, cmat, a, h0, *, lanes=4, out_dtype=None):
    """``ssm_scan_ref`` in the decomposition of ``csrc/ssm_scan.cu``.

    The state is padded to ``scan_width(n)`` and split over ``lanes`` lanes a
    channel, lane g holding columns m*16 + 4g + [0, 4); the decay is
    2^(dt (A log2 e)), A scaled once as the kernel scales it; each lane's
    partial sum_i h_i C_i runs over its columns in order and the lanes'
    partials are combined by xor 1, then xor 2 shuffles. fp32 math and
    state; returns what ``ssm_scan_ref`` returns."""
    n = a.shape[1]
    nt = scan_width(n)
    order = torch.tensor([m * 16 + 4 * g + e for g in range(lanes)
                          for m in range(nt // 16) for e in range(4)])
    pad = (0, nt - n)
    bf, cf = (F.pad(t.float(), pad)[..., order] for t in (bmat, cmat))
    a2 = (F.pad(a.float(), pad) * 1.4426950408889634)[:, order]
    h = F.pad(h0.float(), pad)[..., order]
    xf, dtf = x.float(), dt.float()
    b, di = h.shape[:2]
    ys = []
    for t in range(x.shape[1]):
        h = (torch.exp2(dtf[:, t, :, None] * a2) * h
             + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :])
        part = _sequential((h * cf[:, t, None, :]).reshape(b, di, lanes, nt // lanes))
        ys.append(_xor_sum(part, (1, 2)))
    y = torch.stack(ys, dim=1) if ys else xf.new_zeros(x.shape)
    h_t = torch.empty_like(h)
    h_t[..., order] = h
    return y.to(out_dtype or x.dtype), h_t[..., :n].contiguous()



def rwkv_scan_bwd_ref(r, k, v, w, u, s0, dy, ds_t=None):
    """The gradients of ``rwkv_scan_ref`` at output gradients dy (B,S,H,N)
    and ds_t (B,H,N,N) fp32 (None counts as zero), by an explicit reverse
    walk over time.  G_t, the whole adjoint of S_t, starts at ds_t and steps
    back as G_{t-1} = diag(w_t) G_t + r_t dy_tᵀ; at each step, with S_{t-1}
    from a forward pass kept whole,
      dr_t = S_{t-1} dy_t + u ⊙ k_t (v_t·dy_t),  dk_t = G_t v_t + u ⊙ r_t (v_t·dy_t),
      dv_t = G_tᵀ k_t + dy_t Σᵢ rᵢuᵢkᵢ,  dw_t = rowsum(G_t ⊙ S_{t-1}),
      du = Σ_{b,t} r_t ⊙ k_t (v_t·dy_t),  ds0 = G_0.
    fp32 math. Returns (dr, dk, dv, dw) in r's dtype, du (H,N) and ds0
    (B,H,N,N) fp32."""
    rf, kf, vf, wf, dyf = (t.float() for t in (r, k, v, w, dy))
    uf = u.float()
    s = s0.float()
    prev = []
    for t in range(r.shape[1]):
        prev.append(s)
        s = wf[:, t, :, :, None] * s + kf[:, t, :, :, None] * vf[:, t, :, None, :]
    g = torch.zeros_like(s) if ds_t is None else ds_t.float().clone()
    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    du = torch.zeros_like(uf)
    for t in reversed(range(r.shape[1])):
        rt, kt, vt, dyt = rf[:, t], kf[:, t], vf[:, t], dyf[:, t]
        vdy = (vt * dyt).sum(-1, keepdim=True)                           # (B,H,1)
        dr[:, t] = torch.einsum("bhij,bhj->bhi", prev[t], dyt) + uf * kt * vdy
        dk[:, t] = torch.einsum("bhij,bhj->bhi", g, vt) + uf * rt * vdy
        dv[:, t] = (torch.einsum("bhij,bhi->bhj", g, kt)
                    + dyt * (rt * uf * kt).sum(-1, keepdim=True))
        dw[:, t] = (g * prev[t]).sum(-1)
        du += (rt * kt * vdy).sum(0)
        g = wf[:, t, :, :, None] * g + rt[..., None] * dyt[:, :, None, :]
    return (*(x.to(r.dtype) for x in (dr, dk, dv, dw)), du, g)


def ssm_scan_bwd_ref(x, dt, bmat, cmat, a, h0, dy, dh_t=None):
    """The gradients of ``ssm_scan_ref`` at output gradients dy (B,S,Di)
    and dh_t (B,Di,N) fp32 (None counts as zero), by an explicit reverse
    walk over time.  g_t, the whole adjoint of h_t, is dy_t C_t + e^{dt_{t+1}
    a} ⊙ g_{t+1} (dh_t added at the last step); with h_{t-1} from a forward
    pass kept whole and e_t = e^{dt_t a},
      dx_t = dt_t Σₙ g_t B_t,  dB_t = Σ_d g_t dt_t x_t,  dC_t = Σ_d dy_t h_t,
      ddt_t = Σ_{d,n} g_t (a e_t h_{t-1} + x_t B_t),
      da = Σ_{b,t} g_t dt_t e_t h_{t-1},  dh0 = e_1 ⊙ g_1.
    fp32 math. Returns (dx, ddt, dB, dC) in x's dtype, da (Di,N) and dh0
    (B,Di,N) fp32."""
    xf, dtf, bf, cf, dyf = (t.float() for t in (x, dt, bmat, cmat, dy))
    af, h = a.float(), h0.float()
    prev = []
    for t in range(x.shape[1]):
        prev.append(h)
        h = (torch.exp(dtf[:, t, :, None] * af) * h
             + (dtf[:, t] * xf[:, t])[..., None] * bf[:, t, None, :])
    q = torch.zeros_like(h) if dh_t is None else dh_t.float().clone()
    dx, dB, dC, ddt = (torch.zeros_like(t) for t in (xf, bf, cf, dtf))
    da = torch.zeros_like(af)
    for t in reversed(range(x.shape[1])):
        hp, xt, dtt, bt = prev[t], xf[:, t], dtf[:, t], bf[:, t]
        dec = torch.exp(dtt[:, :, None] * af)                            # (B,Di,N)
        ht = dec * hp + (dtt * xt)[..., None] * bt[:, None, :]
        g = dyf[:, t, :, None] * cf[:, t, None, :] + q
        dx[:, t] = dtt * (g * bt[:, None, :]).sum(-1)
        dB[:, t] = (g * (dtt * xt)[..., None]).sum(1)
        dC[:, t] = (dyf[:, t, :, None] * ht).sum(1)
        ddt[:, t, 0] = (g * (af * dec * hp + xt[..., None] * bt[:, None, :])).sum((1, 2))
        da += (g * dtt[:, :, None] * dec * hp).sum(0)
        q = dec * g
    return (*(t.to(x.dtype) for t in (dx, ddt, dB, dC)), da, q)


def _chunked(t, chunks, chunk, fill):
    """(B, S, ...) -> (B, chunks, chunk, ...), the steps past S filled with
    ``fill`` (the neutral value the kernels stage there)."""
    pad = chunks * chunk - t.shape[1]
    if pad:
        t = torch.cat([t, t.new_full((t.shape[0], pad, *t.shape[2:]), fill)], dim=1)
    return t.reshape(t.shape[0], chunks, chunk, *t.shape[2:])


def _carry(decay, local, start):
    """The carry pass over chunks, in chunk order: ``local[:, c]`` is chunk c
    crossed from zero and ``decay[:, c]`` its decay product, so the value
    after chunk c is decay * (the value before it) + local. Returns the value
    before each chunk (B, chunks, ...) and the value after the last."""
    before = []
    for c in range(local.shape[1]):
        before.append(start)
        start = decay[:, c] * start + local[:, c]
    return torch.stack(before, dim=1), start


def rwkv_scan_bwd_tiled_ref(r, k, v, w, u, s0, dy, ds_t=None, *, chunk=32):
    """``rwkv_scan_bwd_ref`` in the decomposition of ``csrc/rwkv_scan_bwd.cu``.

    The state is padded to ``scan_width(n)`` and time to whole chunks of
    ``chunk`` steps (w = 1, the rest 0 past S). Three passes, as the kernel's
    three launches:
    - local, every (b, h, chunk) at once, as two sums over the chunk's steps:
      L = Σ_t (a_t ⊙ k_t) v_tᵀ, the chunk run forward from a zero state, with
      a_t = Π_{τ>t} w_τ, and M = Σ_t (b_t ⊙ r_t) dy_tᵀ, the adjoint walked back
      over it from zero, with b_t = Π_{τ<t} w_τ; the rows' decay product P =
      Π w_t (multiplied in step order) ends the prefix products;
    - carry, in chunk order: the true state at each chunk's start from s0
      (S <- P ⊙ S + L) and, from the last chunk back, the true adjoint at
      each chunk's end from dS_T (G <- P ⊙ G + M), which ends as ds0;
    - walk, every (b, h, chunk) at once: the chunk replayed from its true
      start (dr = S_{t-1} dy_t on the way), then walked back from its true
      end: dk = G_t v_t, dw = rowsum(G_t ⊙ S_{t-1}), dv = G_tᵀ k_t (the sum
      over all N rows of the head, inside the block), and the u terms by
      their O(N) formulas; du is one partial per (b, chunk), added in batch
      order, then chunk order.
    Nothing is divided: a decay of 0 makes P = 0. fp32 math; returns what
    ``rwkv_scan_bwd_ref`` returns."""
    b, s, h, n = r.shape
    nt = scan_width(n)
    chunks = -(-s // chunk)
    pad = (0, nt - n)
    rf, kf, vf, dyf = (_chunked(F.pad(t.float(), pad), chunks, chunk, 0.0)
                       for t in (r, k, v, dy))
    wf = F.pad(w.float(), pad, value=1.0)
    wf = _chunked(wf, chunks, chunk, 1.0)                      # (B, C, T, H, nt)
    uf = F.pad(u.float(), pad)
    zero = vf.new_zeros((b, chunks, h, nt, nt))

    def fwd(st, t):
        return wf[:, :, t, :, :, None] * st + kf[:, :, t, :, :, None] * vf[:, :, t, :, None, :]

    # local pass
    pre, suf = [], [wf.new_ones((b, chunks, h, nt))]
    decay = suf[0]
    for t in range(chunk):
        pre.append(decay)
        decay = decay * wf[:, :, t]
    for t in reversed(range(1, chunk)):
        suf.insert(0, suf[0] * wf[:, :, t])
    loc, adj = zero, zero
    for t in range(chunk):
        loc = loc + (suf[t] * kf[:, :, t])[..., None] * vf[:, :, t, :, None, :]
        adj = adj + (pre[t] * rf[:, :, t])[..., None] * dyf[:, :, t, :, None, :]
    # carry pass
    s_pad = F.pad(s0.float(), (0, nt - n, 0, nt - n))
    starts, _ = _carry(decay[..., None], loc, s_pad)
    g_end = (torch.zeros_like(s_pad) if ds_t is None
             else F.pad(ds_t.float(), (0, nt - n, 0, nt - n)))
    ends, ds0 = _carry(decay.flip(1)[..., None], adj.flip(1), g_end)
    ends = ends.flip(1)
    # walk
    dr, dk, dv, dw = (torch.zeros_like(rf) for _ in range(4))
    prev, st = [], starts
    for t in range(chunk):
        prev.append(st)
        dr[:, :, t] = torch.einsum("bchij,bchj->bchi", st, dyf[:, :, t])
        st = fwd(st, t)
    g = ends
    vdy = (vf * dyf).sum(-1, keepdim=True)                    # (B, C, T, H, 1)
    ruk = (rf * uf * kf).sum(-1, keepdim=True)
    for t in reversed(range(chunk)):
        dk[:, :, t] = torch.einsum("bchij,bchj->bchi", g, vf[:, :, t])
        dw[:, :, t] = (g * prev[t]).sum(-1)
        dv[:, :, t] = torch.einsum("bchij,bchi->bchj", g, kf[:, :, t])
        g = wf[:, :, t, :, :, None] * g + rf[:, :, t, :, :, None] * dyf[:, :, t, :, None, :]
    dr = dr + uf * kf * vdy
    dk = dk + uf * rf * vdy
    dv = dv + dyf * ruk
    du_part = (rf * kf * vdy).sum(2)                          # (B, C, H, nt)
    du = uf.new_zeros((h, nt))
    for bb in range(b):
        for c in range(chunks):
            du = du + du_part[bb, c]
    out = (t.reshape(b, chunks * chunk, h, nt)[:, :s, :, :n].to(r.dtype)
           for t in (dr, dk, dv, dw))
    return (*out, du[:, :n].contiguous(), ds0[:, :, :n, :n].contiguous())


def ssm_scan_bwd_tiled_ref(x, dt, bmat, cmat, a, h0, dy, dh_t=None, *, chunk=32,
                           channels=32):
    """``ssm_scan_bwd_ref`` in the decomposition of ``csrc/ssm_scan_bwd.cu``.

    The state is padded to ``scan_width(n)``, time to whole chunks of
    ``chunk`` steps (dt = 0, so e = 1, and the rest 0 past S), and the
    channels cut into blocks of ``channels`` (the last one ragged). Three
    passes, as the kernel's three launches:
    - local, every (b, channel block, chunk) at once, in one forward sweep:
      h run from zero (L) with e_t = 2^(dt_t A log2 e), and the adjoint
      walked back from zero, M = Σ_t E_t ⊙ dy_t C_t with E_t = Π_{τ≤t} e_τ
      (a running product);
    - carry, in chunk order: the chunk's decay P = 2^(A log2 e Σ dt_t) (one
      exponential, dt summed in step order), the true state at each chunk's
      start from h0 (h <- P ⊙ h + L) and, from the last chunk back, the true
      adjoint after each chunk from dh_T (q <- P ⊙ q + M), which ends as dh0;
    - walk, every (b, channel block, chunk) at once: the chunk replayed from
      its true start, then walked back from its true end (e_t formed in each):
      dx, and the block's sums over its channels of dB, dC and ddt (one
      partial per block, added block after block; ddt as Σ A g e h plus
      Σ_d x_d Σ_n g B), and dA's partial for the (b, chunk), added in batch
      order, then chunk order.
    Nothing is divided: an e_t that underflows makes P = 0. fp32 math;
    returns what ``ssm_scan_bwd_ref`` returns."""
    bsz, s, di = x.shape
    n = a.shape[1]
    nt = scan_width(n)
    chunks = -(-s // chunk)
    pad = (0, nt - n)
    xf, dyf = (_chunked(t.float(), chunks, chunk, 0.0) for t in (x, dy))
    dtf = _chunked(dt.float(), chunks, chunk, 0.0)[..., 0]    # (B, C, T)
    bf, cf = (_chunked(F.pad(t.float(), pad), chunks, chunk, 0.0) for t in (bmat, cmat))
    af = F.pad(a.float(), pad)
    a2 = af * 1.4426950408889634
    dec = torch.exp2(dtf[..., None, None] * a2)               # (B, C, T, Di, nt)
    inject = (dtf[..., None] * xf)[..., None] * bf[:, :, :, None, :]
    zero = xf.new_zeros((bsz, chunks, di, nt))
    # local pass
    loc, adj, run = zero, zero, torch.ones_like(zero)
    for t in range(chunk):
        loc = dec[:, :, t] * loc + inject[:, :, t]
        run = run * dec[:, :, t]
        adj = adj + run * dyf[:, :, t, :, None] * cf[:, :, t, None, :]
    # carry pass
    dtsum = dtf.new_zeros((bsz, chunks))
    for t in range(chunk):
        dtsum = dtsum + dtf[:, :, t]
    decay = torch.exp2(a2 * dtsum[..., None, None])           # (B, C, Di, nt)
    starts, _ = _carry(decay, loc, F.pad(h0.float(), pad))
    q_end = torch.zeros_like(zero[:, 0]) if dh_t is None else F.pad(dh_t.float(), pad)
    ends, dh0 = _carry(decay.flip(1), adj.flip(1), q_end)
    ends = ends.flip(1)
    # walk
    prev, h = [], starts
    for t in range(chunk):
        prev.append(h)
        h = dec[:, :, t] * h + inject[:, :, t]
    q = ends
    dx = torch.zeros_like(xf)
    dB, dC = (xf.new_zeros((bsz, chunks, chunk, di, nt)) for _ in range(2))
    ddt = xf.new_zeros((bsz, chunks, chunk, di))
    da_part = zero
    for t in reversed(range(chunk)):
        hp, et = prev[t], dec[:, :, t]
        ht = et * hp + inject[:, :, t]
        g = dyf[:, :, t, :, None] * cf[:, :, t, None, :] + q
        dx[:, :, t] = dtf[:, :, t, None] * (g * bf[:, :, t, None, :]).sum(-1)
        dB[:, :, t] = g * (dtf[:, :, t, None] * xf[:, :, t])[..., None]
        dC[:, :, t] = dyf[:, :, t, :, None] * ht
        ddt[:, :, t] = ((af * g * et * hp).sum(-1)
                        + xf[:, :, t] * (g * bf[:, :, t, None, :]).sum(-1))
        da_part = da_part + g * dtf[:, :, t, None, None] * et * hp
        q = et * g
    parts = []
    for d0 in range(0, di, channels):
        ch = slice(d0, min(di, d0 + channels))
        parts.append(torch.cat([dB[..., ch, :].sum(3), dC[..., ch, :].sum(3),
                                ddt[..., ch].sum(3, keepdim=True)], dim=-1))
    total = parts[0]
    for part in parts[1:]:
        total = total + part
    total = total.reshape(bsz, chunks * chunk, 2 * nt + 1)[:, :s]
    da = af.new_zeros((di, nt))
    for bb in range(bsz):
        for c in range(chunks):
            da = da + da_part[bb, c]
    dx = dx.reshape(bsz, chunks * chunk, di)[:, :s]
    return (dx.to(x.dtype), total[..., 2 * nt:].to(x.dtype), total[..., :n].to(x.dtype),
            total[..., nt:nt + n].to(x.dtype), da[:, :n].contiguous(),
            dh0[..., :n].contiguous())
