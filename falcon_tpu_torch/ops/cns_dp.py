"""Device-DP consensus, plain (port of falcon_tpu/ops/cns_dp.py).

The all-device consensus path: every alignment's tags are folded into one
flat count buffer per DP batch of G seed groups, a forward DP over the
seed's T columns picks each column's best predecessor, and a walk back from
the best column emits the consensus codes.  The three sequential stages
have hand kernels (ops.cns_dp_cuda, csrc/cns_dp.cu); the functions here are
their plain PyTorch twins, with falcon_tpu's semantics to the bit:

  accumulate_tags_planes  twin of K4 (falcon_tpu accumulate_tags_planes +
                          _column_tags_planes)
  consensus_scan          twin of K5 (falcon_tpu consensus_scan, the
                          sequential within-t chain)
  backtrack_walk          twin of K6 (falcon_tpu backtrack + compact_emit,
                          equivalently backtrack_walk with no step cap)

alloc_msa and add_self_tags stay plain torch on every device.

Count buffer: the flat layout [L0 | Ld | dump slot] of falcon_tpu
(msa_size), uint16 (torch.uint16, 2 bytes a count).  A count is bounded by
the alignments of one group, far below 2^16.  The buffer is updated in
place (falcon_tpu donates it).  Tags that falcon_tpu routes to the dump
slot are dropped here, so the dump slot stays 0; only it may differ from
falcon_tpu's buffer.

One formulation only: falcon_tpu's FTPU_CNS_PREFIX (log-step prefix
scan), FTPU_CNS_WALK and FTPU_CNS_WALK_CAP_FRAC (path walk with a step
cap and a plane fallback), FTPU_CNS_MM (one-hot matmul accumulate) and
FTPU_CNS_UNROLL choose between formulations that its own tests prove give
the same output (tests/test_cns_dp.py), so the port does not read them.
"""
import numpy as np
import torch
import torch.nn.functional as F

D_DEFAULT = 14   # delta capacity (max insertion offset + 1)
NPC0 = 16        # delta-0 pred classes: 3 delta classes x 5 bases + start
NPCD = 6         # delta-d pred classes: 5 bases + start
NOEMIT = 15
NEG = -1e9       # score of a class with no link


def l0_size(G, T):
    return G * T * 5 * NPC0


def ld_size(G, T, D):
    return G * T * (D - 1) * 5 * NPCD


def msa_size(G, T, D):
    """[L0 region | Ld region | 1 dump slot] (falcon_tpu layout)."""
    return l0_size(G, T) + ld_size(G, T, D) + 1


def g_of(n, T, D):
    """G from the count buffer's length."""
    return (n - 1) // (T * 5 * NPC0 + T * (D - 1) * 5 * NPCD)


def alloc_msa(G, T, D, device):
    """Fresh zeroed uint16 count buffer of one DP batch (msa_size)."""
    return torch.zeros(msa_size(G, T, D), dtype=torch.int16,
                       device=device).view(torch.uint16)


def counts_i32(msa):
    """The uint16 counts as int32 (through int16: few torch ops take
    uint16)."""
    return msa.view(torch.int16).to(torch.int32) & 0xFFFF


def _add_at(msa, idx):
    """msa[idx] += 1 for every entry of idx, repeats adding up (mod 2^16)."""
    if idx.numel() == 0:
        return
    u, n = torch.unique(idx, return_counts=True)
    m16 = msa.view(torch.int16)
    m16[u] = (counts_i32(m16[u]) + n.to(torch.int32)).to(torch.int16)


def add_self_tags(msa, seeds, tlens, T):
    """The seed's identity alignment as delta-0 tags: each column t <
    tlen gets one tag of (base, pred class 0*5 + previous base; start at
    t = 0).  seeds [G, T] int8 codes (pad 4), tlens [G] int32."""
    G = seeds.shape[0]
    dev = seeds.device
    c = seeds.to(torch.int64).clamp_max(4)
    prev = F.pad(c[:, :-1], (1, 0))
    t_ar = torch.arange(T, device=dev)
    code = c * NPC0 + torch.where(t_ar == 0, NPC0 - 1, prev)
    idx = (torch.arange(G, device=dev)[:, None] * T + t_ar) * (5 * NPC0) \
        + code
    _add_at(msa, idx[t_ar < tlens[:, None].to(torch.int64)])
    return msa


def accumulate_tags_planes(msa, mvp, basep, bd, gidx, s2, max_diff, T, D):
    """Plain twin of K4: fold one align batch's tags into msa, in place.

    mvp:   [P, B] uint8 packed move stream (END->START, ops.align_tb)
    basep: [4P, B] int8 q base per column, START->END (ops.align_tb)
    bd:    [B] int32 edit distance; the keep gate is ncols > 500 and
           bd < max_diff * ncols in float32 (falcon.c:629)
    gidx:  [B] int32 group of the row in this batch (< 0: dead row)
    s2:    [B] int32 seed-range start of the alignment
    Per column: tpos and delta from running counts, the first column with
    delta >= D or tpos < 0 drops the rest of its row, and the class packs
    (base, predecessor) with the predecessor the row's last kept column."""
    P, B = mvp.shape
    S = 4 * P
    dev = mvp.device
    G = g_of(msa.numel(), T, D)
    m = torch.stack([mvp & 3, (mvp >> 2) & 3, (mvp >> 4) & 3, mvp >> 6], 1)
    ms = m.reshape(S, B).flip(0).T.to(torch.int64)             # [B, S]
    valid = ms != 3
    consq = (ms == 0) | (ms == 2)
    adv = (ms == 0) | (ms == 1)
    ncols = valid.sum(1).to(torch.float32)
    md = torch.tensor(max_diff, dtype=torch.float32, device=dev)
    gi = gidx.to(torch.int64)
    keep = (ncols > 500) & (bd.to(torch.float32) < md * ncols) & \
        (gi >= 0) & (gi < G)
    base = basep.T.to(torch.int64)
    cq = consq.cumsum(1)
    tpos = s2.to(torch.int64)[:, None] - 1 + adv.cumsum(1)
    cq_at_adv = torch.cummax(torch.where(adv, cq, 0), 1).values
    delta = torch.where(adv, 0, cq - cq_at_adv)
    bad = valid & ((delta >= D) | (tpos < 0))
    ok = valid & (bad.cumsum(1) == 0) & keep[:, None]
    # the last kept column before each column: (s, delta, base) packed so
    # that a running max is the latest one (s increases)
    ar = torch.arange(S, device=dev)
    enc = torch.where(ok, (ar << 7) | (delta << 3) | base, -1)
    prev = F.pad(torch.cummax(enc, 1).values[:, :-1], (1, 0), value=-1)
    p_exists = prev >= 0
    p_base = prev & 7
    pc0 = torch.where(p_exists,
                      torch.clamp_max((prev >> 3) & 15, 2) * 5 + p_base,
                      NPC0 - 1)
    pcd = torch.where(p_exists, p_base, NPCD - 1)
    gT = gi[:, None] * T + tpos.clamp(0, T - 1)
    idx0 = gT * (5 * NPC0) + base * NPC0 + pc0
    idxd = l0_size(G, T) + (gT * (D - 1) + (delta - 1).clamp(0, D - 2)) \
        * (5 * NPCD) + base * NPCD + pcd
    live = ok & (tpos < T)
    _add_at(msa, torch.where(adv, idx0, idxd)[live])
    return msa


def consensus_scan(msa, G, T, D):
    """Plain twin of K5: the forward DP over t for G groups
    (falcon.c:405-477).

    Returns (bp [T, G, D*5] uint8 best-pred codes, cov [G, T] int32,
    gb_s [G] float32, gb_t, gb_d, gb_b [G] int32).  Codes: < 128 = jump
    to (t-1, code//5, code%5); 128 + pb = stay at (t, d-1, pb); 254/255 =
    path start.  Each step takes the delta-0 best over 16 pred classes,
    then the within-t chain of D-1 dependent levels; argmax takes the
    first maximum.  Scores are multiples of 0.5 far below 2^23, so the
    float32 sums are exact."""
    dev = msa.device
    cnt = counts_i32(msa)
    L0SZ = l0_size(G, T)
    L0 = cnt[:L0SZ].view(G, T, 5 * NPC0)
    Ld = cnt[L0SZ:L0SZ + ld_size(G, T, D)].view(G, T, (D - 1) * 5 * NPCD)
    cov = L0.sum(2, dtype=torch.int32)
    neg = torch.tensor(NEG, dtype=torch.float32, device=dev)
    bp = torch.empty((T, G, D * 5), dtype=torch.uint8, device=dev)
    S_prev = torch.full((G, D, 5), -1.0, device=dev)
    gb_s = torch.full((G,), -1.0, device=dev)
    gb_t = torch.zeros(G, dtype=torch.int32, device=dev)
    gb_d = torch.zeros_like(gb_t)
    gb_b = torch.zeros_like(gb_t)
    zero = torch.zeros((G, 1), device=dev)
    for t in range(T):
        l0 = L0[:, t].float().view(G, 5, NPC0)
        ld = Ld[:, t].float().view(G, D - 1, 5, NPCD)
        half = (0.5 * cov[:, t].float())[:, None]
        s2p = S_prev[:, 2:].amax(1)
        a2 = S_prev[:, 2:].argmax(1)
        P = torch.cat([S_prev[:, 0], S_prev[:, 1], s2p, zero], 1)
        pres0 = l0 > 0
        cand0 = torch.where(pres0, P[:, None, :] + l0, neg)
        arg0 = cand0.argmax(2)
        exists0 = pres0.any(2)
        S = [torch.where(exists0, cand0.amax(2) - half, -1.0)]
        pb0 = arg0 % 5
        cls0 = arg0 // 5
        pd0 = torch.where(cls0 < 2, cls0, a2.gather(1, pb0) + 2)
        code0 = torch.where((arg0 == NPC0 - 1) | ~exists0, 254,
                            pd0 * 5 + pb0)
        # the chain needs only the maxima; the codes of all levels come
        # from one argmax afterwards, over the same candidates
        pres = ld > 0
        exists = pres.any(3)
        for d in range(1, D):
            qv = torch.cat([S[-1], zero], 1)
            cand = torch.where(pres[:, d - 1], qv[:, None, :] + ld[:, d - 1],
                               neg)
            S.append(torch.where(exists[:, d - 1], cand.amax(2) - half,
                                 -1.0))
        S_t = torch.stack(S, 1)                                  # [G, D, 5]
        qv = torch.cat([S_t[:, :-1], zero[:, None].expand(G, D - 1, 1)], 2)
        arg = torch.where(pres, qv[:, :, None, :] + ld, neg).argmax(3)
        codes = torch.where((arg == NPCD - 1) | ~exists, 255, 128 + arg)
        bp[t] = torch.cat([code0[:, None], codes], 1).to(torch.uint8) \
            .view(G, D * 5)
        flat = S_t.view(G, D * 5)
        am = flat.argmax(1)
        mbest = flat.gather(1, am[:, None])[:, 0]
        upd = mbest > gb_s                     # strict: earlier t wins ties
        gb_s = torch.where(upd, mbest, gb_s)
        gb_t = torch.where(upd, t, gb_t)
        gb_d = torch.where(upd, (am // 5).to(torch.int32), gb_d)
        gb_b = torch.where(upd, (am % 5).to(torch.int32), gb_b)
        S_prev = S_t
    return bp, cov, gb_s, gb_t, gb_d, gb_b


def backtrack_walk(bp, cov, gb_s, gb_t, gb_d, gb_b, min_cov, G, T, D):
    """Plain twin of K6: walk each group's pred codes back from its best
    column (falcon.c:493-540) and keep the emitted codes only.

    Returns (out [G, 2T] uint8: base 0..3, +5 when the column's coverage
    is <= min_cov, in emission order, 0 past the count; counts [G]
    int32).  A walk ends at a start code, at t < 0, or at 2T emitted
    codes: falcon_tpu's plane backtrack + compact_emit (and its overflow
    fallback) give the same stream."""
    dev = bp.device
    cap = 2 * T
    bpf = bp.reshape(-1)
    covf = cov.reshape(-1)
    g_ar = torch.arange(G, device=dev)
    t_cur, d_cur, b_cur = (x.to(torch.int64) for x in (gb_t, gb_d, gb_b))
    ck = b_cur
    done = gb_s == -1.0
    n_emit = torch.zeros(G, dtype=torch.int64, device=dev)
    out = torch.zeros((G, cap), dtype=torch.uint8, device=dev)
    step = 0
    # ask whether every walk has ended only every 32 steps: the answer
    # waits on the device
    while step % 32 or not bool(done.all()):
        step += 1
        tc = t_cur.clamp(0, T - 1)
        code = bpf[(tc * G + g_ar) * (D * 5) + d_cur * 5 + b_cur] \
            .to(torch.int64)
        lower = covf[g_ar * T + tc] <= min_cov
        is_start = code >= 250
        can = ~done & ~is_start
        em = can & (ck != 4) & (n_emit < cap)
        out[g_ar[em], n_emit[em]] = (ck + 5 * lower)[em].to(torch.uint8)
        n_emit = n_emit + em
        jump = can & (code < 128)
        stay = can & (code >= 128)
        b_cur = torch.where(jump, code % 5, torch.where(stay, code - 128,
                                                         b_cur))
        d_cur = torch.where(jump, code // 5, torch.where(stay, d_cur - 1,
                                                          d_cur))
        ck = torch.where(can, b_cur, ck)
        t_cur = torch.where(jump, t_cur - 1, t_cur)
        done = done | is_start | (t_cur < 0) | (n_emit >= cap)
    return out, n_emit.to(torch.int32)


_LUT = np.frombuffer(b"ACGT-acgt-", np.uint8)


def assemble_compacted(row, count):
    """Host: one group's emitted codes (backtrack_walk row) -> consensus
    string (the walk runs end -> start)."""
    sel = np.asarray(row[:count])[::-1]
    return _LUT[np.minimum(sel, 9)].tobytes().decode()
