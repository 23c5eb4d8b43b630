"""Block x block all-vs-all overlap engine.

TPU-native replacement for the external daligner + LAsort/LAmerge +
LA4Falcon pipeline the reference shells out to (reference:
falcon_kit/bash.py:206,235 HPC.daligner job plans; falcon_kit/mains/
dazzler.py:339-616 block-pair scatter + merge tree).  One engine call
compares a query block A against a target block B (both orientations) and
emits 13-column overlap records in forward-strand coordinates
(see overlap.records).

Stages:
  1. k-mer index of block B, fwd + revcomp, frequency-masked
     (the DBdust/-t<mask> analog)
  2. sorted-join seed matching for all A reads at once
  3. per (a, b, strand) diagonal-window chaining -> one candidate anchor
     per pair (the `find_best_aln_range` analog, vectorized over all pairs)
  4. banded O(ND) extension from the anchor to both read ends
     (ops.align host path, or the batched device kernel when available)
  5. classification (contains / contained / overlap) + symmetric record
     emission

This module is the engine's reference implementation (numpy, exact); the
device path plugs in via `aligner=`; see falcon_tpu_torch.ops.align_device.
"""
import logging

import numpy as np

from ..io.readstore import revcomp_codes
from ..ops import align as _align
from . import records as R
from . import table as T

LOG = logging.getLogger(__name__)

_A = np.frombuffer(b"ACGT", dtype=np.uint8)


class OverlapParams:
    def __init__(self, k=14, max_kmer_freq=32, min_hits=4, bin_size=256,
                 band_tolerance=250, min_overlap=1000, min_idt=0.0,
                 stride=4, topk=3):
        self.k = k
        self.max_kmer_freq = max_kmer_freq   # daligner -t analog
        self.min_hits = min_hits             # seeds needed per candidate
        self.bin_size = bin_size             # diagonal bin width
        self.band_tolerance = band_tolerance
        self.min_overlap = min_overlap       # daligner -l analog
        self.min_idt = min_idt               # fraction, e.g. 0.70
        self.stride = stride                 # A-read k-mer stride
        # top-k DISJOINT diagonal windows extended per (a, b, strand):
        # daligner emits every local alignment of a pair (repeat-crossing
        # pairs legitimately produce 2+ .las records consumed by
        # ovlp_filter, reference ovlp_filter.py:112-191); one window per
        # pair loses the true dovetail overlap whenever a repeat window
        # out-seeds it.  Extended records that converge to the same
        # extents are deduped after alignment.
        self.topk = topk


def _codes_to_ascii(codes):
    return _A[np.minimum(codes, 3)].tobytes()


def _kmer_keys_flat(codes, K):
    """Rolling 2-bit keys for every position of a flat code array (invalid
    for the last K-1 positions and positions touching non-ACGT)."""
    c = codes.astype(np.int64)
    n = len(c)
    if n < K:
        return np.zeros(0, dtype=np.int64), np.zeros(0, dtype=bool)
    bad = c > 3
    c = np.where(bad, 0, c)
    # Horner accumulation over K shifted views
    acc = np.zeros(n - K + 1, dtype=np.int64)
    for i in range(K):
        acc = acc * 4 + c[i:n - K + 1 + i]
    validity = ~bad
    ok = np.ones(n - K + 1, dtype=bool)
    for i in range(K):
        ok &= validity[i:n - K + 1 + i]
    return acc, ok


class AView:
    """Flattened seeding view of an A-side block: masked codes + offsets
    + a lazy native k-mer table at the engine stride.

    Built once per block and cached across the block-pair triangle by the
    driver (pipeline.driver._overlap_store): the A-side pack+radix-sort
    used to run once per (pair, strand) -- 2x per pair -- and is the
    second-largest host cost at Dmel scale after the B-side tables."""

    def __init__(self, store, rids, params):
        self.rids = np.asarray(rids, dtype=np.int64)
        self.params = params
        lens = store.lengths[self.rids].astype(np.int64)
        self.lens = lens
        self.offsets = np.zeros(len(self.rids) + 1, dtype=np.int64)
        np.cumsum(lens, out=self.offsets[1:])
        self.seed = np.empty(int(self.offsets[-1]), dtype=np.uint8)
        has_mask = getattr(store, "mask", None) is not None
        for i, rid in enumerate(self.rids):
            c = store.get_codes(rid)
            o = self.offsets[i]
            self.seed[o:o + len(c)] = c
            if has_mask:
                m = store.get_mask(rid)
                self.seed[o:o + len(m)][m] = 255
        self._qtab = None

    def native_table(self):
        """Sorted (key<<34|pos) table of this view at params.stride."""
        if self._qtab is None:
            from ..ops import native
            self._qtab = native.kmer_table(self.seed, self.offsets,
                                           self.params.k,
                                           self.params.stride)
        return self._qtab


class BlockIndex:
    """Sorted k-mer index over one read block, both orientations.

    Positions are encoded in a flat concatenated coordinate space; revcomp
    reads are laid out in a parallel flat array with the same offsets.
    """

    def __init__(self, store, rids, params, build_tables=True):
        self._ntabs = {}
        self._init(store, rids, params, build_tables)

    def native_table(self, strand):
        """Sorted native k-mer table (stride 1) for one orientation,
        built lazily and cached -- reused across every A block this
        block is compared against."""
        if strand not in self._ntabs:
            from ..ops import native
            seed = self.seed_fwd if strand == 0 else self.seed_rev
            self._ntabs[strand] = native.kmer_table(
                seed, self.offsets, self.params.k, 1)
        return self._ntabs[strand]

    def _init(self, store, rids, params, build_tables=True):
        self.store = store
        self.rids = np.asarray(rids, dtype=np.int64)
        self.params = params
        lens = store.lengths[self.rids].astype(np.int64)
        self.lens = lens
        self.offsets = np.zeros(len(rids) + 1, dtype=np.int64)
        np.cumsum(lens, out=self.offsets[1:])
        total = int(self.offsets[-1])
        self.fwd = np.empty(total, dtype=np.uint8)
        self.rev = np.empty(total, dtype=np.uint8)
        has_mask = getattr(store, "mask", None) is not None
        mf = np.zeros(total, dtype=bool) if has_mask else None
        mr = np.zeros(total, dtype=bool) if has_mask else None
        for i, rid in enumerate(self.rids):
            c = store.get_codes(rid)
            o = self.offsets[i]
            self.fwd[o:o + len(c)] = c
            self.rev[o:o + len(c)] = revcomp_codes(c)
            if has_mask:
                m = store.get_mask(rid)
                mf[o:o + len(c)] = m
                mr[o:o + len(c)] = m[::-1]
        # seeding views: soft-masked bases (dust/tandem tracks,
        # io.masking) become 255 so they produce no k-mer keys; the
        # alignment paths keep reading the unmasked fwd/rev arrays
        # (daligner -mdust/-mtan semantics: masks gate seeds only)
        if has_mask:
            self.seed_fwd = np.where(mf, np.uint8(255), self.fwd)
            self.seed_rev = np.where(mr, np.uint8(255), self.rev)
        else:
            self.seed_fwd = self.fwd
            self.seed_rev = self.rev
        if not build_tables:
            return

        K = params.k
        keys_f, ok_f = _kmer_keys_flat(self.seed_fwd, K)
        keys_r, ok_r = _kmer_keys_flat(self.seed_rev, K)
        # kill k-mers spanning read boundaries
        pos = np.arange(len(keys_f), dtype=np.int64)
        read_of = np.searchsorted(self.offsets, pos, side="right") - 1
        within = pos + K <= self.offsets[read_of + 1]
        ok_f &= within
        ok_r &= within[:len(ok_r)]
        self.read_of_pos = read_of

        def build(keys, ok):
            p = np.nonzero(ok)[0]
            k = keys[p]
            order = np.argsort(k, kind="stable")
            return k[order], p[order]

        self.keys_f, self.pos_f = build(keys_f, ok_f)
        self.keys_r, self.pos_r = build(keys_r, ok_r)

        # frequency mask (daligner -t): drop over-represented k-mers
        self.mask_f = self._freq_mask(self.keys_f)
        self.mask_r = self._freq_mask(self.keys_r)

    def _freq_mask(self, sorted_keys):
        if len(sorted_keys) == 0:
            return np.zeros(0, dtype=bool)
        uniq, start, counts = np.unique(sorted_keys, return_index=True,
                                        return_counts=True)
        bad = counts > self.params.max_kmer_freq
        mask = np.zeros(len(sorted_keys), dtype=bool)
        for s, c in zip(start[bad], counts[bad]):
            mask[s:s + c] = True
        return mask

    def match(self, q_keys, q_ok):
        """Join query k-mer keys against the index.

        Returns (q_pos, t_flat_pos, strand) hit arrays."""
        out = []
        qp_all = np.nonzero(q_ok)[0]
        qk = q_keys[qp_all]
        for strand, (keys, pos, mask) in enumerate(
                ((self.keys_f, self.pos_f, self.mask_f),
                 (self.keys_r, self.pos_r, self.mask_r))):
            if len(keys) == 0:
                continue
            lo = np.searchsorted(keys, qk, side="left")
            hi = np.searchsorted(keys, qk, side="right")
            cnt = hi - lo
            have = cnt > 0
            if not have.any():
                continue
            # expand ranges
            reps = cnt[have]
            qrep = np.repeat(qp_all[have], reps)
            starts = lo[have]
            idx = np.repeat(starts, reps) + (
                np.arange(reps.sum()) -
                np.repeat(np.cumsum(reps) - reps, reps))
            keep = ~mask[idx]
            out.append((qrep[keep], pos[idx][keep],
                        np.full(keep.sum(), strand, dtype=np.int8)))
        if not out:
            z = np.zeros(0, dtype=np.int64)
            return z, z, np.zeros(0, dtype=np.int8)
        return (np.concatenate([o[0] for o in out]),
                np.concatenate([o[1] for o in out]),
                np.concatenate([o[2] for o in out]))


def _chain_candidates(qpos, tpos, a_read, b_read, strand, params):
    """Group hits by (a, b, strand); diagonal-window chain each group.

    Returns list of (a_idx, b_idx, strand, q_anchor, t_anchor, n_seeds)
    with anchors at the min-qpos hit of the densest diagonal band
    (ties: min tpos -- deterministic regardless of hit emission order).
    Up to params.topk DISJOINT windows are emitted per pair, best first
    (after each selection the selected window's bins +-1 are suppressed),
    each with >= min_hits combined seeds -- the daligner
    multiple-local-alignments analog.
    One composite int64 sort key instead of a 5-key lexsort: this runs
    over tens of millions of hits per block pair."""
    if len(qpos) == 0:
        return []
    qpos = qpos.astype(np.int64, copy=False)
    tpos = tpos.astype(np.int64, copy=False)
    binned = (qpos - tpos) // params.bin_size
    bin_lo = binned.min()
    nbins = int(binned.max() - bin_lo) + 1
    nb = int(b_read.max()) + 1
    # key = ((a * nb + b) * 2 + strand) * nbins + (bin - bin_lo)
    pairk = (a_read.astype(np.int64) * nb + b_read.astype(np.int64)) * 2 \
        + strand.astype(np.int64)
    key = pairk * nbins + (binned - bin_lo)
    order = np.argsort(key, kind="stable")
    key = key[order]
    # packed (qpos, tpos) for run-min anchor selection
    packed = (qpos << 21 | tpos)[order]  # positions < 2^21

    n = len(key)
    run_change = np.ones(n, dtype=bool)
    run_change[1:] = key[1:] != key[:-1]
    run_starts = np.nonzero(run_change)[0]           # per (pair, bin) run
    run_counts = np.diff(np.append(run_starts, n)).astype(np.int64)
    run_key = key[run_starts]
    run_pairk = run_key // nbins
    pair_change = np.ones(len(run_starts), dtype=bool)
    pair_change[1:] = run_pairk[1:] != run_pairk[:-1]
    run_pair = np.cumsum(pair_change) - 1            # pair ordinal per run
    run_min = np.minimum.reduceat(packed, run_starts)

    # combine each run with its next run when it is the adjacent bin of
    # the same pair (drift tolerance across the bin boundary)
    nr = len(run_starts)
    comb = run_counts.copy()
    has_next = np.zeros(nr, dtype=bool)
    if nr > 1:
        adj = (run_pairk[1:] == run_pairk[:-1]) & \
            (run_key[1:] == run_key[:-1] + 1)
        comb[:-1] += np.where(adj, run_counts[1:], 0)
        has_next[:-1] = adj

    # top-k windows per pair: k rounds of (pair, -comb, run index) pick
    # the best remaining run of each pair, then suppress runs whose bin
    # is within +-1 of the selection (the selected window covers bins
    # {b, b+1}; disjoint windows need |b' - b| >= 2)
    run_bin = run_key - run_pairk * nbins
    alive = np.ones(nr, dtype=bool)
    best_rounds = []
    for _round in range(max(1, params.topk)):
        if not alive.any():
            break
        order2 = np.lexsort((np.arange(nr), -comb,
                             np.where(alive, run_pair, nr + 1)))
        ncand = int(alive.sum())
        order2 = order2[:ncand]                 # dead runs sort last
        first_of_pair = np.ones(len(order2), dtype=bool)
        rp_sorted = run_pair[order2]
        first_of_pair[1:] = rp_sorted[1:] != rp_sorted[:-1]
        sel = order2[first_of_pair]
        sel = sel[comb[sel] >= params.min_hits]
        if len(sel) == 0:
            break
        best_rounds.append(sel)
        # suppress the selected windows' bins +-1 within their pairs
        sel_pair = run_pair[sel]
        sel_bin = run_bin[sel]
        # map every run to its pair's selected bin this round (pairs
        # without a selection stay unsuppressed)
        sel_of_pair = np.full(int(run_pair[-1]) + 2, -(1 << 40), np.int64)
        sel_of_pair[sel_pair] = sel_bin
        near = np.abs(run_bin - sel_of_pair[run_pair]) <= 1
        alive &= ~near
    if not best_rounds:
        return []
    best = np.concatenate(best_rounds)

    # anchor: min-qpos hit of the winning run, or of its adjacent run
    # when that one starts earlier on the query (reference
    # find_best_aln_range picks the window's first hit the same way)
    anchor = run_min[best]
    nxt = np.minimum(best + 1, nr - 1)
    take_next = has_next[best] & ((run_min[nxt] >> 21) < (anchor >> 21))
    anchor = np.where(take_next, run_min[nxt], anchor)

    a_sel = (run_pairk[best] >> 1)
    s_sel = (run_pairk[best] & 1).astype(np.int64)
    b_sel = a_sel % nb
    a_sel = a_sel // nb
    q_sel = anchor >> 21
    t_sel = anchor & ((1 << 21) - 1)
    c_sel = comb[best]
    out = sorted(zip(a_sel.tolist(), b_sel.tolist(), s_sel.tolist(),
                     q_sel.tolist(), t_sel.tolist(), c_sel.tolist()))
    return out


def chain_blocks(store, rids_a, rids_b, params=None,
                 same_block=None, index=None, a_view=None):
    """Seeding + chaining of block A against block B: k-mer join over
    the sorted tables + diagonal-bin chain, WITHOUT the extension stage.
    Returns (cands, index, timings) where cands is the candidate tuple
    list align_candidates consumes.  Split out of overlap_blocks so the
    driver can pipeline the host chain of pair k+1 under the device
    alignment of pair k (the two stages use disjoint resources: host
    cores vs the chip)."""
    params = params or OverlapParams()
    if same_block is None:
        same_block = rids_a is rids_b or (
            len(rids_a) == len(rids_b) and
            np.array_equal(np.asarray(rids_a), np.asarray(rids_b)))

    import time as _time
    _t0 = _time.time()
    from ..ops import native
    use_native = native.available()
    if index is None:
        index = BlockIndex(store, rids_b, params,
                           build_tables=not use_native)
    K = params.k
    rids_a = np.asarray(rids_a, dtype=np.int64)
    if a_view is None:
        a_view = AView(store, rids_a, params)
    a_offsets = a_view.offsets
    a_seed = a_view.seed
    _t_index = _time.time() - _t0

    if use_native:
        # fused C++ join+chain per strand from prebuilt sorted k-mer
        # tables (radix sorts once per block side, cached on the
        # index/a_view; no hit arrays cross into python -- ~10^8 hits
        # collapse to ~10^5 candidates); table builds and the two
        # strand joins each run in parallel threads (GIL released)
        from concurrent.futures import ThreadPoolExecutor
        fmode = 1 if same_block else 2
        with ThreadPoolExecutor(2) as tpe:
            ft0 = tpe.submit(index.native_table, 0)
            ft1 = tpe.submit(index.native_table, 1)
            qtab = a_view.native_table()
            t0tab = ft0.result()
            t1tab = ft1.result()
        _t_index = _time.time() - _t0
        with ThreadPoolExecutor(2) as tpe:
            f0 = tpe.submit(native.seed_chain_tables, qtab, t0tab,
                            a_offsets, index.offsets,
                            params.max_kmer_freq, params.bin_size,
                            params.min_hits, fmode, rids_a, index.rids,
                            params.topk)
            f1 = tpe.submit(native.seed_chain_tables, qtab, t1tab,
                            a_offsets, index.offsets,
                            params.max_kmer_freq, params.bin_size,
                            params.min_hits, fmode, rids_a, index.rids,
                            params.topk)
            c0 = f0.result()
            c1 = f1.result()
        # merge the per-strand candidate lists to (a, b, strand) order
        # (the order the one-sort numpy path produces)
        cands = []
        i0 = i1 = 0
        n0, n1 = len(c0[0]), len(c1[0])
        while i0 < n0 or i1 < n1:
            k0 = (c0[0][i0], c0[1][i0]) if i0 < n0 else (1 << 62, 0)
            k1 = (c1[0][i1], c1[1][i1]) if i1 < n1 else (1 << 62, 0)
            if k0 <= k1:
                cands.append((int(c0[0][i0]), int(c0[1][i0]), 0,
                              int(c0[2][i0]), int(c0[3][i0]),
                              int(c0[4][i0])))
                i0 += 1
            else:
                cands.append((int(c1[0][i1]), int(c1[1][i1]), 1,
                              int(c1[2][i1]), int(c1[3][i1]),
                              int(c1[4][i1])))
                i1 += 1
        _t_chain = _time.time() - _t0 - _t_index
        return cands, index, (_t_index, _t_chain)
    else:
        keys, ok = _kmer_keys_flat(a_seed, K)
        pos = np.arange(len(keys), dtype=np.int64)
        read_of = np.searchsorted(a_offsets, pos, side="right") - 1
        ok = ok & (pos + K <= a_offsets[read_of + 1])
        if params.stride > 1:
            ok &= ((pos - a_offsets[read_of]) % params.stride) == 0
        qflat, tflat, strand = index.match(keys, ok)
        strand = strand.astype(np.int64)
        if len(qflat) == 0:
            return [], index, (_t_index, 0.0)
        a_idx = np.searchsorted(a_offsets, qflat, side="right") - 1
        qpos = qflat - a_offsets[a_idx]
        b_idx = np.searchsorted(index.offsets, tflat, side="right") - 1
        tpos = tflat - index.offsets[b_idx]
    if len(a_idx) == 0:
        return [], index, (_t_index, 0.0)

    # drop self-pairs / duplicate unordered pairs within one block
    if same_block:
        keep = rids_a[a_idx] < index.rids[b_idx]
        qpos, tpos, strand = qpos[keep], tpos[keep], strand[keep]
        a_idx, b_idx = a_idx[keep], b_idx[keep]
    else:
        keep = rids_a[a_idx] != index.rids[b_idx]
        qpos, tpos, strand = qpos[keep], tpos[keep], strand[keep]
        a_idx, b_idx = a_idx[keep], b_idx[keep]

    cands = _chain_candidates(qpos, tpos, a_idx, b_idx, strand, params)
    LOG.debug("chain_blocks: %d candidate pairs", len(cands))
    return cands, index, (_time.time() - _t0 - _t_index, 0.0)


def align_candidates(store, index, rids_a, cands, params, aligner=None):
    """Extension + record emission for chain_blocks candidates."""
    if not cands:
        return T.empty(0)
    if aligner is None:
        aligner = extend_pairs_host
    rids_a = np.asarray(rids_a, dtype=np.int64)
    return aligner(store, index, rids_a, cands, params)


def overlap_blocks(store, rids_a, rids_b, params=None, aligner=None,
                   same_block=None, index=None, a_view=None):
    """Overlap all reads of block A against block B (chain + align).

    Returns a columnar overlap table (overlap.table structured array):
    one row per (a, b, strand) candidate that aligns, A-side only (call
    emit_symmetric for the mirror records).
    same_block: skip a>=b self/dup pairs (defaults to rids_a is rids_b).
    index / a_view: prebuilt BlockIndex over rids_b / AView over rids_a
    -- the driver caches these across the block-pair triangle so each
    block's k-mer tables are packed+sorted once per phase, not once per
    (pair, strand).
    """
    import time as _time
    _t0 = _time.time()
    cands, index, (t_index, t_chain) = chain_blocks(
        store, rids_a, rids_b, params, same_block=same_block,
        index=index, a_view=a_view)
    out = align_candidates(store, index, rids_a, cands,
                           params or OverlapParams(), aligner)
    LOG.info(
        "overlap_blocks: %d cands; index %.1fs chain+merge %.1fs "
        "align+emit %.1fs", len(cands), t_index, t_chain,
        _time.time() - _t0 - t_index - t_chain)
    return out


def _dedup_extents(a_id, b_id, strand, a_s, a_e, b_s, b_e, dist, tol=50):
    """Keep-mask dropping near-identical records of one (a, b, strand)
    group: top-k windows of the SAME true overlap converge to the same
    extents after extension -- keep the lowest-distance one.  Genuinely
    distinct local alignments (a repeat pair's two placements differ in
    at least one extent by >= tol) all survive, mirroring daligner's
    multiple .las records per pair.  Rows must arrive grouped by
    (a, b, strand), which both aligner paths guarantee."""
    n = len(a_id)
    keep = np.ones(n, dtype=bool)
    if n < 2:
        return keep
    same = ((a_id[1:] == a_id[:-1]) & (b_id[1:] == b_id[:-1]) &
            (strand[1:] == strand[:-1]))
    starts = np.flatnonzero(np.r_[True, ~same])
    ends = np.r_[starts[1:], n]
    for s, e in zip(starts[ends - starts > 1], ends[ends - starts > 1]):
        rows = sorted(range(s, e), key=lambda r: (dist[r], r))
        kept = []
        for r in rows:
            for k in kept:
                if (abs(a_s[r] - a_s[k]) < tol and
                        abs(a_e[r] - a_e[k]) < tol and
                        abs(b_s[r] - b_s[k]) < tol and
                        abs(b_e[r] - b_e[k]) < tol):
                    keep[r] = False
                    break
            else:
                kept.append(r)
    return keep


def extend_pairs_host(store, index, rids_a, cands, params):
    """Anchor -> full overlap via two banded O(ND) extensions (host).
    Returns a columnar overlap table (overlap.table)."""
    rows = []
    for (ai, bi, strand, qa, ta, n_seeds) in cands:
        a_rid = int(rids_a[ai])
        b_rid = int(index.rids[bi])
        a_codes = store.get_codes(a_rid)
        bo = index.offsets[bi]
        blen = int(index.lens[bi])
        b_codes = (index.fwd if strand == 0 else index.rev)[bo:bo + blen]
        o = extend_one(a_codes, b_codes, qa, ta, params)
        if o is None:
            continue
        (a_s, a_e, b_s, b_e, dist, aln_len) = o
        # convert b coords to forward strand
        if strand == 1:
            b_s, b_e = blen - b_e, blen - b_s
        rows.append((a_rid, b_rid, strand, a_s, a_e, len(a_codes),
                     b_s, b_e, blen, dist))
    if not rows:
        return T.empty(0)
    c = np.asarray(rows, dtype=np.int64)
    keep = _dedup_extents(c[:, 0], c[:, 1], c[:, 2], c[:, 3], c[:, 4],
                          c[:, 6], c[:, 7], c[:, 9])
    c = c[keep]
    return T.finalize(c[:, 0], c[:, 1], c[:, 2], c[:, 3], c[:, 4],
                      c[:, 5], c[:, 6], c[:, 7], c[:, 8], c[:, 9],
                      params.min_overlap, params.min_idt)


def _host_align(q, t, band, want_strings):
    from ..ops import native
    if native.available():
        return native.align(q, t, band, want_strings)
    return _align.align(q, t, band, want_strings)


def extend_one(a_codes, b_codes, qa, ta, params):
    """Extend an anchor (qa, ta) to both ends with the banded O(ND)
    aligner.  Returns (a_s, a_e, b_s, b_e, dist, aln_len) in the
    orientation of b_codes, or None."""
    band = params.band_tolerance
    a_ascii = _codes_to_ascii(a_codes)
    b_ascii = _codes_to_ascii(b_codes)

    fwd = _host_align(a_ascii[qa:], b_ascii[ta:], band, False)
    if fwd.aln_str_size == 0 and (len(a_ascii) - qa) > 0 and \
            (len(b_ascii) - ta) > 0:
        return None
    bwd = _host_align(a_ascii[:qa][::-1], b_ascii[:ta][::-1], band, False)
    if bwd.aln_str_size == 0 and qa > 0 and ta > 0:
        return None
    a_s = qa - bwd.aln_q_e
    b_s = ta - bwd.aln_t_e
    a_e = qa + fwd.aln_q_e
    b_e = ta + fwd.aln_t_e
    dist = fwd.dist + bwd.dist
    aln_len = ((a_e - a_s) + (b_e - b_s)) // 2
    return a_s, a_e, b_s, b_e, dist, aln_len


def make_device_aligner(W=512, end_bonus=3, max_batch=512, device=None):
    """An `aligner` for align_candidates (port of falcon_tpu
    overlap/engine.py make_device_aligner): both extensions of every
    candidate ride one batched run_specs call over the block's codes,
    which go to the device once; the batches run through K1."""
    from ..ops.align_device import DeviceExtender
    ext = DeviceExtender(W=W, end_bonus=end_bonus, max_batch=max_batch,
                         device=device)

    def _specs(store, index, rids_a, c):
        ai, bi, strand, qa, ta = c[:, 0], c[:, 1], c[:, 2], c[:, 3], c[:, 4]
        a_same = rids_a is index.rids or (
            len(rids_a) == len(index.rids) and
            np.array_equal(rids_a, index.rids))
        if a_same:
            a_offsets = index.offsets
            a_lens = index.lens
            flat = np.concatenate([index.fwd, index.rev])
            fwd_base = 0
        else:
            a_lens = store.lengths[rids_a].astype(np.int64)
            a_offsets = np.zeros(len(rids_a) + 1, np.int64)
            np.cumsum(a_lens, out=a_offsets[1:])
            a_flat = np.empty(int(a_offsets[-1]), np.uint8)
            for k, rid in enumerate(rids_a):
                cc = store.get_codes(rid)
                a_flat[a_offsets[k]:a_offsets[k] + len(cc)] = cc
            flat = np.concatenate([a_flat, index.fwd, index.rev])
            fwd_base = len(a_flat)
        rev_base = fwd_base + len(index.fwd)
        a_off0 = a_offsets[ai]
        bo = index.offsets[bi]
        t_base = np.where(strand == 0, fwd_base, rev_base)
        N = len(c)
        sp = np.empty((6, 2 * N), np.int64)   # q_off q_len q_dir t_off ...
        sp[:, 0::2] = [a_off0 + qa, a_lens[ai] - qa, np.ones(N),  # fwd
                       t_base + bo + ta, index.lens[bi] - ta, np.ones(N)]
        sp[:, 1::2] = [a_off0 + qa - 1, qa, -np.ones(N),          # bwd
                       t_base + bo + ta - 1, ta, -np.ones(N)]
        return ext.run_specs(flat, *sp)

    def aligner(store, index, rids_a, cands, params):
        if not cands:
            return T.empty(0)
        c = np.asarray(cands, dtype=np.int64)          # [N, 6]
        rids_a = np.asarray(rids_a, np.int64)
        r = _specs(store, index, rids_a, c).reshape(len(c), 2, 3)
        ai, bi, strand, qa, ta = c[:, 0], c[:, 1], c[:, 2], c[:, 3], c[:, 4]
        a_len = np.asarray(store.lengths, np.int64)[rids_a[ai]]
        blen = np.asarray(index.lens, np.int64)[bi]
        a_s = qa - r[:, 1, 0]
        b_s = ta - r[:, 1, 1]
        a_e = qa + r[:, 0, 0]
        b_e = ta + r[:, 0, 1]
        dist = r[:, 0, 2] + r[:, 1, 2]
        rev = strand == 1
        b_s2 = np.where(rev, blen - b_e, b_s)
        b_e2 = np.where(rev, blen - b_s, b_e)
        a_ids = rids_a[ai]
        b_ids = index.rids[bi]
        keep = _dedup_extents(a_ids, b_ids, strand, a_s, a_e, b_s2, b_e2,
                              dist)
        return T.finalize(
            a_ids[keep], b_ids[keep], strand[keep],
            a_s[keep], a_e[keep], a_len[keep], b_s2[keep], b_e2[keep],
            blen[keep], dist[keep],
            params.min_overlap, params.min_idt)

    aligner.ext = ext      # occupancy / cell-accounting surface
    return aligner


def emit_symmetric(overlaps):
    """For each record, also emit the mirrored (b, a) record; returns all
    records in canonical full-field sort order.

    Columnar tables (overlap.table structured arrays) take the vectorized
    path; lists of records.Overlap keep the legacy object path (tests,
    text interop)."""
    if isinstance(overlaps, np.ndarray):
        return T.emit_symmetric(overlaps)
    all_recs = []
    flips = {R.CONTAINS: R.CONTAINED, R.CONTAINED: R.CONTAINS}
    for o in overlaps:
        all_recs.append(o)
        all_recs.append(R.Overlap(
            o.b_id, o.a_id, o.score, o.idt, 0, o.b_start, o.b_end, o.b_len,
            o.b_strand, o.a_start, o.a_end, o.a_len,
            flips.get(o.klass, o.klass)))
    # full-field key: the table order (and therefore every downstream
    # artifact) is identical no matter how records arrive -- single-host
    # plan order or multi-host gather order
    all_recs.sort(key=lambda o: (
        o.a_id, o.b_id, o.score, o.idt, o.a_start, o.a_end,
        o.b_strand, o.b_start, o.b_end, o.klass))
    return all_recs
