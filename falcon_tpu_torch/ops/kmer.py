"""K-mer seeding and aligned-range selection -- exact host implementation.

Re-implements the semantics of the reference's direct-address k-mer table
and its two seed-chaining range finders (reference: src/c/kmer_lookup.c):

  * KmerLookup.add_sequence    -- kmer_lookup.c:140-192 (2-bit rolling hash,
                                  linked position lists in insertion order)
  * KmerLookup.mask            -- kmer_lookup.c:195-204
  * find_kmer_pos_for_seq      -- kmer_lookup.c:207-286 (query scanned at
                                  stride K/2; emits (q_pos, t_pos) pairs)
  * find_best_aln_range        -- kmer_lookup.c:294-427 (diagonal histogram
                                  + Kadane-style scan, score 32-dq)
  * find_best_aln_range2       -- kmer_lookup.c:429-585 (sorted-diagonal
                                  window + chained sparse DP, 320bp gap cap)

Quirk-compatibility notes (kept deliberately for bit parity, validated
against the compiled reference in tests/test_kmer_oracle.py):
  * both loops `for i < seq_len - K` EXCLUDE the final k-mer starting at
    seq_len-K;
  * non-ACGT characters keep the previous table value (0xff) and enter the
    rolling hash as (0xff & 3) == 3 ('T');
  * find_best_aln_range2 line 458: `max_t` is assigned `max_q` whenever the
    current max_t exceeds target_pos (a reference bug affecting `delta`).
"""
import numpy as np


def _codes(seq):
    if isinstance(seq, np.ndarray):
        a = seq.astype(np.uint8, copy=False)
    elif isinstance(seq, bytes):
        a = np.frombuffer(seq, dtype=np.uint8)
    else:
        a = np.frombuffer(seq.encode(), dtype=np.uint8)
    code = np.full(256, 0xFF, dtype=np.uint8)
    code[ord("A")] = 0
    code[ord("C")] = 1
    code[ord("G")] = 2
    code[ord("T")] = 3
    return code[a]


def kmer_keys(codes, K):
    """Rolling 2-bit k-mer keys for positions 0..len-K (inclusive end).

    Non-ACGT codes contribute (code & 3)."""
    c = (codes & 3).astype(np.int64)
    n = len(c) - K + 1
    if n <= 0:
        return np.zeros(0, dtype=np.int64)
    from numpy.lib.stride_tricks import sliding_window_view
    weights = 4 ** np.arange(K - 1, -1, -1, dtype=np.int64)
    win = sliding_window_view(c, K)
    return (win * weights[None, :]).sum(axis=1)


class KmerLookup:
    """Direct-address k-mer table over one target sequence (the seed)."""

    def __init__(self, target, K):
        self.K = K
        self.codes = _codes(target)
        n = len(self.codes)
        # positions 0..n-K-1 (exclusive of the final k-mer; see module doc)
        nkeys = max(0, n - K)
        keys = kmer_keys(self.codes, K)[:nkeys] if nkeys > 0 else np.zeros(0, np.int64)
        self._keys = keys
        # position lists in increasing-position order == insertion order
        order = np.argsort(keys, kind="stable")
        sk = keys[order]
        self._sorted_pos = order.astype(np.int64)
        self._uniq, self._starts = np.unique(sk, return_index=True)
        self._counts = np.diff(np.append(self._starts, len(sk)))
        self._masked = np.zeros(len(self._uniq), dtype=bool)

    def mask(self, threshold):
        """Hide k-mers occurring more than threshold times
        (kmer_lookup.c:195-204)."""
        self._masked |= self._counts > threshold

    def positions(self, key):
        i = np.searchsorted(self._uniq, key)
        if i >= len(self._uniq) or self._uniq[i] != key or self._masked[i]:
            return None
        s = self._starts[i]
        return np.sort(self._sorted_pos[s:s + self._counts[i]])

    def find_kmer_pos_for_seq(self, query):
        """(query_pos, target_pos) hit arrays, query scanned at stride K//2
        (kmer_lookup.c:207-286)."""
        K = self.K
        qc = _codes(query)
        half_K = K >> 1
        qp, tp = [], []
        n = len(qc)
        if n - K <= 0:
            return (np.zeros(0, dtype=np.int64),) * 2
        qkeys = kmer_keys(qc, K)
        for i in range(0, n - K, half_K):
            pos = self.positions(int(qkeys[i]))
            if pos is None:
                continue
            qp.extend([i] * len(pos))
            tp.extend(pos.tolist())
        return np.asarray(qp, dtype=np.int64), np.asarray(tp, dtype=np.int64)


class AlnRange:
    __slots__ = ("s1", "e1", "s2", "e2", "score")

    def __init__(self, s1=0, e1=0, s2=0, e2=0, score=0):
        self.s1, self.e1, self.s2, self.e2, self.score = s1, e1, s2, e2, score

    def astuple(self):
        return (self.s1, self.e1, self.s2, self.e2, self.score)


def find_best_aln_range(qpos, tpos, K, bin_size, count_th):
    """Diagonal-histogram range finder (kmer_lookup.c:294-427)."""
    qpos = np.asarray(qpos, dtype=np.int64)
    tpos = np.asarray(tpos, dtype=np.int64)
    n = len(qpos)
    if n == 0:
        # C computes d_min=INT_MAX, d_max=LONG_MIN then callocs a negative
        # size -> undefined; callers never hit this with 0 hits in practice.
        return AlnRange()
    d = qpos - tpos
    d_min = int(d.min())
    bins = (d - d_min) // bin_size
    nbins = int(bins.max()) + 1
    d_count = np.bincount(bins, minlength=nbins).astype(np.int64)

    # first strictly-greater max as scanned over hits in order
    max_count = 0
    max_bin = None
    for i in range(n):
        b = int(bins[i])
        if d_count[b] > max_count:
            max_count = int(d_count[b])
            max_bin = b

    q_coor, t_coor = [], []
    if max_bin is not None and max_count > count_th:
        for i in range(n):
            b = int(bins[i])
            if abs(b - max_bin) > 5:
                continue
            if d_count[b] > count_th:
                q_coor.append(int(qpos[i]))
                t_coor.append(int(tpos[i]))

    j = len(q_coor)
    r = AlnRange()
    if j > 1:
        r.s1 = q_coor[0]
        r.e1 = q_coor[0]
        r.s2 = t_coor[0]
        r.e2 = t_coor[0]
        r.score = 0
        max_score = 0
        cur_score = 0
        cur_start = 0
        for i in range(1, j):
            cur_score += 32 - (q_coor[i] - q_coor[i - 1])
            if cur_score < 0:
                cur_score = 0
                cur_start = i
            elif cur_score > max_score:
                r.s1 = q_coor[cur_start]
                r.s2 = t_coor[cur_start]
                r.e1 = q_coor[i]
                r.e2 = t_coor[i]
                max_score = cur_score
                r.score = max_score
    return r


def find_best_aln_range2(qpos, tpos, K, bin_width, count_th):
    """Sorted-diagonal window + chained sparse DP (kmer_lookup.c:429-585)."""
    qpos = np.asarray(qpos, dtype=np.int64)
    tpos = np.asarray(tpos, dtype=np.int64)
    n = len(qpos)
    r = AlnRange()
    if n == 0:
        return r
    d_coor = np.sort(qpos - tpos)
    max_q = -1
    max_t = -1
    for i in range(n):
        max_q = max_q if max_q > qpos[i] else int(qpos[i])
        # reference bug kept: assigns max_q when max_t > tpos (line 458)
        max_t = max_q if max_t > tpos[i] else int(tpos[i])

    s = 0
    e = 0
    max_s = -1
    max_e = -1
    max_span = -1
    delta = int(0.05 * (max_q + max_t))
    d_len = n
    while True:
        d_s = d_coor[s]
        d_e = d_coor[e]
        while d_e < d_s + delta and e < d_len - 1:
            e += 1
            d_e = d_coor[e]
        if max_span == -1 or e - s > max_span:
            max_span = e - s
            max_s = s
            max_e = e
        s += 1
        if s == d_len or e == d_len:
            break

    if max_s == -1 or max_e == -1 or max_e - max_s < 32:
        return r

    lo = d_coor[max_s]
    hi = d_coor[max_e]
    last_hit = np.full(n, -1, dtype=np.int64)
    hit_score = np.zeros(n, dtype=np.int64)
    hit_count = np.zeros(n, dtype=np.int64)
    max_hit_idx = -1
    max_hit_score = 0
    max_hit_count = 0
    for i in range(n):
        cx = int(qpos[i])
        cy = int(tpos[i])
        d = cx - cy
        if d < lo or d > hi:
            continue
        j = i - 1
        candidate_idx = -1
        max_d = 65535
        while True:
            if j < 0:
                break
            px = int(qpos[j])
            py = int(tpos[j])
            dj = px - py
            if dj < lo or dj > hi:
                j -= 1
                continue
            if cx - px > 320:
                break
            if cy > py and cx - px + cy - py < max_d and cy - py <= 320:
                max_d = cx - px + cy - py
                candidate_idx = j
            j -= 1
        if candidate_idx != -1:
            last_hit[i] = candidate_idx
            hit_score[i] = hit_score[candidate_idx] + (64 - max_d)
            hit_count[i] = hit_count[candidate_idx] + 1
            if hit_score[i] < 0:
                hit_score[i] = 0
                hit_count[i] = 0
        else:
            hit_score[i] = 0
            hit_count[i] = 0
        if hit_score[i] > max_hit_score:
            max_hit_score = int(hit_score[i])
            max_hit_count = int(hit_count[i])
            max_hit_idx = i

    if max_hit_idx == -1:
        return r

    r.score = max_hit_count + 1
    r.e1 = int(qpos[max_hit_idx])
    r.e2 = int(tpos[max_hit_idx])
    i = max_hit_idx
    while last_hit[i] != -1:
        i = int(last_hit[i])
    r.s1 = int(qpos[i])
    r.s2 = int(tpos[i])
    return r
