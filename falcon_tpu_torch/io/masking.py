"""Soft-mask tracks: low-complexity (dust) + tandem-repeat intervals.

TPU-native replacement for the reference's DBdust + datander/TANmask/
Catrack chain, which it runs on every read DB before daligner
(reference: falcon_kit/bash.py:164-213 builds `DBdust raw_reads` and the
`HPC.TANmask` plan into every rdb script; falcon_kit/mains/dazzler.py:
220-338 tan-split/apply/combine; masks are then passed to daligner as
`-mdust -mtan`).  The masks are SOFT: they only suppress seed k-mers in
the overlap engine -- alignment and consensus always see the real bases,
exactly like daligner's `-m` masks only gate seed hits.

Algorithms (linear-time, vectorized; same role, not a port):

  dust    a base is low-complexity when most triplets in its 64bp window
          recur at short range: for each triplet position, compute the
          distance to the previous occurrence of the same triplet; a
          window whose fraction of triplets with distance <= 8 exceeds
          min_frac is masked.  Catches homopolymers and short-period
          (1-8bp) microsatellites -- the DBdust content class.
  tandem  a k-mer recurring within max_period bases ON THE SAME READ is
          tandem evidence; the span between the two occurrences is
          masked (the datander/TANmask interval semantics: self-overlap
          off the main diagonal).

Both run over the store's flat code array with read-boundary
invalidation, so one pass handles the whole DB.
"""
import logging

import numpy as np

LOG = logging.getLogger(__name__)


def _near_repeat_hits(keys, ok, max_period, chunk=8192):
    """(positions, distances) of ok entries whose key recurred at an ok
    position within max_period entries before them.

    Chunked packed sort: a recurrence within max_period spans at most
    max_period compacted entries, so sorting overlapping [chunk] rows
    (stride chunk - max_period) finds every pair while each row sort
    stays in cache -- ~10x a global 100M-element lexsort.  Duplicate
    hits from overlapping rows are deduped."""
    pos = np.flatnonzero(ok).astype(np.int64)
    m = len(pos)
    if m < 2:
        return (np.zeros(0, np.int64),) * 2
    assert chunk > max_period
    # the packing puts pos in the low 32 bits and the key in the upper
    # 31: a flat store >= 2^32 bases or keys >= 2^31 (K >= 16) would
    # silently corrupt the packed order -> wrong masks
    assert pos[-1] < np.int64(1) << 32, "flat store too large to pack"
    assert int(keys.max()) < 1 << 31, "k-mer keys too wide to pack (K>=16?)"
    packed = (keys[pos].astype(np.int64) << 32) | pos
    step = chunk - max_period
    nrows = max(1, -(-(m - max_period) // step))
    starts = np.minimum(np.arange(nrows, dtype=np.int64) * step,
                        max(0, m - chunk))
    idx = starts[:, None] + np.arange(chunk, dtype=np.int64)[None, :]
    idx = np.minimum(idx, m - 1)
    rows = packed[idx]
    rows.sort(axis=1)                       # in-cache row sorts
    same = (rows[:, 1:] >> 32) == (rows[:, :-1] >> 32)
    p2 = rows[:, 1:] & np.int64(0xFFFFFFFF)
    p1 = rows[:, :-1] & np.int64(0xFFFFFFFF)
    d = p2 - p1
    hit = same & (d > 0) & (d <= max_period)
    hp = p2[hit]
    hd = d[hit]
    if len(hp) == 0:
        return hp, hd
    # truncated overlap rows can pair a position with a farther prior
    # occurrence; keep the smallest distance per position (= distance to
    # the true previous occurrence, as the global-sort version computed)
    order = np.lexsort((hd, hp))
    hp, hd = hp[order], hd[order]
    first = np.r_[True, hp[1:] != hp[:-1]]
    return hp[first], hd[first]


def _read_of(offsets, n):
    pos = np.arange(n, dtype=np.int64)
    return np.searchsorted(offsets, pos, side="right") - 1


def _kmer_keys(codes, K):
    dt = np.int32 if K <= 15 else np.int64
    c = codes.astype(dt)
    n = len(c)
    if n < K:
        return np.zeros(0, dtype=dt), np.zeros(0, dtype=bool)
    bad = c > 3
    c = np.where(bad, 0, c)
    acc = np.zeros(n - K + 1, dtype=dt)
    ok = np.ones(n - K + 1, dtype=bool)
    for i in range(K):
        acc = acc * 4 + c[i:n - K + 1 + i]
        ok &= ~bad[i:n - K + 1 + i]
    return acc, ok


def _boundary_ok(nk, offsets, K):
    """ok[i] False when the K-mer at flat position i crosses a read
    boundary (diff-array paint over the read ends; no per-position
    searchsorted)."""
    dif = np.zeros(nk + 1, dtype=np.int32)
    ends = offsets[1:]
    lo = np.maximum(ends - K + 1, 0)
    hi = np.minimum(ends, nk)
    keep = lo < hi
    np.add.at(dif, lo[keep], 1)
    np.add.at(dif, hi[keep], -1)
    return np.cumsum(dif[:-1]) == 0


def dust_mask(codes, offsets, window=64, max_dist=8, min_frac=0.7):
    """Per-base low-complexity mask over a flat code array."""
    n = len(codes)
    mask = np.zeros(n, dtype=bool)
    if n < 3:
        return mask
    keys, ok = _kmer_keys(codes, 3)
    nk = len(keys)
    keys = keys.astype(np.uint8)          # 6-bit triplet keys
    # invalidate triplets spanning read boundaries
    ok &= _boundary_ok(nk, offsets, 3)
    # repeat-within-max_dist as max_dist shifted compares (no sort):
    # rep[i] = any j in [1, max_dist] with keys[i-j] == keys[i], both
    # ok.  A boundary between i-j and i implies an invalid (not-ok)
    # triplet in between only when j >= 3; for j < 3 the previous-read
    # triplet could alias, so the shifted compare also requires no read
    # end inside (i-j, i] -- tracked with a cheap distance-to-read-start
    # uint8 plane.
    rep_b = np.zeros(nk, dtype=bool)
    dstart = np.minimum(
        np.arange(nk, dtype=np.int64) -
        np.repeat(offsets[:-1], np.diff(offsets))[:nk], 255
    ).astype(np.uint8)
    for j in range(1, max_dist + 1):
        if j >= nk:
            break
        m = (keys[j:] == keys[:-j]) & ok[j:] & ok[:-j] & (dstart[j:] >= j)
        rep_b[j:] |= m
    rep = rep_b.astype(np.int64)
    cs = np.concatenate([[0], np.cumsum(rep)])
    w = min(window, len(keys))
    if w < 8:
        return mask
    # windowed repeat fraction; window [i, i+w) of triplet positions
    cnt = cs[w:] - cs[:-w]                       # [len(keys)-w+1]
    hot = cnt >= min_frac * w
    # a hot window masks its whole base span [i, i+w+2)
    if hot.any():
        dif = np.zeros(n + 1, dtype=np.int64)
        hi = np.flatnonzero(hot)
        np.add.at(dif, hi, 1)
        np.add.at(dif, np.minimum(hi + w + 2, n), -1)
        mask = np.cumsum(dif[:-1]) > 0
        # clip each masked run to its read (hot windows never span reads
        # because boundary triplets are invalid, but be safe)
    return mask


def tandem_mask(codes, offsets, k=12, max_period=500):
    """Per-base tandem-repeat mask: spans between same-read k-mer
    recurrences with period in [k, max_period]."""
    n = len(codes)
    mask = np.zeros(n, dtype=bool)
    keys, ok = _kmer_keys(codes, k)
    if len(keys) == 0:
        return mask
    ok &= _boundary_ok(len(keys), offsets, k)
    hp, hd = _near_repeat_hits(keys, ok, max_period)
    if len(hp) == 0:
        return mask
    # same-read + period gates, evaluated only at the sparse hits
    ro_hp = np.searchsorted(offsets, hp, side="right") - 1
    keep = (hd >= k) & (hp - hd >= offsets[ro_hp])
    hp, hd = hp[keep], hd[keep]
    if len(hp) == 0:
        return mask
    # confirmation: a lone k-mer recurrence is not tandem evidence (a
    # random 12-mer collision would mask up to max_period bases); require
    # an adjacent hit with a consistent period, which true tandems give
    # at every position (TANmask's extended-self-alignment role)
    conf = np.zeros(len(hp), dtype=bool)
    if len(hp) > 1:
        near = (hp[1:] - hp[:-1] <= 2 * k) & \
            (np.abs(hd[1:] - hd[:-1]) <= 8)
        conf[:-1] |= near
        conf[1:] |= near
    hp, hd = hp[conf], hd[conf]
    if len(hp) == 0:
        return mask
    starts = hp - hd
    ends = np.minimum(hp + k, n)
    dif = np.zeros(n + 1, dtype=np.int64)
    np.add.at(dif, starts, 1)
    np.add.at(dif, ends, -1)
    return np.cumsum(dif[:-1]) > 0


def build_mask(codes, offsets, dust=True, tandem=True, **kw):
    """Combined per-base soft mask for a flat store (bool array).

    dust and tandem are independent, so they run on two threads.  The
    C++ kernels (ops.native.dust_mask/tandem_mask, bit-identical output,
    ~20x the numpy versions -- the numpy path cost 815s of the 40Mb e2e)
    are used when available; this module stays the reference
    implementation and fallback."""
    from ..ops import native as _native
    use_native = _native.available()
    _dust = _native.dust_mask if use_native else dust_mask
    _tandem = _native.tandem_mask if use_native else tandem_mask
    m = np.zeros(len(codes), dtype=bool)
    jobs = []
    if dust:
        jobs.append(_dust)
    if tandem:
        jobs.append(_tandem)
    if len(jobs) > 1:
        from concurrent.futures import ThreadPoolExecutor
        with ThreadPoolExecutor(len(jobs)) as tpe:
            for r in tpe.map(lambda f: f(codes, offsets), jobs):
                m |= r
        jobs = []
    for f in jobs:
        m |= f(codes, offsets)
    LOG.info("masking: %d/%d bases soft-masked (%.2f%%)",
             int(m.sum()), len(m), 100.0 * m.sum() / max(1, len(m)))
    return m


def apply_seed_mask(codes, mask):
    """Seeding view of a code array: masked bases become 255 (invalid
    for k-mer keys), leaving the original array untouched for
    alignment."""
    if mask is None:
        return codes
    return np.where(mask, np.uint8(255), codes)
