"""The plain reference that decides `correct`: NumPy only, and nothing of
the port.  It works from the simulator's truth (the genome, each read's
interval and strand, and the exact map of its bases), which the benchmark
made itself, and judges the port's outputs against it:

  preads     each sampled seed's consensus pieces, in 2 kb segments,
             each anchored by an exact probe in the seed's true genome
             interval and aligned to it (an edit distance with free target
             ends in a band), and the share of that interval that no
             anchored segment covers
  overlaps   sampled true read pairs looked up in the table, and sampled
             table rows mapped back to the genome through the reads' maps
  contigs    p_ctg.fa tiled into windows, anchored on either strand of the
             genome and aligned there; the covered share of the genome

Each check returns {name: value}; limits/<cell>.json holds the limits.
"""
import numpy as np

from . import sim

PROBE = 32
INF = 1 << 28


def banded_distance(queries, targets, w):
    """Edit distance of each query, whole, against a substring of its
    target that starts in [0, 2w] and is free at its end; the diagonal
    j - i stays in [0, 2w].  queries / targets: uint8 arrays (a target
    should run at least len(query) + 2w).  Returns an int64 array."""
    B = len(queries)
    if B == 0:
        return np.zeros(0, np.int64)
    nq = np.fromiter((len(q) for q in queries), np.int64, B)
    n = int(nq.max())
    width = 2 * w + 1
    Q = np.full((B, n), 255, np.uint8)
    T = np.full((B, n + width), 254, np.uint8)
    for k in range(B):
        Q[k, :nq[k]] = queries[k]
        t = targets[k][:n + width]
        T[k, :len(t)] = t
    band = np.arange(width, dtype=np.int64)
    prev = np.zeros((B, width), np.int64)           # row 0: free start
    out = np.where(nq == 0, 0, INF).astype(np.int64)
    for i in range(1, n + 1):
        cost = (T[:, i - 1:i - 1 + width] != Q[:, i - 1:i]).astype(np.int64)
        up = np.empty_like(prev)
        up[:, :-1] = prev[:, 1:] + 1
        up[:, -1] = INF
        e = np.minimum(prev + cost, up)
        cur = band + np.minimum.accumulate(e - band, axis=1)
        done = nq == i
        if done.any():
            out[done] = cur[done].min(axis=1)
        prev = cur
    return out


def anchor(piece, src, tries=64):
    """Position in src where piece starts, by an exact probe of 32 bases
    at piece offsets 0, 32, 64, ... (the first `tries`, past errors near
    the piece's start, where a consensus is thinnest), or None."""
    s = src.tobytes() if isinstance(src, np.ndarray) else src
    p = piece.tobytes() if isinstance(piece, np.ndarray) else piece
    for k in range(tries):
        probe = p[k * PROBE:(k + 1) * PROBE]
        if len(probe) < PROBE:
            return None
        pos = s.find(probe)
        if pos >= 0:
            return pos - k * PROBE
    return None


def _align_pieces(pieces, w=64):
    """pieces: [(query uint8, target uint8 array, anchor)] -> distances,
    each target cut to start w before its anchor."""
    qs, ts = [], []
    for q, t, pos in pieces:
        start = max(0, pos - w)
        pad = w - (pos - start)
        tt = t[start:pos + len(q) + 2 * w]
        if pad:
            tt = np.concatenate([np.full(pad, 253, np.uint8), tt])
        qs.append(q)
        ts.append(tt)
    out = np.zeros(len(qs), np.int64)
    order = np.argsort([len(q) for q in qs])
    for ofs in range(0, len(order), 64):
        sel = order[ofs:ofs + 64]
        out[sel] = banded_distance([qs[i] for i in sel],
                                   [ts[i] for i in sel], w)
    return out


def segments(n, seg=2000):
    """[(start, end)] cutting n bases into pieces of seg, a tail shorter
    than seg // 2 joined to the piece before it."""
    cuts = list(range(0, n, seg)) + [n]
    if len(cuts) > 2 and cuts[-1] - cuts[-2] < seg // 2:
        del cuts[-2]
    return list(zip(cuts[:-1], cuts[1:]))


def check_preads(rs, pulled, preads, sample, seed):
    """pulled: the seed read ids in pull order; preads: {pull index:
    [piece uint8 ASCII]}.  Over a sample of pulls (drawn from seed):
    pread_error, the pieces' edit distance to their seed's truth over
    their length, each piece judged in 2 kb segments that are anchored
    and aligned on their own (a long piece's length drifts from its
    truth's by more than a band holds), where a segment that lands
    nowhere in its seed's truth counts whole and a pull with nothing that
    lands counts its seed's truth whole, in errors and in length;
    pread_missing, the share of the seeds' truth that no anchored segment
    covers."""
    rng = np.random.default_rng(seed)
    k = min(sample, len(pulled))
    picks = rng.choice(len(pulled), size=k, replace=False) if k else []
    work = []
    wrong = 0
    total = 0
    missing = 0
    truth_total = 0
    for p in sorted(int(x) for x in picks):
        truth = rs.truth_seq(pulled[p])
        covered = np.zeros(len(truth), bool)
        found = 0
        for piece in preads.get(p, []):
            total += len(piece)
            for s0, s1 in segments(len(piece)):
                q = piece[s0:s1]
                pos = anchor(q, truth)
                if pos is None:
                    wrong += len(q)
                    continue
                work.append((q, truth, pos))
                covered[max(0, pos):max(0, pos + len(q))] = True
                found += 1
        if not found:
            wrong += len(truth)
            total += len(truth)
        missing += int((~covered).sum())
        truth_total += len(truth)
    dist = _align_pieces(work)
    return {"pread_error": (int(dist.sum()) + wrong) / total
            if total else 1.0,
            "pread_missing": missing / truth_total if truth_total else 1.0}


def true_pairs(rs, min_overlap):
    """Every unordered read pair (a < b) whose true intervals overlap by
    at least min_overlap bases, as int64 keys a * n + b."""
    n = len(rs.reads)
    st, en = rs.truth[:, 0], rs.truth[:, 1]
    order = np.argsort(st, kind="stable")
    sst = st[order]
    keys = []
    for k in range(n):
        a = order[k]
        hi = np.searchsorted(sst, en[a] - min_overlap, side="left")
        if hi <= k + 1:
            continue
        b = order[k + 1:hi]
        b = b[np.minimum(en[b], en[a]) - np.maximum(st[b], st[a])
              >= min_overlap]
        lo_, hi_ = np.minimum(a, b), np.maximum(a, b)
        keys.append(lo_ * n + hi_)
    return np.unique(np.concatenate(keys)) if keys else \
        np.zeros(0, np.int64)


def read_table(path):
    """The 13-column overlap table as int64 columns a_id b_id a_start
    a_end a_len b_strand b_start b_end b_len."""
    cols = np.loadtxt(path, dtype=np.int64, comments="---",
                      usecols=(0, 1, 5, 6, 7, 8, 9, 10, 11), ndmin=2)
    names = ("a_id", "b_id", "a_start", "a_end", "a_len", "b_strand",
             "b_start", "b_end", "b_len")
    return {nm: cols[:, i] for i, nm in enumerate(names)}


def check_overlaps(rs, tbl, min_overlap, sample, seed):
    """ovl_wrong: over `sample` true read pairs (overlap >= min_overlap
    bases) and `sample` table rows, both drawn from seed, the share that
    is wrong: a true pair with no row, or a row whose two intervals do not
    come from one stretch of the genome on the strand the row states
    (their genome intervals sharing < 90% of the longer)."""
    n = len(rs.reads)
    rng = np.random.default_rng(seed)
    truth = true_pairs(rs, min_overlap)
    a, b = tbl["a_id"], tbl["b_id"]
    have = np.unique(np.minimum(a, b) * n + np.maximum(a, b))
    k1 = min(sample, len(truth))
    pick = rng.choice(truth, size=k1, replace=False) if k1 else truth[:0]
    missed = int((~np.isin(pick, have)).sum())
    rows = np.flatnonzero(a < b)
    k2 = min(sample, len(rows))
    rows = rng.choice(rows, size=k2, replace=False) if k2 else rows[:0]
    bad = 0
    for r in rows.tolist():
        ai, bi = int(a[r]), int(b[r])
        if not (0 <= ai < n and 0 <= bi < n) or \
                tbl["a_len"][r] != rs.lengths[ai] or \
                tbl["b_len"][r] != rs.lengths[bi]:
            bad += 1
            continue
        strand = int(rs.truth[ai, 2] != rs.truth[bi, 2])
        ga = rs.to_genome(ai, int(tbl["a_start"][r]), int(tbl["a_end"][r]))
        gb = rs.to_genome(bi, int(tbl["b_start"][r]), int(tbl["b_end"][r]))
        ov = min(ga[1], gb[1]) - max(ga[0], gb[0])
        if strand != int(tbl["b_strand"][r]) or \
                ov < 0.9 * max(ga[1] - ga[0], gb[1] - gb[0], 1):
            bad += 1
    if not k1:
        return {"ovl_wrong": 1.0}
    return {"ovl_wrong": (missed + bad) / (k1 + k2)}


def read_fasta(path):
    """[(name, uint8 ASCII sequence)] of a FASTA file."""
    out = []
    name, parts = None, []
    with open(path, "rb") as f:
        for line in f:
            line = line.strip()
            if line.startswith(b">"):
                if name is not None:
                    out.append((name, np.frombuffer(b"".join(parts),
                                                    np.uint8)))
                name, parts = line[1:].decode(), []
            elif line:
                parts.append(line)
    if name is not None:
        out.append((name, np.frombuffer(b"".join(parts), np.uint8)))
    return out


def check_contigs(genome, contigs, win=5000):
    """ctg_missed: the share of the genome that no anchored contig window
    covers; ctg_error: the windows' edit distance over their length (a
    window that anchors nowhere counts whole)."""
    G = len(genome)
    fwd = genome.tobytes()
    grc = sim.rc(genome)
    rcb = grc.tobytes()
    covered = np.zeros(G, bool)
    work = []
    unanchored = 0
    total = 0
    for s in sorted((c for _, c in contigs), key=lambda c: -len(c)):
        for w0 in range(0, max(1, len(s) - PROBE), win):
            q = s[w0:w0 + win]
            total += len(q)
            hit = None
            for src, arr, strand in ((fwd, genome, 0), (rcb, grc, 1)):
                pos = anchor(q, src)
                if pos is not None and pos >= 0:
                    hit = (arr, pos, strand)
                    break
            if hit is None:
                unanchored += len(q)
                continue
            arr, pos, strand = hit
            work.append((q, arr, pos))
            lo, hi = pos, min(G, pos + len(q))
            if strand:
                lo, hi = G - hi, G - lo
            covered[lo:hi] = True
    dist = _align_pieces(work)
    err = (int(dist.sum()) + unanchored) / total if total else 1.0
    return {"ctg_missed": 1.0 - float(covered.mean()), "ctg_error": err}
