"""The one general generator: a read set from a traffic file's parameters
and the run's seed, and what the entries make of it (the FASTA the
pipeline reads, the seed groups the consensus entry pulls).

Every number comes from `--seed`: the genome and the reads are drawn by
the frozen simulator (sim.py) from two seeds that np.random.SeedSequence
derives from it, so any whole number is a valid seed.
"""

import numpy as np

from . import sim

CODE = np.full(256, 4, np.uint8)
for _i, _c in enumerate(b"ACGT"):
    CODE[_c] = _i


class ReadSet:
    """A simulated genome and its reads, with the truth of each read."""

    def __init__(self, genome, reads, truth, maps):
        self.genome = genome          # ASCII uint8
        self.reads = reads            # [ASCII uint8]
        self.truth = truth            # int64 [n, 3] (start, end, strand)
        self.maps = maps              # [int32 pre maps] (sim.py)
        self.lengths = np.fromiter((len(r) for r in reads), np.int64,
                                   len(reads))

    @property
    def total_bases(self):
        return int(self.lengths.sum())

    def own_range(self, r, lo, hi):
        """The interval of read r (its own orientation) that the genome
        interval [lo, hi) of its truth maps to."""
        s, e, strand = (int(x) for x in self.truth[r])
        pre = self.maps[r]
        if strand == 0:
            return int(pre[lo - s]), int(pre[hi - s])
        return int(pre[e - hi]), int(pre[e - lo])

    def to_genome(self, r, x0, x1):
        """The genome interval that the interval [x0, x1) of read r (its
        own orientation) was drawn from."""
        s, e, strand = (int(x) for x in self.truth[r])
        pre = self.maps[r]
        f0 = int(np.searchsorted(pre, x0, side="left"))
        f1 = int(np.searchsorted(pre, x1, side="left"))
        if strand == 0:
            return s + f0, s + f1
        return e - f1, e - f0

    def truth_seq(self, r):
        """The genome bases of read r's truth, on the read's strand."""
        s, e, strand = (int(x) for x in self.truth[r])
        frag = self.genome[s:e]
        return sim.rc(frag) if strand else frag


def seeds_of(seed):
    """(genome seed, reads seed): two 32-bit seeds from any whole number."""
    st = np.random.SeedSequence(int(seed)).generate_state(2)
    return int(st[0]), int(st[1])


def make_reads(params, seed, genome_size=None):
    """The read set of a traffic's `reads` parameters (genome_size,
    coverage, mean_len, min_len, error); genome_size may be overridden."""
    gs, rs = seeds_of(seed)
    size = int(genome_size or params["genome_size"])
    genome = sim.random_genome(size, seed=gs)
    reads, truth, maps = sim.simulate_reads(
        genome, coverage=params["coverage"], mean_len=params["mean_len"],
        min_len=params["min_len"], error=params["error"], seed=rs,
        fast=True, with_maps=True)
    return ReadSet(genome, reads, truth, maps)


def write_fasta(path, rs):
    """The reads as one-line FASTA records named %09d by index (the names
    the pipeline's ReadStore keeps, so its read ids are these indices)."""
    with open(path, "wb") as f:
        for i, r in enumerate(rs.reads):
            f.write(b">%09d\n" % i)
            f.write(r.tobytes())
            f.write(b"\n")


def seed_cutoff(lengths, coverage, genome_size):
    """Smallest length L such that reads of length >= L total at least
    coverage * genome_size bases (the seed auto-cutoff of FALCON's
    functional.py, as the port's ReadStore.calc_length_cutoff computes
    it)."""
    target = int(coverage) * int(genome_size)
    lens = np.sort(np.asarray(lengths))[::-1]
    csum = np.cumsum(lens)
    if len(lens) == 0 or csum[-1] < target:
        raise ValueError("not enough reads for the seed coverage")
    idx = int(np.searchsorted(csum, target))
    return int(lens[idx]) if idx < len(lens) else int(lens[-1])


class Group:
    """One seed group, as the consensus entry takes it."""
    __slots__ = ("rid", "items", "bases")

    def __init__(self, rid, items, bases):
        self.rid = rid
        self.items = items
        self.bases = bases


def truth_groups(rs, cutoff, min_overlap):
    """Seed groups from the simulator's truth, in the form the pipeline's
    _make_group gives run_consensus_device: for each read at or above the
    cut-off (ascending read id), (seed_id, [(seed_id, seed str, None),
    (read_id, support codes on the seed's strand, (s1, e1, s2, e2)), ...])
    with a support for every read whose true interval overlaps the seed's
    by at least min_overlap bases, in ascending read id (the pipeline driver's
    overlap-table order), its codes reverse-complemented when its strand
    differs from the seed's, and its truth range on the seed's strand."""
    n = len(rs.reads)
    codes = [CODE[r] for r in rs.reads]
    rc_codes = [None] * n
    st, en, sd = rs.truth[:, 0], rs.truth[:, 1], rs.truth[:, 2]
    stl, enl, sdl = st.tolist(), en.tolist(), sd.tolist()
    lens = rs.lengths.tolist()
    order = np.argsort(st, kind="stable")
    st_sorted = st[order]
    max_len = int((en - st).max()) if n else 0

    def own(r, lo, hi):
        # rs.own_range, inlined
        pre = rs.maps[r]
        if sdl[r] == 0:
            return int(pre[lo - stl[r]]), int(pre[hi - stl[r]])
        return int(pre[enl[r] - hi]), int(pre[enl[r] - lo])

    groups = []
    for a in np.flatnonzero(rs.lengths >= cutoff).tolist():
        a0, a1 = stl[a], enl[a]
        lo = np.searchsorted(st_sorted, a0 - max_len, side="left")
        hi = np.searchsorted(st_sorted, a1 - min_overlap, side="left")
        cand = order[lo:hi]
        ov = np.minimum(en[cand], a1) - np.maximum(st[cand], a0)
        cand = np.sort(cand[(ov >= min_overlap) & (cand != a)])
        sid = "%09d" % a
        items = [(sid, rs.reads[a].tobytes().decode(), None)]
        bases = lens[a]
        for b in cand.tolist():
            g0 = a0 if a0 > stl[b] else stl[b]
            g1 = a1 if a1 < enl[b] else enl[b]
            s2, e2 = own(a, g0, g1)
            s1, e1 = own(b, g0, g1)
            lb = lens[b]
            if sdl[b] != sdl[a]:
                if rc_codes[b] is None:
                    rc_codes[b] = np.where(codes[b] < 4, 3 - codes[b],
                                           codes[b])[::-1].copy()
                c = rc_codes[b]
                s1, e1 = lb - e1, lb - s1
            else:
                c = codes[b]
            items.append(("%09d" % b, c, (s1, e1, s2, e2)))
            bases += lb
        groups.append(Group(a, items, bases))
    return groups
