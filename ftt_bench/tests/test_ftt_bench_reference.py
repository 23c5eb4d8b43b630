"""The plain reference at toy size."""
import numpy as np
import pytest

from ftt_bench import reference, sim, traffic


def edit_free_target(q, t):
    """Plain full DP: q whole against any substring of t."""
    n, m = len(q), len(t)
    prev = [0] * (m + 1)
    for i in range(1, n + 1):
        cur = [i] + [0] * m
        for j in range(1, m + 1):
            cur[j] = min(prev[j - 1] + (q[i - 1] != t[j - 1]), prev[j] + 1,
                         cur[j - 1] + 1)
        prev = cur
    return min(prev)


@pytest.mark.parametrize("seed", range(6))
def test_banded_distance_matches_full_dp(seed):
    rng = np.random.RandomState(seed)
    g = sim.BASES[rng.randint(0, 4, 400)]
    qs, ts, want = [], [], []
    for k in range(5):
        lo = rng.randint(0, 40)
        frag = g[lo + 8:lo + 8 + rng.randint(50, 300)]
        q, _ = sim.mutate_fast(frag, rng, 0.03, 0.03, 0.03)
        t = g[lo:]
        qs.append(q)
        ts.append(t)
        want.append(edit_free_target(q.tolist(), t[:len(q) + 40].tolist()))
    got = reference.banded_distance(qs, [t[:len(q) + 40] for q, t in
                                         zip(qs, ts)], 20)
    assert got.tolist() == want


def test_check_preads_on_truth_and_on_errors():
    rs = traffic.make_reads({"genome_size": 20000, "coverage": 6,
                             "mean_len": 3000, "min_len": 1000,
                             "error": 0.08}, 3)
    pulled = list(range(len(rs.reads)))
    exact = {p: [rs.truth_seq(r)[100:-100]] for p, r in enumerate(pulled)}
    got = reference.check_preads(rs, pulled, exact, 20, 0)
    assert got["pread_error"] == 0.0
    assert 0 < got["pread_missing"] < 200 / 1000
    whole = {p: [rs.truth_seq(r)] for p, r in enumerate(pulled)}
    assert reference.check_preads(rs, pulled, whole, 20, 0) == {
        "pread_error": 0.0, "pread_missing": 0.0}
    # a consensus cut short is exact where it lands, and leaves its
    # seed's end uncovered
    cut = {p: [s[0][:len(s[0]) * 7 // 10]] for p, s in whole.items()}
    got = reference.check_preads(rs, pulled, cut, 20, 0)
    assert got["pread_error"] == 0.0
    assert got["pread_missing"] == pytest.approx(0.3, abs=0.01)
    rng = np.random.RandomState(1)
    noisy = {p: [sim.mutate_fast(s[0], rng, 0.01, 0.0, 0.0)[0]]
             for p, s in exact.items()}
    got = reference.check_preads(rs, pulled, noisy, 20, 0)
    assert 0.005 < got["pread_error"] < 0.02
    half = {p: s for p, s in exact.items() if p % 2}
    got = reference.check_preads(rs, pulled, half, len(pulled), 0)
    assert 0.3 < got["pread_error"] < 0.7
    assert 0.3 < got["pread_missing"] < 0.7
    # the seed's own read (8% error) is no consensus
    raw = {p: [rs.reads[r]] for p, r in enumerate(pulled)}
    assert reference.check_preads(rs, pulled, raw, 20, 0)[
        "pread_error"] > 0.04


def test_check_overlaps_on_a_truth_table():
    rs = traffic.make_reads({"genome_size": 20000, "coverage": 6,
                             "mean_len": 3000, "min_len": 1000,
                             "error": 0.08}, 5)
    n = len(rs.reads)
    keys = reference.true_pairs(rs, 1000)
    a, b = keys // n, keys % n
    rows = {k: [] for k in ("a_id", "b_id", "a_start", "a_end", "a_len",
                            "b_strand", "b_start", "b_end", "b_len")}
    for x, y in zip(a.tolist(), b.tolist()):
        g0 = max(rs.truth[x, 0], rs.truth[y, 0])
        g1 = min(rs.truth[x, 1], rs.truth[y, 1])
        for p, q in ((x, y), (y, x)):
            ps, pe = rs.own_range(p, g0, g1)
            qs, qe = rs.own_range(q, g0, g1)
            for k, v in (("a_id", p), ("b_id", q), ("a_start", ps),
                         ("a_end", pe), ("a_len", rs.lengths[p]),
                         ("b_strand", int(rs.truth[p, 2] != rs.truth[q, 2])),
                         ("b_start", qs), ("b_end", qe),
                         ("b_len", rs.lengths[q])):
                rows[k].append(v)
    tbl = {k: np.asarray(v, np.int64) for k, v in rows.items()}
    got = reference.check_overlaps(rs, tbl, 1000, 500, 0)
    assert got == {"ovl_wrong": 0.0}
    keep = np.arange(len(tbl["a_id"])) % 4 < 2       # drop half the pairs
    half = {k: v[keep] for k, v in tbl.items()}
    assert reference.check_overlaps(rs, half, 1000, 500, 0)[
        "ovl_wrong"] > 0.15
    moved = dict(tbl, b_id=(tbl["b_id"] + 1) % n)
    assert reference.check_overlaps(rs, moved, 1000, 500, 0)[
        "ovl_wrong"] > 0.5


def test_check_contigs():
    rng = np.random.RandomState(2)
    g = sim.random_genome(30000, seed=4)
    whole = reference.check_contigs(g, [("c0", g[:15000]),
                                        ("c1", sim.rc(g[15000:]))])
    assert whole["ctg_missed"] < 0.01 and whole["ctg_error"] == 0.0
    half = reference.check_contigs(g, [("c0", g[:15000])])
    assert half["ctg_missed"] == pytest.approx(0.5, abs=0.01)
    noisy = sim.mutate_fast(g, rng, 0.01, 0.0, 0.0)[0]
    assert 0.005 < reference.check_contigs(g, [("c", noisy)])[
        "ctg_error"] < 0.02


def test_anchor_past_a_noisy_start():
    rng = np.random.RandomState(7)
    truth = sim.BASES[rng.randint(0, 4, 3000)]
    piece = truth[300:2500].copy()
    piece[:200:9] = ord("A")          # a thin start: an error every 9 bases
    assert reference.anchor(piece, truth, tries=4) is None
    assert reference.anchor(piece, truth) == 300
    got = reference.check_preads(
        type("RS", (), {"truth_seq": lambda self, r: truth})(), [0],
        {0: [piece]}, 1, 0)
    assert 0 < got["pread_error"] < 0.02
