"""The frozen simulator against the port's, its truth maps, and the seed
groups built from the truth."""
import numpy as np
import pytest

from ftt_bench import sim, traffic

READS = {"genome_size": 30000, "coverage": 8, "mean_len": 3000,
         "min_len": 1000, "error": 0.08}


def test_frozen_simulator_draws_the_ports_reads():
    from falcon_tpu_torch.utils import sim as port
    g = port.random_genome(20000, seed=5)
    assert sim.random_genome(20000, seed=5).tobytes().decode() == g
    for fast in (True, False):
        want = port.simulate_reads(g, coverage=3, mean_len=2000,
                                   min_len=800, error=0.08, seed=9,
                                   with_truth=True, fast=fast)
        reads, truth = sim.simulate_reads(
            np.frombuffer(g.encode(), np.uint8), coverage=3, mean_len=2000,
            min_len=800, error=0.08, seed=9, fast=fast)
        assert [r.tobytes().decode() for r in reads] == [w[1] for w in want]
        assert [tuple(x) for x in truth.tolist()] == [w[2] for w in want]


@pytest.mark.parametrize("fast", [True, False])
def test_maps_place_every_unchanged_base(fast):
    rng = np.random.RandomState(3)
    frag = sim.BASES[rng.randint(0, 4, 5000)]
    mut = sim.mutate_fast if fast else sim.mutate
    read, ops = mut(frag, rng, 0.03, 0.03, 0.03)
    pre = sim._pre_map(ops)
    assert pre[-1] == len(read)
    same = np.flatnonzero(ops == 0)
    assert (read[pre[same]] == frag[same]).all()
    assert (np.diff(pre) >= 0).all()


def test_seeds_of_any_whole_number():
    for s in (0, 7, 2 ** 31 + 5, 2 ** 40):
        a, b = traffic.seeds_of(s)
        assert 0 <= a < 2 ** 32 and 0 <= b < 2 ** 32
    assert traffic.seeds_of(2 ** 31 + 5) == traffic.seeds_of(2 ** 31 + 5)


def test_truth_groups_against_the_truth():
    rs = traffic.make_reads(READS, 11)
    cutoff = traffic.seed_cutoff(rs.lengths, 5, READS["genome_size"])
    groups = traffic.truth_groups(rs, cutoff, 1000)
    assert [g.rid for g in groups] == \
        np.flatnonzero(rs.lengths >= cutoff).tolist()
    st, en, sd = rs.truth.T
    for g in groups:
        a = g.rid
        sid, seed_seq, rng = g.items[0]
        assert sid == "%09d" % a and rng is None
        assert seed_seq == rs.reads[a].tobytes().decode()
        ids = [int(x[0]) for x in g.items[1:]]
        assert ids == sorted(ids)
        want = [b for b in range(len(rs.reads)) if b != a and
                min(en[a], en[b]) - max(st[a], st[b]) >= 1000]
        assert ids == want
        assert g.bases == len(rs.reads[a]) + sum(len(rs.reads[b])
                                                  for b in ids)
        for rid, codes, (s1, e1, s2, e2) in g.items[1:]:
            b = int(rid)
            fwd = traffic.CODE[rs.reads[b]]
            want_codes = fwd if sd[b] == sd[a] else (3 - fwd)[::-1]
            assert (codes == want_codes).all()
            # the two ranges come from one stretch of the genome
            g0, g1 = max(st[a], st[b]), min(en[a], en[b])
            assert rs.own_range(a, g0, g1) == (s2, e2)
            assert 0 <= s1 < e1 <= len(codes) and 0 <= s2 < e2 <= \
                len(seed_seq)


def test_truth_ranges_are_exact_without_errors():
    exact = dict(READS, error=0.0)
    rs = traffic.make_reads(exact, 4)
    groups = traffic.truth_groups(rs, 3000, 1000)
    assert groups
    for g in groups[:10]:
        seed = traffic.CODE[np.frombuffer(g.items[0][1].encode(), np.uint8)]
        for _, codes, (s1, e1, s2, e2) in g.items[1:]:
            assert (codes[s1:e1] == seed[s2:e2]).all()

