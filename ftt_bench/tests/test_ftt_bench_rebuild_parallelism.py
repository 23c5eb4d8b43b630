"""The reader of the host-MSA path's rebuild span (cns.rebuild with its
slices' busy time): workers busy at once, on hand-made recorder spans."""
from types import SimpleNamespace

import pytest

from ftt_bench import progspans, registry

REG = registry.Registry()


def rec(name, t0, t1, tid=1, id_=0, parent=0, key=None, **counts):
    """A recorder span (falcon_tpu_torch.utils.trace.Span's fields), its
    times given in seconds."""
    return SimpleNamespace(name=name, key=key, t0=int(t0 * 1e9),
                           t1=int(t1 * 1e9), tid=tid, id=id_, parent=parent,
                           counts=counts)


def run_of(w0=10.0, w1=20.0):
    return SimpleNamespace(w0=w0, w1=w1, window_s=w1 - w0, events=[], units=1,
                           cell=SimpleNamespace(tasks={"K1": [], "K2": []}))


@pytest.fixture
def records(monkeypatch):
    got = []
    monkeypatch.setattr(progspans, "program_records", lambda: got)
    return got


def test_rebuild_parallelism_reads_busy_over_span_time(records):
    """Two chunks' rebuilds: 2.5 s of busy in a 0.5 s span, then 2 s in a
    1 s span the window cuts in half (half its busy counted): 3.5 / 1 s.
    The DP path's cns.rebuild (a span a batch, no busy_us) and a span
    after the window count nothing; with those alone, nothing."""
    records.extend([rec("cns.run", 9, 21, id_=1),
                    rec("cns.collect", 15, 16, tid=2, id_=9),
                    rec("cns.rebuild", 12, 13, tid=2, id_=10, parent=9),
                    rec("cns.rebuild", 22, 23, tid=2, id_=11, batches=8,
                        slices=56, workers=7, busy_us=4_000_000)])
    assert REG.reader("cns.rebuild_parallelism")(run_of()) is None
    records.extend([
        rec("cns.rebuild", 15.4, 15.9, tid=2, id_=20, parent=9, batches=8,
            slices=56, workers=7, busy_us=2_500_000),
        rec("cns.rebuild", 19.5, 20.5, tid=2, id_=21, batches=8, slices=56,
            workers=7, busy_us=2_000_000),
    ])
    assert REG.reader("cns.rebuild_parallelism")(run_of()) == \
        pytest.approx(3.5 / 1.0)


def test_rebuild_parallelism_reads_one_worker_on_the_finisher(records):
    """Without a pool the finisher rebuilds: busy close to the span's
    time, about one worker."""
    records.append(rec("cns.rebuild", 11, 12, tid=2, batches=3, slices=3,
                       workers=1, busy_us=990_000))
    assert REG.reader("cns.rebuild_parallelism")(run_of()) == \
        pytest.approx(0.99)


def test_rebuild_parallelism_has_its_reader_and_cell():
    (m,) = [m for m in REG.spec["per_layer"]
            if m["name"] == "cns.rebuild_parallelism"]
    assert m["workloads"] == ["ecoli-hostmsa.consensus"]
    assert m["moves"] == "consensus_support_bases_per_s"
    assert (m["unit"], m["better"], m["source"], m["layer"]) == \
        ("workers", "higher", "program_counter", "cns.device")
    assert "ecoli-hostmsa.consensus" in {w["name"]
                                         for w in REG.spec["workloads"]}
    REG.reader("cns.rebuild_parallelism")
