"""The reader of the host-MSA fan-out's span (cns.msa): workers busy at
once, on hand-made recorder spans."""
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


def test_msa_parallelism_reads_busy_over_span_time(records):
    """Two chunks' fan-outs: 6 s of busy in a 2 s span, then 3 s in a 2 s
    span the window cuts in half (half its busy counted): 7.5 / 3 s.  A
    span after the window counts nothing.  Without the span, as on the DP
    path, nothing."""
    records.extend([rec("cns.run", 9, 21, id_=1),
                    rec("cns.finish", 15, 19, tid=2, id_=9, key=7)])
    assert REG.reader("cns.msa_parallelism")(run_of()) is None
    records.extend([
        rec("cns.msa", 15.5, 17.5, tid=2, id_=20, parent=9, key=7,
            groups=12, workers=7, busy_us=6_000_000),
        rec("cns.msa", 19, 21, tid=2, id_=21, key=8, groups=12, workers=7,
            busy_us=3_000_000),
        rec("cns.msa", 22, 23, tid=2, id_=22, key=9, groups=12, workers=7,
            busy_us=1_000_000),
    ])
    assert REG.reader("cns.msa_parallelism")(run_of()) == \
        pytest.approx(7.5 / 3)


def test_msa_parallelism_has_its_reader_and_cell():
    (m,) = [m for m in REG.spec["per_layer"]
            if m["name"] == "cns.msa_parallelism"]
    assert m["workloads"] == ["ecoli-hostmsa.consensus"]
    assert m["moves"] == "consensus_support_bases_per_s"
    REG.reader("cns.msa_parallelism")
