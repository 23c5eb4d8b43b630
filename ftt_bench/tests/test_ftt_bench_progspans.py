"""The readers of the program's own spans (progspans.py) on hand-made
spans and device events: clipping to the window, self time, copies under
the dispatch, shares that read 0 or nothing, and the idle no span
covers."""
from types import SimpleNamespace

import numpy as np
import pytest

from ftt_bench import progspans, registry

REG = registry.Registry()


def rec(name, t0, t1, tid=1, id_=0, parent=0, key=None, **counts):
    """A recorder span (falcon_tpu_torch.utils.trace.Span's fields), its
    times given in seconds."""
    return SimpleNamespace(name=name, key=key, t0=int(t0 * 1e9),
                           t1=int(t1 * 1e9), tid=tid, id=id_, parent=parent,
                           counts=counts)


# main thread (1): a dispatch of 4 s holding copies, launches (one with a
# copy inside it) and a device wait; a finisher (2) in its finish; the
# window is [10, 20]
DISPATCH = [
    rec("cns.run", 9, 21, id_=1),
    rec("cns.dispatch", 11, 15, id_=2, parent=1, key=7),
    rec("cns.queue", 11.5, 15, id_=3, parent=2),
    rec("copy.h2d", 11.5, 12, id_=4, parent=3, bytes=1000, pageable=1000),
    rec("cns.launch", 12, 12.5, id_=5, parent=3),
    rec("copy.h2d", 12.1, 12.2, id_=6, parent=5, bytes=1, pageable=0),
    rec("cns.wait_device", 13, 14, id_=7, parent=3),
    rec("cns.gate", 15.5, 16, id_=8, parent=1),
    rec("cns.finish", 15, 19, tid=2, id_=9, key=7),
    rec("copy.d2h", 15, 16, tid=2, id_=10, parent=9, bytes=50),
    rec("cns.wait_finisher", 16, 18, id_=11, parent=1),
]


def run_of(events=(), w0=10.0, w1=20.0, k2=None, units=1):
    tasks = {"K1": [], "K2": k2 or []}
    return SimpleNamespace(w0=w0, w1=w1, window_s=w1 - w0, events=list(events),
                           units=units, cell=SimpleNamespace(tasks=tasks))


@pytest.fixture
def records(monkeypatch):
    got = []
    monkeypatch.setattr(progspans, "program_records", lambda: got)
    return got


def test_clipped_to_the_window():
    spans = progspans.window(run_of(), DISPATCH + [rec("x", 1, 2, id_=99)])
    by = {s.name: s for s in spans}
    assert "x" not in by
    assert (by["cns.run"].a, by["cns.run"].b) == (10, 20)
    assert by["cns.dispatch"].key == 7
    w = progspans.window(run_of(w0=12.05, w1=13.0), DISPATCH)
    assert {s.name for s in w} == {"cns.run", "cns.dispatch", "cns.queue",
                                   "cns.launch", "copy.h2d"}
    assert progspans.total_s(w, "copy.h2d") == pytest.approx(0.1)
    assert progspans.total_s(w, "cns.launch") == pytest.approx(0.45)


def test_self_time_over_children_and_over_kinds():
    spans = progspans.window(run_of(), DISPATCH)
    # children: the dispatch's one child (cns.queue) covers 3.5 of its 4 s
    assert progspans.self_s(spans, "cns.dispatch") == pytest.approx(0.5)
    # the copies, launches and waits below it (the nested copy inside a
    # launch counted once) cover 0.5 + 0.5 + 1.0
    assert progspans.self_s(spans, "cns.dispatch", (
        "copy.h2d", "cns.launch", "cns.wait_device")) == pytest.approx(2.0)
    assert progspans.covered_s(spans, "cns.dispatch",
                               ("copy.h2d",)) == pytest.approx(0.6)
    assert progspans.self_s(spans, "cns.finish") == pytest.approx(3.0)
    assert progspans.self_s(spans, "nothing") is None


def test_consensus_readers(records):
    records.extend(DISPATCH)
    k2 = [(np.array([100, 200]), np.array([150, 50]))]
    run = run_of(k2=k2)

    def read(name):
        return REG.reader(name)(run)

    assert read("cns.prep_share") == pytest.approx(0.2)
    assert read("cns.h2d_share") == pytest.approx(0.06)
    assert read("cns.device_wait_share") == pytest.approx(0.1)
    assert read("cns.finisher_wait_share") == pytest.approx(0.2)
    assert read("cns.h2d_bytes_per_base") == pytest.approx(1001 / 500)
    assert read("cns.h2d_pageable_share") == pytest.approx(1000 / 1001)
    # prep + copies + waits + the launch less its copy = the dispatch
    launch = 0.5 - 0.1
    assert read("cns.prep_share") + read("cns.h2d_share") + \
        read("cns.device_wait_share") + launch / 10 == pytest.approx(0.4)


def test_a_wait_that_never_came_reads_zero_and_no_layer_nothing(records):
    records.extend(s for s in DISPATCH if s.name != "cns.wait_device")
    assert REG.reader("cns.device_wait_share")(run_of()) == 0.0
    del records[:]
    for name in ("cns.prep_share", "cns.h2d_share", "cns.device_wait_share",
                 "cns.h2d_bytes_per_base", "cns.h2d_pageable_share",
                 "overlap.chain_wait_share", "pipeline.store_s",
                 "overlap.table_s", "pipeline.group_build_share",
                 "untraced_idle_share.consensus"):
        assert REG.reader(name)(run_of([("k", 10, 11, "kernel")])) is None


def test_a_tree_without_the_recorder_reads_nothing(monkeypatch):
    import builtins
    real = builtins.__import__

    def no_trace(name, *args, **kw):
        if name.startswith("falcon_tpu_torch.utils") and args and \
                "trace" in (args[2] or ()):
            raise ImportError(name)
        return real(name, *args, **kw)

    monkeypatch.setattr(builtins, "__import__", no_trace)
    assert progspans.program_records() == []
    assert REG.reader("cns.prep_share")(run_of()) is None


def test_pipeline_readers(records):
    records.extend([
        rec("pipeline.phase0", 10, 20, id_=1),
        rec("pipeline.store", 10, 12, id_=2, parent=1, reads=5, bases=99),
        rec("overlap.wait_chain", 12, 13, id_=3, parent=1, key=1),
        rec("overlap.align", 13, 16, id_=4, parent=1, key=1),
        rec("overlap.chain", 12, 15, tid=2, id_=5, key=1),
        rec("overlap.table", 16, 16.5, id_=6, parent=1, rows=3),
        rec("overlap.table", 17, 17.5, id_=7, parent=1, rows=3),
        rec("pipeline.make_group", 18, 18.25, id_=8, parent=1),
    ])
    run = run_of(units=2)
    assert REG.reader("overlap.chain_wait_share")(run) == pytest.approx(0.1)
    assert REG.reader("pipeline.store_s")(run) == pytest.approx(1.0)
    assert REG.reader("overlap.table_s")(run) == pytest.approx(0.5)
    assert REG.reader("pipeline.group_build_share")(run) == \
        pytest.approx(0.025)


def test_untraced_idle_leaves_out_the_wrappers(records):
    """Device busy [10, 11] and [14, 15]: idle 8 s of the 10.  Spans cover
    [11, 12] on one thread and [11.5, 13] on another; the phase span over
    the whole window names nothing."""
    records.extend([rec("pipeline.phase0", 9, 21, id_=1),
                    rec("pipeline.store", 11, 12, id_=2, parent=1),
                    rec("overlap.chain", 11.5, 13, tid=2, id_=3),
                    rec("overlap.table", 19.5, 25, id_=4, parent=1)])
    ev = [("k1", 10, 11, "kernel"), ("cp", 14, 15, "gpu_memcpy")]
    run = run_of(ev)
    # named: [11, 13] and [19.5, 20]; unnamed: [13, 14] and [15, 19.5]
    for kind in ("consensus", "overlap", "assembly"):
        got = REG.reader("untraced_idle_share." + kind)(run)
        assert got == pytest.approx(0.55)
    assert progspans.untraced_idle_s(run, progspans.window(run), ()) == \
        pytest.approx(0.0)
    assert REG.reader("untraced_idle_share.overlap")(run_of()) is None


def test_every_new_metric_has_its_reader_and_cells():
    names = [m["name"] for m in REG.spec["per_layer"]]
    for name in ("cns.prep_share", "cns.h2d_share", "cns.device_wait_share",
                 "cns.finisher_wait_share", "cns.h2d_bytes_per_base",
                 "cns.h2d_pageable_share", "overlap.chain_wait_share",
                 "pipeline.store_s", "overlap.table_s",
                 "pipeline.group_build_share",
                 "untraced_idle_share.consensus",
                 "untraced_idle_share.overlap",
                 "untraced_idle_share.assembly"):
        assert name in names
        REG.reader(name)
