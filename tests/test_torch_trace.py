"""The port's span recorder (falcon_tpu_torch/utils/trace.py) on the CPU:
nothing is recorded while no profiler window is open and no recording()
block runs; inside one, every span of the port's hot path appears, nested
per thread, consensus chunks keyed across the main and finisher threads;
the copy helpers count what they copy; FTPU_PROFILE's trace.json carries
the spans on the trace's own base."""
import io
import json
import os
import threading
from collections import Counter

import numpy as np
import pytest
import torch

from falcon_tpu_torch.cns import device as tdev
from falcon_tpu_torch.cns.runner import ConsensusConfig
from falcon_tpu_torch.io import fasta
from falcon_tpu_torch.pipeline.driver import Pipeline
from falcon_tpu_torch.utils import sim, trace

# every span the port records; cns.wait_device (the DP path's in-flight
# bound waits on a CUDA event) exists on a card only
PIPELINE_SPANS = {"pipeline.phase0", "pipeline.phase1", "pipeline.phase2",
                  "pipeline.store", "pipeline.make_group", "pipeline.stats",
                  "overlap.chain", "overlap.wait_chain", "overlap.align",
                  "overlap.checkpoint", "overlap.table", "extender.run",
                  "extender.wait"}
CNS_SPANS = {"cns.run", "cns.gate", "cns.dispatch", "cns.queue",
             "cns.launch", "cns.wait_finisher", "cns.finish", "cns.collect",
             "cns.rebuild", "cns.write", "copy.h2d", "copy.d2h"}

CFG = """[General]
input_fofn = input.fofn
input_type = raw
genome_size = %d
seed_coverage = 6
length_cutoff = -1
length_cutoff_pr = 1000
pa_DBsplit_option = -x500 -s0.01
ovlp_DBsplit_option = -x500 -s0.01
pa_HPCdaligner_option = -v -e.70 -l500
ovlp_HPCdaligner_option = -v -e.96 -l500
falcon_sense_option = --output-multi --min-idt 0.70 --min-cov 2 --max-n-read 1800
overlap_filtering_setting = --max-diff 100 --max-cov 100 --min-cov 1
"""


def _toy_run(d, G=2000):
    """A 2 kb genome's reads in 10 kb blocks (several block pairs), its
    fc_run.cfg; returns the cfg's path."""
    os.makedirs(d, exist_ok=True)
    genome = sim.random_genome(G, seed=21)
    reads = sim.simulate_reads(genome, coverage=8, mean_len=1000,
                               min_len=700, error=0.04, seed=22)
    fasta.write_fasta(os.path.join(d, "raw_reads.fa"), reads, width=80)
    with open(os.path.join(d, "input.fofn"), "w") as f:
        f.write(os.path.join(d, "raw_reads.fa") + "\n")
    cfg = os.path.join(d, "fc_run.cfg")
    with open(cfg, "w") as f:
        f.write((CFG % G).replace("input.fofn",
                                  os.path.join(d, "input.fofn")))
    return cfg


@pytest.fixture(scope="module")
def pipeline_runs(tmp_path_factory):
    """One toy Pipeline.run (host-MSA consensus) with nothing recording,
    then one inside recording(): (spans recorded by the first, by the
    second)."""
    d = str(tmp_path_factory.mktemp("trace_toy"))
    cfg = _toy_run(os.path.join(d, "in"))
    mp = pytest.MonkeyPatch()
    mp.setenv("FTPU_CNS_DP", "0")
    mp.delenv("FTPU_PROFILE", raising=False)
    try:
        since = trace.mark()
        Pipeline(cfg, os.path.join(d, "off"), device="cpu").run()
        off = trace.records(since)
        with trace.recording() as on:
            Pipeline(cfg, os.path.join(d, "on"), device="cpu").run()
    finally:
        mp.undo()
    assert os.path.exists(os.path.join(d, "on", "2-asm-falcon", "p_ctg.fa"))
    return off, on


def _noisy(truth, rng, err=0.06):
    """truth (codes) with err/3 each of deletions, insertions and
    substitutions."""
    out = []
    for c, r in zip(truth.tolist(), rng.random(len(truth))):
        if r < err / 3:
            continue
        if r < 2 * err / 3:
            out.append(int(rng.integers(0, 4)))
        elif r < err:
            c = (c + int(rng.integers(1, 4))) % 4
        out.append(c)
    return np.asarray(out, np.uint8)


def _groups(n_groups=4, seed_len=700, n_sup=5):
    """Seed groups for run_consensus_device (codes, as the driver gives
    them): noisy copies of each seed, every support with its range."""
    rng = np.random.default_rng(3)
    out = []
    for g in range(n_groups):
        truth = rng.integers(0, 4, seed_len).astype(np.uint8)
        sid = "%09d" % (10 * g)
        items = [(sid, truth, None)]
        for k in range(n_sup):
            sup = _noisy(truth, rng)
            items.append(("%09d" % (10 * g + k + 1), sup,
                          (0, len(sup), 0, seed_len)))
        out.append((sid, items))
    return out


CNS_CFG = ConsensusConfig(min_cov=2, min_idt=0.70, min_n_read=2,
                          min_cov_aln=2)


@pytest.fixture(scope="module")
def dp_consensus():
    """run_consensus_device on the DP path, a chunk of two groups at a
    time, with nothing recording and then inside recording()."""
    def run():
        out = io.StringIO()
        dev = tdev.DeviceCns(device="cpu", use_dp=True, chunk_tasks=10)
        n = tdev.run_consensus_device(iter(_groups()), CNS_CFG, out, dev=dev)
        return n, out.getvalue()

    since = trace.mark()
    plain = run()
    off = trace.records(since)
    with trace.recording() as on:
        recorded = run()
    assert plain == recorded and plain[0] == 4
    return off, on


def test_nothing_is_recorded_without_a_profiler(pipeline_runs, dp_consensus):
    assert not torch.autograd._profiler_enabled()
    assert pipeline_runs[0] == []
    assert dp_consensus[0] == []
    assert trace.span("x") is trace.NOOP
    with trace.span("x", clock=True) as sp:
        pass
    assert sp.seconds >= 0


def test_every_span_appears(pipeline_runs, dp_consensus):
    names = {s.name for s in pipeline_runs[1]}
    assert PIPELINE_SPANS | CNS_SPANS <= names, \
        (PIPELINE_SPANS | CNS_SPANS) - names
    dp = Counter(s.name for s in dp_consensus[1])
    assert CNS_SPANS <= set(dp), CNS_SPANS - set(dp)
    assert dp["cns.dispatch"] == dp["cns.finish"] == 2


@pytest.mark.parametrize("which", ["pipeline", "dp_consensus"])
def test_spans_nest_per_thread(request, which):
    """Each parent is open on the span's own thread and holds it; no
    duration is negative; the prefetch and finisher threads record too."""
    spans = request.getfixturevalue(
        "pipeline_runs" if which == "pipeline" else "dp_consensus")[1]
    by_id = {s.id: s for s in spans}
    assert len(by_id) == len(spans)
    for s in spans:
        assert s.t1 >= s.t0
        if s.parent:
            p = by_id[s.parent]
            assert p.tid == s.tid
            assert p.t0 <= s.t0 and s.t1 <= p.t1
    threads = {s.name: s.tid for s in spans}
    assert threads["cns.finish"] != threads["cns.dispatch"]
    if which == "pipeline":
        assert threads["overlap.chain"] != threads["overlap.align"]
        parents = {}
        for s in spans:
            parents.setdefault(s.name, set()).add(
                by_id[s.parent].name if s.parent else None)
        assert parents["cns.dispatch"] == {"cns.run"}
        assert parents["overlap.wait_chain"] == {"pipeline.phase0",
                                                 "pipeline.phase1"}
        assert parents["overlap.chain"] == {None}
        assert parents["cns.launch"] == {"cns.queue"}


@pytest.mark.parametrize("which", ["pipeline", "dp_consensus"])
def test_a_key_joins_its_spans_across_threads(request, which):
    spans = request.getfixturevalue(
        "pipeline_runs" if which == "pipeline" else "dp_consensus")[1]

    def keyed(name):
        return {s.key: s for s in spans if s.name == name}

    pairs = [("cns.dispatch", "cns.finish")]
    if which == "pipeline":
        pairs.append(("overlap.chain", "overlap.align"))
    for first, then in pairs:
        a, b = keyed(first), keyed(then)
        assert a and set(a) == set(b) and None not in a
        for k in a:
            assert a[k].tid != b[k].tid
            assert a[k].t0 <= b[k].t0
    chunks = keyed("cns.dispatch")
    assert sum(s.counts["groups"] for s in chunks.values()) == \
        sum(s.counts["groups"] for s in keyed("cns.finish").values())


def test_copy_counts_match_the_arrays(dp_consensus):
    """Every copy.h2d under a DP dispatch counts bytes, all of them
    pageable on the CPU; the counts are the arrays' own."""
    a = np.arange(1000, dtype=np.int32)
    t = torch.arange(77, dtype=torch.int16)
    with trace.recording() as got:
        x = trace.to_device(a, "cpu")
        y = trace.to_device(t, "cpu", torch.int32)
        z = trace.to_host(y)
    assert [s.name for s in got] == ["copy.h2d", "copy.h2d", "copy.d2h"]
    assert got[0].counts == {"bytes": a.nbytes, "pageable": a.nbytes}
    assert got[1].counts == {"bytes": t.nbytes, "pageable": t.nbytes}
    assert got[2].counts == {"bytes": y.nbytes}
    assert x.dtype == torch.int32 and torch.equal(x, torch.from_numpy(a))
    assert y.dtype == torch.int32 and z.tolist() == list(range(77))
    spans = dp_consensus[1]
    h2d = [s for s in spans if s.name == "copy.h2d"]
    assert h2d and all(s.counts["bytes"] == s.counts["pageable"] > 0
                       for s in h2d)


def test_carry_records_on_another_thread():
    """A profiler window is open on its own thread only: work handed to
    another thread records there through carry(), and not without it."""
    from concurrent.futures import ThreadPoolExecutor

    def work():
        with trace.span("t.work"):
            return threading.get_native_id()

    since = trace.mark()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]):
        with trace.span("t.main"):
            with ThreadPoolExecutor(1) as ex:
                ex.submit(work).result()
                tid = ex.submit(trace.carry(work)).result()
    names = [(s.name, s.tid) for s in trace.records(since)]
    assert names == [("t.work", tid), ("t.main", threading.get_native_id())]
    assert trace.carry(work) is work


def test_ftpu_profile_trace_carries_the_spans(tmp_path, monkeypatch):
    """FTPU_PROFILE on a CPU toy run (phase 0 cut down to a consensus of
    two groups): trace.json holds the recorder's spans as "ftt" events on
    the trace's own base, over the profiler's own events."""
    cfg = _toy_run(str(tmp_path / "in"))
    prof = tmp_path / "prof"
    monkeypatch.setenv("FTPU_PROFILE", str(prof))

    def phase0(self):
        dev = tdev.DeviceCns(device="cpu", use_dp=False, chunk_tasks=5)
        tdev.run_consensus_device(iter(_groups(2, 300, 3)), CNS_CFG,
                                  io.StringIO(), dev=dev)

    monkeypatch.setattr(Pipeline, "phase0", phase0)
    since = trace.mark()
    Pipeline(cfg, str(tmp_path / "out"), device="cpu").run()
    spans = trace.records(since)
    with open(prof / "trace.json") as f:
        d = json.load(f)
    ftt = [e for e in d["traceEvents"] if e.get("cat") == "ftt"]
    assert {e["name"] for e in ftt} == {s.name for s in spans} >= {
        "pipeline.phase0", "cns.dispatch", "cns.finish", "copy.h2d"}
    assert len(ftt) == len(spans)
    base = int(d["baseTimeNanoseconds"])
    for e, s in zip(ftt, spans):
        assert e["ph"] == "X" and e["pid"] == os.getpid()
        assert (e["name"], e["tid"]) == (s.name, s.tid)
        assert abs(base + e["ts"] * 1e3 - s.t0) < 1e3
        assert abs(e["dur"] * 1e3 - (s.t1 - s.t0)) < 1e3
        assert e["args"].get("key") == s.key
    ops = [e for e in d["traceEvents"]
           if e.get("ph") == "X" and e.get("cat") == "cpu_op"]
    outer = next(e for e in ftt if e["name"] == "pipeline.phase0")
    assert ops and any(outer["ts"] <= e["ts"] <= outer["ts"] + outer["dur"]
                       for e in ops)
    timings = json.load(open(tmp_path / "out" / "timings.json"))
    assert "device_busy_s" in timings
