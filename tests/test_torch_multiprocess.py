"""The port's multi-process runs on the CPU: two processes joined by
torch.distributed on gloo (falcon_tpu_torch.parallel.distributed), their
gathers and the driver's striped overlap phase, byte-equal to one process
of the port and of falcon_tpu (the counterpart of
tests/test_multiprocess.py).

The worker is this file run as a script (`python <this file> <mode> ...`
with the FTPU_* variables set); it imports the port alone and checks at
its end that no jax and no falcon_tpu module came in.  Every child is
killed when its time is up.  Modes:

  gather       allgather_lines / allgather_records / allgather_table
  overlap      Pipeline._overlap_store over the process's stripe
  pipeline-dp  Pipeline.run() on the CPU with the device consensus, which
               must default to the DP path under two processes
"""
import os
import socket
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def free_port():
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def launch(n_procs, args, timeout=240, extra_env=None):
    """Run n_procs workers of this file with the coordinator variables;
    every child is killed if it outlives the timeout.  Asserts they all
    exit 0."""
    port = free_port()
    procs = []
    for pid in range(n_procs):
        env = dict(os.environ)
        env["PYTHONPATH"] = REPO
        env["FTPU_TORCH_DEVICE"] = "cpu"
        env["FTPU_COORDINATOR_ADDRESS"] = "127.0.0.1:%d" % port
        env["FTPU_NUM_PROCESSES"] = str(n_procs)
        env["FTPU_PROCESS_ID"] = str(pid)
        env.pop("FTPU_CNS_DP", None)
        # each worker its share of the cores: torch's threads spin, and
        # workers that oversubscribe the host run several times slower
        env["OMP_NUM_THREADS"] = env.get("OMP_NUM_THREADS") or str(
            max(1, (os.cpu_count() or 2) // n_procs))
        if extra_env:
            env.update(extra_env)
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__)] + args, env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT))
    try:
        rc = [p.wait(timeout=timeout) for p in procs]
    finally:
        # an orphan waiting on its peer's collective would never end
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    logs = [p.stdout.read().decode() for p in procs]
    assert rc == [0] * n_procs, "\n".join(logs)
    return logs


def test_two_process_gathers(tmp_path):
    """The three gathers under two processes: both see the same
    concatenation in rank order, values >= 2^33 survive, and the table's
    rows arrive whole."""
    base = str(tmp_path / "g.txt")
    launch(2, ["gather", base], timeout=120)
    v0 = open(base + ".0").read()
    assert v0 == open(base + ".1").read()
    lines = eval(v0.split("\n")[0])
    assert lines[:3] == ["host0-line0", "host0-line1", "host0-line2"]
    assert lines[-1] == "host1-line3" and len(lines) == 7
    rows = eval(v0.split("\n")[1])
    assert len(rows) == 4 + 8
    assert rows[4][0] >= (1 << 33), "int64 values truncated in the gather"
    tbl = [ln for ln in v0.split("\n")[2:] if ln.strip()]
    assert len(tbl) == 5
    assert [ln.split()[:2] for ln in tbl] == [
        ["000000000", "000000000"], ["000000000", "000000001"],
        ["000000001", "000000000"], ["000000001", "000000001"],
        ["000000001", "000000002"]]


def test_single_process_identity(monkeypatch):
    """Without the coordinator variables: no group, rank 0 of 1, and the
    gathers return their input."""
    import numpy as np
    from falcon_tpu_torch.overlap import table as T
    from falcon_tpu_torch.parallel import distributed as dist
    monkeypatch.delenv("FTPU_COORDINATOR_ADDRESS", raising=False)
    assert not dist.want_distributed()
    assert dist.init_distributed() == (0, 1)
    assert dist.allgather_lines(["a b", "c"]) == ["a b", "c"]
    rows = np.arange(12).reshape(4, 3) + (1 << 40)
    np.testing.assert_array_equal(dist.allgather_records(rows, 3), rows)
    tbl = T.empty(3)
    assert dist.allgather_table(tbl) is tbl
    monkeypatch.setenv("FTPU_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.delenv("FTPU_NUM_PROCESSES", raising=False)
    assert dist.want_distributed()
    with pytest.raises(RuntimeError, match="FTPU_NUM_PROCESSES"):
        dist.init_distributed()


OVERLAP_G = 25_000


def _overlap_cfg(tmp_path):
    """The 25 kb genome of tests/test_multiprocess.py, host aligner."""
    from falcon_tpu.io import fasta
    from falcon_tpu.utils import sim
    genome = sim.random_genome(OVERLAP_G, seed=41)
    reads = sim.simulate_reads(genome, coverage=10, mean_len=4000,
                               min_len=1500, error=0.05, seed=42)
    fa = str(tmp_path / "raw.fa")
    fasta.write_fasta(fa, reads, width=80)
    cfg_fn = str(tmp_path / "fc.cfg")
    with open(cfg_fn, "w") as f:
        f.write("[General]\ninput_fofn = %s\ngenome_size = %d\n"
                "use_device = false\nmasking =\n" % (fa, OVERLAP_G))
    return cfg_fn, fa


def _single_overlap_table(pipeline_cls, cfg_fn, fa, out_dir, **kw):
    """One process's _overlap_store over the 40 kb blocks, as text."""
    import importlib
    pkg = pipeline_cls.__module__.split(".")[0]
    readstore = importlib.import_module(pkg + ".io.readstore")
    T = importlib.import_module(pkg + ".overlap.table")
    p = pipeline_cls(cfg_fn, out_dir, use_device=False, **kw)
    store = readstore.ReadStore.from_fasta_files([fa])
    store.split_blocks(40_000)
    assert len(store.blocks) >= 3
    tbl = p._overlap_store(store, p._engine_params(0), "sp")
    return "\n".join(T.to_lines(tbl)) + "\n"


def test_two_process_overlap_store_matches_single(tmp_path):
    """_overlap_store striped over two processes and gathered == the port's
    one process == falcon_tpu's one process, byte for byte."""
    from falcon_tpu.pipeline.driver import Pipeline as JaxPipeline
    from falcon_tpu_torch.pipeline.driver import Pipeline
    cfg_fn, fa = _overlap_cfg(tmp_path)
    want = _single_overlap_table(JaxPipeline, cfg_fn, fa,
                                 str(tmp_path / "jax"))
    assert want.count("\n") > 50
    assert _single_overlap_table(Pipeline, cfg_fn, fa,
                                 str(tmp_path / "one"), device="cpu") == want
    outs = [str(tmp_path / ("mp.ovl.%d" % i)) for i in range(2)]
    launch(2, ["overlap", cfg_fn, fa, str(tmp_path / "w"),
               str(tmp_path / "mp.ovl")], timeout=240)
    for fn in outs:
        assert open(fn).read() == want, fn


PIPELINE_ARTIFACTS = [
    "2-asm-falcon/p_ctg.fa", "2-asm-falcon/a_ctg.fa",
    "2-asm-falcon/sg_edges_list", "2-asm-falcon/ctg_paths",
    "2-asm-falcon/utg_data", "2-asm-falcon/asm.gfa", "2-asm-falcon/sg.gfa",
    "2-asm-falcon/contig.gfa2", "0-rawreads/preads.fasta",
    "1-preads_ovl/preads.ovl"]


@pytest.mark.slow
def test_two_process_full_pipeline_matches_single(tmp_path, monkeypatch):
    """Pipeline.run() under two processes on the CPU with the device
    consensus: every artifact byte-equal on both processes and to one
    process of the port with FTPU_CNS_DP=1; the workers leave FTPU_CNS_DP
    unset and assert that the DP path defaulted on.  The genome is a
    quarter of falcon_tpu's counterpart's (its reads in ~4 blocks of 50 kb,
    10 block pairs): the CPU twins of the DP consensus run a Python step a
    column, and each process runs the whole consensus."""
    from falcon_tpu.io import fasta
    from falcon_tpu.utils import sim
    from falcon_tpu_torch.pipeline.driver import Pipeline
    G = 12000
    genome = sim.random_genome(G, seed=61)
    reads = sim.simulate_reads(genome, coverage=16, mean_len=3500,
                               min_len=1500, error=0.04, seed=62)
    fa = str(tmp_path / "raw.fa")
    fasta.write_fasta(fa, reads, width=80)
    cfg_fn = str(tmp_path / "fc.cfg")
    with open(cfg_fn, "w") as f:
        f.write("""[General]
input_fofn = %s
input_type = raw
genome_size = %d
seed_coverage = 15
length_cutoff = -1
length_cutoff_pr = 1000
pa_DBsplit_option = -x500 -s0.05
ovlp_DBsplit_option = -x500 -s0.05
pa_HPCdaligner_option = -v -e.70 -l1000
ovlp_HPCdaligner_option = -v -e.96 -l500
falcon_sense_option = --output-multi --min-idt 0.70 --min-cov 2 --max-n-read 1800 --n-core 0
overlap_filtering_setting = --max-diff 100 --max-cov 100 --min-cov 1
""" % (fa, G))
    sdir = str(tmp_path / "single")
    monkeypatch.setenv("FTPU_CNS_DP", "1")
    Pipeline(cfg_fn, sdir, device="cpu").run()
    out_base = str(tmp_path / "mp")
    launch(2, ["pipeline-dp", cfg_fn, out_base], timeout=900)
    for rel in PIPELINE_ARTIFACTS:
        want = open(os.path.join(sdir, rel)).read()
        for pid in range(2):
            got = open(os.path.join(out_base + ".%d" % pid, rel)).read()
            assert got == want, "%s differs on process %d" % (rel, pid)
    assert open(os.path.join(sdir, PIPELINE_ARTIFACTS[0])).read().count(
        ">") >= 1


def worker(argv):
    """One process of a multi-process test; see the module docstring."""
    mode, args = argv[0], argv[1:]
    pid = os.environ["FTPU_PROCESS_ID"]
    from falcon_tpu_torch.parallel import distributed
    rank, n = distributed.init_distributed()
    assert (rank, n) == (int(pid), int(os.environ["FTPU_NUM_PROCESSES"]))
    if mode == "gather":
        import numpy as np
        from falcon_tpu_torch.overlap import table as T
        lines = ["host%s-line%d" % (pid, k) for k in range(3 + rank)]
        got_lines = distributed.allgather_lines(lines)
        rows = (np.arange(8 * (rank + 1), dtype=np.int64).reshape(-1, 2)
                + 1000 * rank + (1 << 33) * rank)
        got_rows = distributed.allgather_records(rows, 2)
        tbl = T.empty(2 + rank)
        tbl["a_id"] = rank
        tbl["b_id"] = np.arange(2 + rank)
        tbl["idt_cp"] = 9999
        got_tbl = distributed.allgather_table(tbl)
        with open(args[0] + "." + pid, "w") as f:
            f.write(repr(got_lines) + "\n")
            f.write(repr(got_rows.tolist()) + "\n")
            f.write("\n".join(T.to_lines(got_tbl)) + "\n")
    elif mode == "overlap":
        from falcon_tpu_torch.pipeline.driver import Pipeline
        cfg_fn, fa, out_dir, out_fn = args
        text = _single_overlap_table(Pipeline, cfg_fn, fa, out_dir + pid)
        with open(out_fn + "." + pid, "w") as f:
            f.write(text)
    elif mode == "pipeline-dp":
        from falcon_tpu_torch.cns.device import DeviceCns
        from falcon_tpu_torch.pipeline.driver import Pipeline
        assert "FTPU_CNS_DP" not in os.environ
        assert DeviceCns().use_dp, \
            "the DP path must default on under several processes"
        cfg_fn, out_base = args
        Pipeline(cfg_fn, out_base + "." + pid).run()
    else:
        raise SystemExit("unknown mode " + mode)
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "falcon_tpu"))
    assert not loaded, loaded
    import torch.distributed as tdist
    tdist.destroy_process_group()
    return 0


if __name__ == "__main__":
    sys.exit(worker(sys.argv[1:]))
