"""The whole slice on the CPU: the port's Pipeline against falcon_tpu's device
pipeline (XLA extension and consensus alignment), byte-equal on every
artifact from raw overlaps to GFA; plus the port's guarantees that it
imports no JAX and never falls back to the CPU on its own."""
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from falcon_tpu.io import fasta
from falcon_tpu.pipeline.driver import Pipeline as JaxPipeline
from falcon_tpu.utils import sim
from falcon_tpu_torch.pipeline.driver import Pipeline, device_busy
from falcon_tpu_torch.utils.device import resolve_device

from tests.test_pipeline_e2e import write_cfg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

ARTIFACTS = ["0-rawreads/raw_overlaps.ovl", "0-rawreads/preads.fasta",
             "1-preads_ovl/preads.ovl", "2-asm-falcon/p_ctg.fa",
             "2-asm-falcon/a_ctg.fa", "2-asm-falcon/asm.gfa",
             "2-asm-falcon/sg.gfa", "2-asm-falcon/contig.gfa2"]


def _write_run(G, coverage, mean_len):
    """Reads, input.fofn and fc_run.cfg in the current directory."""
    genome = sim.random_genome(G, seed=21)
    reads = sim.simulate_reads(genome, coverage=coverage, mean_len=mean_len,
                               min_len=1500, error=0.04, seed=22)
    fasta.write_fasta("raw_reads.fa", reads, width=80)
    with open("input.fofn", "w") as f:
        f.write("raw_reads.fa\n")
    write_cfg("fc_run.cfg", G)


@pytest.mark.parametrize("G,coverage,mean_len,dp", [
    pytest.param(10_000, 16, 3500, False, id="10000-16-3500"),
    pytest.param(10_000, 16, 3500, True, id="10000-16-3500-dp"),
    pytest.param(40_000, 18, 6000, False, marks=pytest.mark.slow,
                 id="40000-18-6000"),
])
def test_pipeline_matches_jax(tmp_path, monkeypatch, G, coverage, mean_len,
                              dp):
    """dp: FTPU_CNS_DP=1 for both packages, so phase-0 consensus runs the
    device-DP path in each."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("FTPU_USE_PALLAS", "0")     # JAX on the CPU: XLA
    monkeypatch.setenv("FTPU_CNS_DP", "1" if dp else "0")
    _write_run(G, coverage, mean_len)
    JaxPipeline("fc_run.cfg", str(tmp_path / "jax"), use_device=True).run()
    port = Pipeline("fc_run.cfg", str(tmp_path / "torch"), device="cpu")
    port.run()
    assert 0 < port.timings["phase0_occupancy"] < 1
    assert ("phase0_cns_dp_batches" in port.timings) == dp
    for name in ARTIFACTS:
        ref = (tmp_path / "jax" / name).read_bytes()
        got = (tmp_path / "torch" / name).read_bytes()
        assert got == ref, name
    assert (tmp_path / "torch" / "2-asm-falcon" / "p_ctg.fa").stat().st_size


def test_port_imports_no_jax():
    """Every falcon_tpu_torch module, and tiny runs of the extension and
    consensus-scan twins, in a fresh interpreter: no jax module comes in
    with them."""
    code = textwrap.dedent("""
        import importlib, pkgutil, sys
        before = set(sys.modules)
        import torch
        import falcon_tpu_torch
        for m in pkgutil.walk_packages(falcon_tpu_torch.__path__,
                                       "falcon_tpu_torch."):
            if not m.name.endswith("__main__"):
                importlib.import_module(m.name)
        from falcon_tpu_torch.ops.align_device import extend_batch
        from falcon_tpu_torch.ops import cns_dp
        q = torch.zeros((2, 64), dtype=torch.int8)
        n = torch.full((2,), 64, dtype=torch.int32)
        assert extend_batch(q, n, q, n, W=32).tolist() == [[64] * 2,
                                                          [64] * 2, [0] * 2]
        msa = cns_dp.add_self_tags(cns_dp.alloc_msa(1, 8, 3, "cpu"),
                                   q[:1, :8], n[:1], 8)
        bp, cov, gb_s, gb_t, gb_d, gb_b = cns_dp.consensus_scan(msa, 1, 8, 3)
        assert (gb_s.tolist(), gb_t.tolist()) == ([4.0], [7])
        new = set(sys.modules) - before
        jax = sorted(m for m in new if m == "jax" or m.startswith("jax."))
        assert not jax, jax
        print("ok", len(new))
    """)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def test_resolve_device(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("FTPU_TORCH_DEVICE", raising=False)
    with pytest.raises(RuntimeError, match="is_available"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError):
        resolve_device()                        # the default is "cuda"
    with pytest.raises(ValueError):
        resolve_device("meta")
    assert resolve_device("cpu") == torch.device("cpu")
    monkeypatch.setenv("FTPU_TORCH_DEVICE", "cpu")
    assert resolve_device() == torch.device("cpu")


def test_pipeline_default_device_needs_a_gpu(tmp_path, monkeypatch):
    """Without a GPU the port's Pipeline refuses to start rather than run
    its device path on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.delenv("FTPU_TORCH_DEVICE", raising=False)
    monkeypatch.chdir(tmp_path)
    write_cfg("fc_run.cfg", 10_000)
    with pytest.raises(RuntimeError, match="is_available"):
        Pipeline("fc_run.cfg", str(tmp_path / "out"))
    assert not (tmp_path / "out").exists()


def test_device_busy_counts_overlaps_once(tmp_path):
    """Busy time is the union of the device intervals of the trace; host
    ops and annotations are not device time."""
    ev = [dict(ph="X", cat="kernel", name="ftt_extend_kernel", ts=0, dur=10),
          dict(ph="X", cat="kernel", name="ftt_extend_kernel", ts=5, dur=10),
          dict(ph="X", cat="gpu_memcpy", name="Memcpy DtoH", ts=12, dur=1),
          dict(ph="X", cat="kernel", name="ftt_tb_fwd_kernel", ts=30,
               dur=4),
          dict(ph="X", cat="cpu_op", name="aten::copy_", ts=0, dur=100),
          dict(ph="X", cat="gpu_user_annotation", name="x", ts=40, dur=9),
          dict(ph="i", cat="kernel", name="marker", ts=50)]
    fn = tmp_path / "trace.json"
    fn.write_text(json.dumps({"traceEvents": ev}))
    busy, by_name = device_busy(str(fn))
    assert busy == pytest.approx(19e-6, abs=1e-12)
    assert list(by_name) == ["ftt_extend_kernel", "ftt_tb_fwd_kernel",
                             "Memcpy DtoH"]
    assert by_name["ftt_extend_kernel"] == [2, pytest.approx(20e-6)]
