"""The whole slice on the CPU: the port's Pipeline against falcon_tpu's device
pipeline (XLA extension and consensus alignment), byte-equal on every
artifact from raw overlaps to GFA; plus the port's guarantees that it
imports no JAX and nothing of falcon_tpu, that its copies of falcon_tpu's
host modules have not drifted, and that it never falls back to the CPU on
its own."""
import json
import os
import re
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
    consensus-scan twins, in a fresh interpreter: no jax module and no
    falcon_tpu module comes in with them."""
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
        ref = sorted(m for m in sys.modules
                     if m.split(".")[0] in ("falcon_tpu", "jaxlib"))
        assert not ref, ref
        print("ok", len(new))
    """)
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.startswith("ok")


def _port_sources():
    out = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, files in os.walk(os.path.join(REPO, "falcon_tpu_torch")):
        out += [os.path.join(root, f) for f in files if f.endswith(".py")]
    return out


def test_port_sources_import_no_falcon_tpu():
    """No source of the port, and not chip_smoke.py, names falcon_tpu or
    jax in an import statement."""
    pat = re.compile(r"^\s*(from|import)\s+(falcon_tpu|jax|jaxlib)([\s.]|$)",
                     re.M)
    srcs = _port_sources()
    assert len(srcs) > 40
    bad = [os.path.relpath(p, REPO) for p in srcs
           if pat.search(open(p).read())]
    assert not bad, bad


# falcon_tpu host modules that the port keeps verbatim copies of (same
# relative path).  A copy may differ from its source in import lines and in
# the package's name, nowhere else: pipeline/supervise.py's child and
# pipeline/snakemake.py's rule run falcon_tpu_torch.pipeline.driver.  A PR
# that changes a copy on purpose takes the file off this list and says
# why.  Not here, because they are ports or merges and not copies:
# ops/native.py (builds into the port's own _build/), overlap/engine.py
# (the port's make_device_aligner), cns/device.py, pipeline/driver.py,
# parallel/distributed.py.
COPIES = """utils/system.py utils/pool.py utils/sim.py config.py io/__init__.py
io/fasta.py io/readstore.py io/masking.py io/integrity.py io/ser.py
native/falcon_native.cpp ops/kmer.py ops/align.py ops/consensus_dp.py
overlap/table.py overlap/records.py overlap/filter.py overlap/stats.py
cns/runner.py graph/sg.py graph/unitigs.py graph/to_contig.py
graph/to_utgs.py graph/tiling.py graph/asm_graph.py graph/gfa.py
graph/collect_gfa.py pipeline/stats.py mains/__init__.py
mains/actg_coordinate.py mains/calc_cutoff.py mains/collect_contig_gfa.py
mains/collect_pread_gfa.py mains/consensus.py mains/contig_annotate.py
mains/ctg_link_analysis.py mains/dedup_a_tigs.py mains/fetch_reads.py
mains/gen_gfa_v1.py mains/gen_gfa_v2.py mains/gen_snakemake.py
mains/graph_to_contig.py mains/graph_to_utgs.py mains/hgap_adapt.py
mains/ovlp_filter.py mains/ovlp_stats.py mains/ovlp_to_graph.py
mains/report_pre_assembly.py mains/run.py mains/tasks.py
mains/track_reads.py tracking.py compat/__init__.py compat/functional.py
pipeline/snakemake.py pipeline/supervise.py""".split()


def _normalised(path):
    """The file's lines without import lines, the package's name folded;
    of the C++ source without its leading comment block too, which names
    where the reference C lay when falcon_tpu was written and is worded
    otherwise in the copy."""
    text = open(path).read().replace("falcon_tpu_torch", "falcon_tpu")
    lines = text.split("\n")
    if path.endswith(".cpp"):
        first = next(k for k, ln in enumerate(lines)
                     if ln and not ln.startswith("//"))
        lines = lines[first:]
    return [ln for ln in lines if not re.match(r"\s*(from|import)\s", ln)]


@pytest.mark.parametrize("rel", COPIES)
def test_copy_matches_its_source(rel):
    src = os.path.join(REPO, "falcon_tpu", rel)
    copy = os.path.join(REPO, "falcon_tpu_torch", rel)
    assert _normalised(copy) == _normalised(src), \
        "%s drifted from falcon_tpu/%s" % (rel, rel)


def test_every_module_has_a_counterpart():
    """Every .py of falcon_tpu has one at the same relative path in the
    port, but the JAX-only ones, whose counterparts the port names
    otherwise: the Pallas kernels (ops/align_cuda.py, ops/align_tb_cuda.py
    and csrc/) and the JAX setup (utils/device.py)."""
    def modules(pkg):
        root = os.path.join(REPO, pkg)
        return {os.path.relpath(os.path.join(d, f), root)
                for d, _, files in os.walk(root) for f in files
                if f.endswith(".py")}
    missing = modules("falcon_tpu") - modules("falcon_tpu_torch")
    assert missing == {"ops/align_pallas.py", "ops/align_tb_pallas.py",
                       "utils/jaxinit.py"}


def test_copied_halves_match_their_source():
    """The host functions copied into modules the port otherwise wrote
    itself: each is found, text-equal, in its falcon_tpu source."""
    import inspect
    from falcon_tpu.cns import device as jdev
    from falcon_tpu.overlap import engine as jeng
    from falcon_tpu.parallel import distributed as jdist
    from falcon_tpu.pipeline import driver as jdrv
    from falcon_tpu_torch.cns import device as tdev
    from falcon_tpu_torch.overlap import engine as teng
    from falcon_tpu_torch.parallel import distributed as tdist
    from falcon_tpu_torch.pipeline import driver as tdrv

    def same(a, b):
        return inspect.getsource(a).replace("falcon_tpu_torch",
                                            "falcon_tpu") == \
            inspect.getsource(b)

    for name in ("seq_to_codes", "seq_to_ascii", "gate_group_ranged",
                 "_clamp_range", "_range_ok"):
        assert same(getattr(tdev, name), getattr(jdev, name)), name
    for name in ("dispatch_chunk", "finish_chunk", "_msa", "_host_range"):
        assert same(getattr(tdev.DeviceCns, name),
                    getattr(jdev.DeviceCns, name)), name
    for name in ("OverlapParams", "AView", "BlockIndex", "chain_blocks",
                 "_dedup_extents", "align_candidates", "extend_one",
                 "emit_symmetric"):
        assert same(getattr(teng, name), getattr(jeng, name)), name
    for name in ("_engine_params", "_drop_pair_ckpts", "_make_group",
                 "phase1", "phase2"):
        assert same(getattr(tdrv.Pipeline, name),
                    getattr(jdrv.Pipeline, name)), name
    for name in ("_done", "_resumable", "setup_logging"):
        assert same(getattr(tdrv, name), getattr(jdrv, name)), name
    assert same(tdist.block_pair_plan, jdist.block_pair_plan)
    for n, h in ((1, 1), (4, 2), (7, 3)):
        got = [tdist.host_block_pairs(n, k, h) for k in range(h)]
        assert got == [jdist.host_block_pairs(n, k, h) for k in range(h)]
        assert sorted(sum(got, [])) == tdist.block_pair_plan(n)


def test_native_library_builds_in_the_ports_own_dir():
    """The port's host C++ library is built from the port's own source
    into falcon_tpu_torch/_build/, never into falcon_tpu's cache, and gives
    falcon_tpu's results."""
    from falcon_tpu.ops import native as jnative
    from falcon_tpu_torch.ops import native as tnative
    assert tnative.available()
    assert tnative.BUILD_DIR == os.path.join(REPO, "falcon_tpu_torch",
                                             "_build")
    so = os.path.join(tnative.BUILD_DIR, "libfalcon_native.so")
    assert os.path.exists(so)
    assert os.path.abspath(tnative._SRC) == os.path.join(
        REPO, "falcon_tpu_torch", "native", "falcon_native.cpp")
    assert tnative.get_lib()._name == so
    genome = sim.random_genome(3000, seed=3)
    reads = [s for _, s in sim.simulate_reads(genome, coverage=6,
                                              mean_len=1500, min_len=800,
                                              error=0.1, seed=4)][:2]
    a = tnative.align(reads[0], reads[0][5:] + "ACGT", 200, True)
    assert a.aln_str_size > 0
    if jnative.available():
        assert jnative.get_lib()._name != so
        b = jnative.align(reads[0], reads[0][5:] + "ACGT", 200, True)
        assert (a.dist, a.aln_q_e, a.aln_t_e, a.q_aln_str) == \
            (b.dist, b.aln_q_e, b.aln_t_e, b.q_aln_str)


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
