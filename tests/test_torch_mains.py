"""The port's command-line tools (falcon_tpu_torch.mains, copies of
falcon_tpu's) against falcon_tpu's, in process on the CPU: every tool's
--help, the consensus stream CLI byte-equal, the Snakefile export naming
the port's driver, make-fofn-abs, and an adopted run tree resumed by the
port's driver (tests/test_mains.py's cases)."""
import contextlib
import importlib
import io
import os
import shutil

import numpy as np
import pytest

from falcon_tpu.mains import consensus as jconsensus
from falcon_tpu.utils import sim
from falcon_tpu_torch.mains import consensus, gen_snakemake, hgap_adapt
from falcon_tpu_torch.mains import tasks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = sorted(f[:-3] for f in os.listdir(os.path.join(REPO, "falcon_tpu",
                                                       "mains"))
               if f.endswith(".py") and not f.startswith("__"))


def _help(pkg, tool):
    """How pkg's tool ends when asked for --help, in process: (how, value)
    and its standard output with the package's name folded and
    whitespace collapsed (argparse re-flows a description whose words
    grew).  mains.run's main takes argv without the program's name."""
    mod = importlib.import_module("%s.mains.%s" % (pkg, tool))
    argv = ["--help"] if tool == "run" else ["prog", "--help"]
    buf = io.StringIO()
    try:
        with contextlib.redirect_stdout(buf):
            end = ("return", mod.main(argv))
    except SystemExit as e:
        end = ("exit", e.code)
    except OSError as e:          # the tools that take positional paths
        end = ("raise", type(e).__name__, str(e))
    text = buf.getvalue().replace("falcon_tpu_torch", "falcon_tpu")
    return end, " ".join(text.split())


def test_every_tool_is_ported():
    assert TOOLS == sorted(
        f[:-3] for f in os.listdir(os.path.join(REPO, "falcon_tpu_torch",
                                                "mains"))
        if f.endswith(".py") and not f.startswith("__"))
    assert len(TOOLS) == 22


@pytest.mark.parametrize("tool", TOOLS)
def test_help_matches_falcon_tpu(tool, tmp_path, monkeypatch):
    """Each port tool ends on --help as falcon_tpu's does and prints the
    same text: the argparse tools exit 0 with their usage; falcon-task
    returns 2 after its usage; actg_coordinate, contig_annotate,
    ctg_link_analysis and run take --help for a path and fail to open
    it, in both packages."""
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("FTPU_TORCH_DEVICE", "cpu")   # run's Pipeline
    got, ref = _help("falcon_tpu_torch", tool), _help("falcon_tpu", tool)
    assert got == ref
    if got[0][0] == "exit":
        assert got[0][1] == 0 and got[1].startswith("usage:")
    assert not os.listdir(tmp_path)


def _stream(seed):
    """A stream-mode group on stdin (tests/test_mains.py's): a seed read
    and 11 supports, noisy copies of one template."""
    rng = np.random.RandomState(seed)
    genome = sim.random_genome(3000, seed=1)
    tmpl = np.frombuffer(genome.encode(), np.uint8)[200:2800]
    lines = []
    for i in range(12):
        read = sim.mutate(tmpl, rng, 0.01, 0.01, 0.01).tobytes().decode()
        lines.append("%09d %s" % (i, read))
    return "\n".join(lines + ["+ +", "- -"]) + "\n"


@pytest.mark.parametrize("trim", [False, True])
def test_consensus_stream_matches_falcon_tpu(monkeypatch, capsys, trim):
    """fc_consensus in stream mode, byte-equal to falcon_tpu's on the same
    group, with and without --trim."""
    argv = ["prog", "--min-cov", "2", "--min-cov-aln", "2", "--min-n-read",
            "5", "--output-multi"] + (["--trim", "--trim-size", "50"]
                                      if trim else [])
    text = _stream(0)
    outs = []
    for mod in (consensus, jconsensus):
        monkeypatch.setattr("sys.stdin", io.StringIO(text))
        assert mod.main(list(argv)) == 0
        outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1]
    assert outs[0].startswith(">prolog/0000000000/")
    assert len("".join(outs[0].splitlines()[1:])) > 2000


def test_gen_snakemake_runs_the_ports_driver(tmp_path):
    cfg = tmp_path / "fc_run.cfg"
    cfg.write_text("[General]\ninput_fofn = input.fofn\n"
                   "genome_size = 5000\n")
    out = tmp_path / "Snakefile"
    assert gen_snakemake.main(["prog", str(cfg), "-o", str(out),
                               "--run-dir", "runA"]) == 0
    text = out.read_text()
    assert "python -m falcon_tpu_torch.pipeline.driver %s runA" % cfg \
        in text
    for frag in ("rule phase0_preads:", "rule phase1_overlaps:",
                 "rule phase2_assembly:", "runA/2-asm-falcon/p_ctg.fa"):
        assert frag in text, frag


def test_make_fofn_abs(tmp_path):
    sub = tmp_path / "data"
    sub.mkdir()
    fofn = sub / "in.fofn"
    fofn.write_text("a.fa\n/abs/b.fa\n\n")
    out = tmp_path / "out.fofn"
    assert tasks.main(["prog", "make-fofn-abs", str(fofn), str(out)]) == 0
    assert out.read_text().splitlines() == [str(sub / "a.fa"), "/abs/b.fa"]
    with pytest.raises(ValueError):
        tasks.make_fofn_abs(str(fofn), str(fofn))
    assert tasks.main(["prog"]) == 2


def test_hgap_adapt_resumes_through_the_ports_driver(tmp_path):
    """A reference run tree (consensus shards and their FOFN, db2falcon,
    preads.ovl) adopted by the port's hgap_adapt; the port's Pipeline on
    the CPU then skips phases 0 and 1, and its contigs equal a direct
    stage-2 run on the same artifacts (tests/test_mains.py's
    test_hgap_adapt_reference_layout_resume)."""
    from falcon_tpu_torch.graph import to_contig, unitigs
    from falcon_tpu_torch.io import fasta
    from falcon_tpu_torch.pipeline.driver import Pipeline
    from tests.test_stage2_parity import make_preads_ovl

    src = tmp_path / "src"
    src.mkdir()
    ovl_fn = make_preads_ovl(str(src), G=30000, coverage=10, seed=9)
    preads = list(fasta.read_fasta(str(src / "preads4falcon.fasta")))
    job = tmp_path / "ext_run"
    half = len(preads) // 2
    shards = []
    for k, part in ((1, preads[:half]), (2, preads[half:])):
        d = job / "0-rawreads" / "cns-runs" / ("cns_%05d" % k) / "uow-00"
        d.mkdir(parents=True)
        shards.append(d / ("cns_%05d.fasta" % k))
        fasta.write_fasta(str(shards[-1]),
                          [(r.name, r.sequence) for r in part])
    pd = job / "0-rawreads" / "preads"
    pd.mkdir()
    (pd / "input_preads.fofn").write_text(
        "".join(os.path.relpath(s, pd) + "\n" for s in shards))
    (job / "0-rawreads" / "length_cutoff").write_text("2000\n")
    d2f = job / "1-preads_ovl" / "db2falcon"
    d2f.mkdir(parents=True)
    shutil.copy(str(src / "preads4falcon.fasta"), str(d2f))
    (job / "2-asm-falcon").mkdir()
    shutil.copy(ovl_fn, str(job / "2-asm-falcon" / "preads.ovl"))

    run = tmp_path / "run"
    assert hgap_adapt.main(["prog", "--job-output", str(job),
                            "--out", str(run)]) == 0
    got = list(fasta.read_fasta(str(run / "0-rawreads" / "preads.fasta")))
    assert [r.name for r in got] == [r.name for r in preads]
    (run / "raw_reads.fa").write_text(">dummy\nACGT\n")
    (run / "input.fofn").write_text("raw_reads.fa\n")
    (run / "fc_run.cfg").write_text(
        "[General]\ninput_fofn = input.fofn\ninput_type = raw\n"
        "genome_size = 30000\nseed_coverage = 10\n"
        "length_cutoff = -1\nlength_cutoff_pr = 500\n")
    cwd = os.getcwd()
    os.chdir(str(run))
    try:
        p_ctg = Pipeline("fc_run.cfg", str(run), device="cpu").run()
    finally:
        os.chdir(cwd)
    ctgs = {r.name: r.sequence for r in fasta.read_fasta(p_ctg)}
    assert ctgs
    direct = tmp_path / "direct"
    direct.mkdir()
    shutil.copy(ovl_fn, str(direct / "preads.ovl"))
    shutil.copy(str(src / "preads4falcon.fasta"), str(direct))
    unitigs.ovlp_to_graph(str(direct / "preads.ovl"), str(direct),
                          min_len=500, min_idt=96.0, lfc=False)
    to_contig.run(str(direct))
    assert ctgs == {r.name: r.sequence
                    for r in fasta.read_fasta(str(direct / "p_ctg.fa"))}
