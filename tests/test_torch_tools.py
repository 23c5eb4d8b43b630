"""The port's tools (falcon_tpu_torch.tools) on the CPU: check_assembly's
JSON against falcon_tpu's tools/check_assembly.py on the same inputs,
verify_quick on the host path and on the plain twins, profile_cns_dp's
staged rebuild against the production DP path (supports without a range
included), profile_extender's chain against the plain twin,
bench_accumulate's counts, and every tool refusing to run without a GPU
unless it is asked for the CPU."""
import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from falcon_tpu.utils import sim
from falcon_tpu_torch.cns.device import _clamp_range, _range_ok
from falcon_tpu_torch.tools import (bench_accumulate, check_assembly,
                                    profile_cns_dp, profile_extender,
                                    verify_quick)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_RC = bytes.maketrans(b"ACGT", b"TGCA")


def _run(cmd, tmp_path):
    # two threads: the plain twins' ops are small, and a process that
    # takes every core's thread beside other test workers thrashes
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""), OMP_NUM_THREADS="2")
    out = subprocess.run(cmd, cwd=tmp_path, env=env, capture_output=True,
                         text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return out.stdout


def _assembly(tmp_path, ext):
    """A 40 kb simulated genome (as genome.txt or genome.fa) and a p_ctg.fa
    of four slices of it: one clean, one with a few substitutions, one
    with an insertion and a deletion, one reverse-complemented."""
    genome = sim.random_genome(40000, seed=9)
    rng = np.random.RandomState(3)
    ctgs = [genome[1000:13000]]
    s = bytearray(genome[12000:25000].encode())
    for i in rng.randint(0, len(s), 6):
        s[i] = b"ACGT"[(b"ACGT".index(s[i]) + 1) % 4]
    ctgs.append(s.decode())
    s = genome[24000:33000]
    ctgs.append(s[:3000] + "GATTACA" + s[3000:6000] + s[6040:])
    ctgs.append(genome[32000:39500].encode()[::-1].translate(_RC).decode())
    p_ctg = tmp_path / "p_ctg.fa"
    p_ctg.write_text("".join(">%06dF ctg_linear\n%s\n" % (k, c)
                             for k, c in enumerate(ctgs)))
    g = tmp_path / ("genome." + ext)
    g.write_text(">truth\n%s\n" % genome if ext == "fa" else genome)
    return str(p_ctg), str(g)


@pytest.mark.parametrize("ext", ["txt", "fa"])
def test_check_assembly_json_matches_falcon_tpu(tmp_path, ext):
    """Both tools as their users run them, on the same p_ctg.fa and genome:
    the same JSON, key for key."""
    p_ctg, genome = _assembly(tmp_path, ext)
    ref = _run([sys.executable, os.path.join(REPO, "tools",
                                             "check_assembly.py"),
                p_ctg, genome], tmp_path)
    got = _run([sys.executable, "-m", "falcon_tpu_torch.tools.check_assembly",
                p_ctg, genome, "--device", "cpu"], tmp_path)
    ref, got = json.loads(ref), json.loads(got)
    assert got == ref
    assert got["n_contigs"] == 4 and got["sampled_windows"] >= 8
    assert 0.99 < got["mean_identity"] < 1


@pytest.mark.parametrize("argv", [
    pytest.param(["--device", "host"], id="host"),
    # the plain twins step through every anti-diagonal of a batch in
    # Python: the reference's 100 kb of 7 kb reads takes minutes on them,
    # 10 kb (of 2 kb reads) about half a minute
    pytest.param(["--device", "cpu", "--genome-size", "10000"], id="cpu"),
])
def test_verify_quick_reaches_verify_ok(tmp_path, argv):
    out = _run([sys.executable, "-m", "falcon_tpu_torch.tools.verify_quick"]
               + argv, tmp_path).splitlines()
    assert out[-1] == "VERIFY OK"
    res = json.loads(out[-2])
    assert res["identity"] > 0.99
    assert res["contig"] > 0.9 * res["genome_size"]
    assert res["device"] == argv[1]
    assert res["launches"] == {}        # no kernel runs on the CPU


def _ranged_tasks(groups, cfg):
    """The alignment tasks the reference tool built: those of supports
    that carry a range (it skipped the rest)."""
    n = 0
    for _, seed_seq, sups in profile_cns_dp.gate(groups, cfg):
        for sup, rng, is_self in sups:
            if is_self or rng is None:
                continue
            rng = _clamp_range(rng, len(sup), len(seed_seq))
            n += _range_ok(rng)
    return n


def test_profile_cns_dp_matches_production():
    """The staged rebuild against dispatch_chunk_dp + finish_chunk_dp on a
    chunk of 1.5-2 kb groups where a third of the supports carry no range:
    the same consensus, the same tasks, and more tasks than the reference
    tool's skip of those supports would give."""
    groups, cfg = profile_cns_dp.build_groups(
        30000, 8, 0.08, 11, group_len=(1500, 2000), unranged=0.3)
    res = profile_cns_dp.profile(groups, cfg, torch.device("cpu"), repeat=1)
    assert res["parity"] is True
    assert res["tasks"] == res["production_tasks"] > 0
    assert res["tasks_from_host_ranges"] > 0
    assert res["tasks"] > _ranged_tasks(groups, cfg)
    assert set(res["stages_s"]) == {
        "hostprep", "h2d", "alloc", "selftags", "align", "acc", "scan",
        "walk", "fetch", "hostasm"}
    # seeds + lengths a DP batch; the packed codes, their [4, B] block
    # and K4's [2, B] block a K2 batch
    assert res["h2d_copies"] == 2 * res["dp_batches"] + \
        3 * res["stage_calls"]["align"]
    assert res["sum_stage_s"] == pytest.approx(sum(res["stages_s"].values()))


def test_profile_cns_dp_groups_keep_their_sequences():
    """The unranged fraction changes which supports carry a range, never
    the sequences (bench_consensus.build_groups's groups at 0)."""
    a, _ = profile_cns_dp.build_groups(20000, 5, 0.08, 11)
    b, _ = profile_cns_dp.build_groups(20000, 5, 0.08, 11, unranged=0.5)
    assert [[s for _, s, _ in it] for _, it in a] == \
        [[s for _, s, _ in it] for _, it in b]
    assert all(r is not None for _, it in a for _, _, r in it[1:])
    assert any(r is None for _, it in b for _, _, r in it[1:])


def test_profile_extender_chain_matches_twin():
    res = profile_extender.run(profile_extender.parse_args(
        ["16", "256", "--W", "64", "--device", "cpu"]))
    assert res["bit_equal"] is True
    assert set(res["launches"]) == {"gather", "kernel", "chain"}


def test_bench_accumulate_counts_agree():
    """The twin (K4's wrapper on the CPU) and index_add_ of the decoded
    tags give the same counts."""
    res = bench_accumulate.run(bench_accumulate.parse_args(
        ["--device", "cpu", "--B", "8", "--L", "2048", "--T", "2048",
         "--G", "4", "--reps", "1"]))
    assert res["parity"] is True and res["index_add_parity"] is True
    assert 0 < res["kept_columns"] < res["updates_per_call"]


@pytest.mark.parametrize("tool,argv", [
    pytest.param(check_assembly, ["p_ctg.fa", "genome.txt"],
                 id="check_assembly"),
    pytest.param(verify_quick, [], id="verify_quick"),
    pytest.param(profile_extender, [], id="profile_extender"),
    pytest.param(profile_cns_dp, [], id="profile_cns_dp"),
    pytest.param(bench_accumulate, [], id="bench_accumulate")])
def test_tool_raises_without_a_card(monkeypatch, tool, argv):
    """No device named: cuda, whatever FTPU_TORCH_DEVICE says, and a
    machine without a GPU raises before any work."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present")
    monkeypatch.setenv("FTPU_TORCH_DEVICE", "cpu")
    with pytest.raises(RuntimeError, match="is_available"):
        tool.run(tool.parse_args(argv))
