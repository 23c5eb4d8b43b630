"""The port's worker-recycling supervisor (falcon_tpu_torch.pipeline
.supervise, a copy of falcon_tpu's whose child is the port's driver):

* fast: a child that exits RECYCLE_EXIT once and then 0 is restarted once
  and the run ends 0; the default child is `python -m
  falcon_tpu_torch.pipeline.driver cfg out_dir` with the repository root
  first on its PYTHONPATH and the cooperative limit in FTPU_RSS_LIMIT_GB,
  and that module runs the driver;
* slow (tests/test_supervise.py's two runs, on the port's driver on the
  CPU): recycling at every durable checkpoint, and a SIGKILL mid-run, each
  supervised to an assembly byte-equal to an uninterrupted run."""
import os
import signal
import subprocess
import sys
import textwrap
import time

import pytest

from falcon_tpu_torch.pipeline import supervise
from falcon_tpu_torch.pipeline.driver import Pipeline
from falcon_tpu_torch.utils.system import RECYCLE_EXIT

from tests.test_supervise import _dataset

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_child_recycled_once_then_done(tmp_path):
    """A real child process that exits RECYCLE_EXIT on its first run and
    0 on its second: two attempts, exit 0, and the limit reaches it."""
    marker = tmp_path / "attempts"
    child = tmp_path / "child.py"
    child.write_text(textwrap.dedent("""
        import os, sys
        with open(sys.argv[1], "a") as f:
            f.write(os.environ["FTPU_RSS_LIMIT_GB"] + "\\n")
        n = len(open(sys.argv[1]).read().split())
        sys.exit(%d if n == 1 else 0)
    """ % RECYCLE_EXIT))
    rc = supervise.supervise(
        "unused.cfg", str(tmp_path / "out"), rss_limit_gb=0.25, poll_s=0.05,
        driver_argv=[sys.executable, str(child), str(marker)])
    assert rc == 0
    assert marker.read_text().split() == ["0.25", "0.25"]


def test_default_child_is_the_ports_driver(tmp_path, monkeypatch):
    """Without driver_argv the supervisor starts the port's driver on the
    cfg and the absolute out_dir, in a session of its own, with the
    repository root first on PYTHONPATH; a RECYCLE_EXIT restarts it."""
    started = []

    class Child:
        def __init__(self, argv, env, start_new_session):
            started.append((argv, env, start_new_session))
            self.pid = 0
            self.code = RECYCLE_EXIT if len(started) == 1 else 0

        def poll(self):
            return self.code

    monkeypatch.setattr(supervise.subprocess, "Popen", Child)
    monkeypatch.setenv("PYTHONPATH", "/elsewhere")
    out = tmp_path / "out"
    assert supervise.supervise("fc_run.cfg", str(out), rss_limit_gb=2.0,
                               poll_s=0.01) == 0
    assert len(started) == 2
    for argv, env, new_session in started:
        assert argv == [sys.executable, "-m",
                        "falcon_tpu_torch.pipeline.driver", "fc_run.cfg",
                        str(out)]
        assert env["PYTHONPATH"] == REPO + os.pathsep + "/elsewhere"
        assert env["FTPU_RSS_LIMIT_GB"] == "2.0" and new_session
    assert out.is_dir()


def test_driver_runs_as_a_module():
    """`python -m falcon_tpu_torch.pipeline.driver`, the supervisor's and
    the Snakefile's child, runs the driver's main: with no cfg it prints
    its usage and exits 2, as falcon_tpu's does (the module once ended
    without calling main, so that a supervised run exited 0 having done
    nothing)."""
    env = dict(os.environ, PYTHONPATH=REPO + os.pathsep +
               os.environ.get("PYTHONPATH", ""))
    out = subprocess.run([sys.executable, "-m",
                          "falcon_tpu_torch.pipeline.driver"], env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 2
    assert out.stderr.startswith("usage:")


class _Recycled(Exception):
    pass


def test_no_recycle_without_consensus_progress(tmp_path, monkeypatch):
    """A driver restarted after its consensus's last durable marker, with
    no group left, must not recycle at the host runner's final marker:
    under a limit below its RSS it would exit again at once, without end.
    Phase 0 is stopped where a recycle exits (after the final marker, all
    groups durable), then run again with recycling recorded: no
    'phase0 consensus' recycle, and preads.fasta byte-equal to an
    uninterrupted run's."""
    from falcon_tpu_torch.utils import system
    cfg = _dataset(str(tmp_path), G=20000)
    monkeypatch.chdir(tmp_path)
    Pipeline(cfg, str(tmp_path / "ref"), device="cpu").phase0()
    want = (tmp_path / "ref" / "0-rawreads" / "preads.fasta").read_bytes()
    out = tmp_path / "run"
    recycles = []

    def recycle(out_dir, where):
        recycles.append(where)
        if recycles.count("phase0 consensus") == 1 and \
                where == "phase0 consensus":
            raise _Recycled()
    monkeypatch.setattr(system, "maybe_recycle", recycle)
    with pytest.raises(_Recycled):
        Pipeline(cfg, str(out), device="cpu").phase0()
    d0 = out / "0-rawreads"
    assert (d0 / "preads.fasta.progress").exists()
    assert (d0 / "preads.fasta.tmp").read_bytes() == want
    Pipeline(cfg, str(out), device="cpu").phase0()
    assert recycles.count("phase0 consensus") == 1
    assert (d0 / "preads.fasta").read_bytes() == want


def _child_env():
    env = dict(os.environ)
    env["PYTHONPATH"] = REPO + os.pathsep + env.get("PYTHONPATH", "")
    env["FTPU_TORCH_DEVICE"] = "cpu"
    return env


def _reference_assembly(cfg, run_dir):
    p_ctg = Pipeline(cfg, run_dir, device="cpu").run()
    with open(p_ctg, "rb") as f:
        return f.read()


@pytest.mark.slow
def test_recycle_every_checkpoint_byte_identical(tmp_path):
    cfg = _dataset(str(tmp_path))
    want = _reference_assembly(cfg, str(tmp_path / "ref_run"))
    out = str(tmp_path / "sup_run")
    rc = supervise.supervise(cfg, out, rss_limit_gb=0.001, stall_min=10.0,
                             poll_s=0.3, extra_env=_child_env())
    assert rc == 0
    got = open(os.path.join(out, "2-asm-falcon", "p_ctg.fa"), "rb").read()
    assert got == want
    assert not os.path.exists(
        os.path.join(out, "0-rawreads", "phase0_pairs"))


@pytest.mark.slow
def test_sigkill_midrun_then_supervise_resumes(tmp_path):
    cfg = _dataset(str(tmp_path))
    want = _reference_assembly(cfg, str(tmp_path / "ref_run"))
    out = str(tmp_path / "kill_run")
    os.makedirs(out)
    hb = os.path.join(out, ".heartbeat")
    proc = subprocess.Popen(
        [sys.executable, "-m", "falcon_tpu_torch.pipeline.driver", cfg, out],
        env=_child_env(), start_new_session=True)
    try:
        deadline = time.time() + 300
        while not os.path.exists(hb) and time.time() < deadline:
            if proc.poll() is not None:
                break
            time.sleep(0.2)
        assert os.path.exists(hb), "driver produced no heartbeat"
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    rc = supervise.supervise(cfg, out, rss_limit_gb=64.0, stall_min=10.0,
                             poll_s=0.3, extra_env=_child_env())
    assert rc == 0
    got = open(os.path.join(out, "2-asm-falcon", "p_ctg.fa"), "rb").read()
    assert got == want
