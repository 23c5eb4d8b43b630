"""Run the pipeline driver under automatic worker recycling.

The reference never leaks host memory across a long run because every
pypeflow task is a fresh process watched by pwatcher sentinels
(reference: falcon_kit/pype_tasks.py task dirs; pwatcher fs_based).
falcon_tpu's phases are in-process, and the remote-TPU client leaks host
RSS (~100-240MB/consensus chunk observed at 100Mb scale) and can wedge
in reconnect.  This supervisor restores the reference's process-hygiene
property around the checkpointed driver:

* the driver child cooperatively exits RECYCLE_EXIT when its RSS passes
  FTPU_RSS_LIMIT_GB at a durable checkpoint (utils.system.maybe_recycle)
  -- the supervisor restarts it and the phase resumes from the per-pair
  overlap checkpoints / mid-phase consensus marker;
* a hard RSS backstop (1.5x the limit) SIGKILLs a child that leaks
  between checkpoints;
* a stall detector SIGKILLs a child whose heartbeat (touched at every
  durable checkpoint) goes silent -- the observed wedge mode is the
  remote client spinning forever in reconnect while device_get never
  returns.

Only the exact child process group this supervisor spawned is ever
signalled.

Usage:
  python -m falcon_tpu_torch.pipeline.supervise cfg [out_dir]
         [--rss-limit-gb G] [--stall-min M] [--max-failures N]
"""
import argparse
import logging
import os
import signal
import subprocess
import sys
import time

from ..utils.system import RECYCLE_EXIT

LOG = logging.getLogger(__name__)


def _child_rss_gb(pid):
    try:
        with open("/proc/%d/statm" % pid) as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / float(1 << 30)
    except (OSError, ValueError, IndexError):
        return 0.0


def _kill_group(proc):
    """SIGKILL exactly the process group we started (never by pattern)."""
    try:
        os.killpg(proc.pid, signal.SIGKILL)
    except (ProcessLookupError, PermissionError):
        pass
    try:
        proc.wait(timeout=30)
    except subprocess.TimeoutExpired:
        pass


def supervise(cfg, out_dir=".", rss_limit_gb=32.0, stall_min=45.0,
              max_failures=10, poll_s=5.0, extra_env=None,
              driver_argv=None):
    """Restart-until-done loop around the driver.  Returns the final
    exit code (0 = pipeline completed)."""
    out_dir = os.path.abspath(out_dir)
    os.makedirs(out_dir, exist_ok=True)
    hb = os.path.join(out_dir, ".heartbeat")
    env = dict(os.environ)
    env["FTPU_RSS_LIMIT_GB"] = str(rss_limit_gb)
    env.setdefault("PYTHONUNBUFFERED", "1")
    # the child must be able to import falcon_tpu_torch even when the parent
    # got it via sys.path manipulation (bench_e2e) rather than an
    # install: prepend the package's parent dir to the child PYTHONPATH
    pkg_root = os.path.dirname(os.path.dirname(
        os.path.dirname(os.path.abspath(__file__))))
    env["PYTHONPATH"] = pkg_root + (
        os.pathsep + env["PYTHONPATH"] if env.get("PYTHONPATH") else "")
    if extra_env:
        env.update(extra_env)
    argv = driver_argv or [sys.executable, "-m",
                           "falcon_tpu_torch.pipeline.driver", cfg, out_dir]
    failures = 0
    recycles = 0
    attempt = 0
    while True:
        attempt += 1
        start = time.time()
        LOG.info("supervise: attempt %d (recycles %d, failures %d): %s",
                 attempt, recycles, failures, " ".join(argv))
        proc = subprocess.Popen(argv, env=env, start_new_session=True)
        reason = None
        while True:
            rc = proc.poll()
            if rc is not None:
                break
            time.sleep(poll_s)
            rss = _child_rss_gb(proc.pid)
            # hard backstop for leaks BETWEEN checkpoints; the +4GB floor
            # leaves room for a working set above a small cooperative
            # limit (the child self-recycles at rss_limit_gb on its own)
            if rss >= 1.5 * rss_limit_gb + 4.0:
                reason = "rss backstop (%.1fGB >= hard limit)" % rss
            else:
                try:
                    last = os.path.getmtime(hb)
                except OSError:
                    last = start
                silent = time.time() - max(last, start)
                if silent > stall_min * 60:
                    reason = "stalled (%.0f min without a heartbeat)" % (
                        silent / 60)
            if reason:
                LOG.warning("supervise: killing child %d: %s",
                            proc.pid, reason)
                _kill_group(proc)
                rc = proc.poll()
                break
        if rc == 0:
            LOG.info("supervise: pipeline completed (attempt %d, "
                     "%d recycles, %d failures)", attempt, recycles,
                     failures)
            return 0
        if rc == RECYCLE_EXIT:
            recycles += 1
            LOG.info("supervise: child recycled cleanly; restarting")
            continue
        failures += 1
        LOG.warning("supervise: child exited rc=%s (%s); failure %d/%d",
                    rc, reason or "crash", failures, max_failures)
        if failures >= max_failures:
            LOG.error("supervise: too many failures; giving up")
            return 1
        time.sleep(min(10.0 * failures, 60.0))


def main(argv=None):
    p = argparse.ArgumentParser(
        description="run the falcon_tpu_torch pipeline with automatic worker "
                    "recycling")
    p.add_argument("cfg")
    p.add_argument("out_dir", nargs="?", default=".")
    p.add_argument("--rss-limit-gb", type=float, default=32.0)
    p.add_argument("--stall-min", type=float, default=45.0)
    p.add_argument("--max-failures", type=int, default=10)
    args = p.parse_args(argv)
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    return supervise(args.cfg, args.out_dir,
                     rss_limit_gb=args.rss_limit_gb,
                     stall_min=args.stall_min,
                     max_failures=args.max_failures)


if __name__ == "__main__":
    sys.exit(main())
