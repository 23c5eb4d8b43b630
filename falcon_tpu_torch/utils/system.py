"""Host/system utilities: dirs, symlinks, resource logging.

Parity surface for the reference's falcon_kit/util/system.py:14-42
(make_dirs / symlinking with relative-path fixup) and util/io.py:32-35
(maxrss logging at task milestones).  Lustre striping
(util/system.py:45-54) has no analog here -- there is no shared-FS data
plane -- and is intentionally omitted.
"""
import contextlib
import logging
import os
import time

LOG = logging.getLogger(__name__)


def make_dirs(d):
    """mkdir -p (reference: util/system.py make_dirs)."""
    if d and not os.path.isdir(d):
        os.makedirs(d, exist_ok=True)


@contextlib.contextmanager
def cd(newdir):
    """chdir context manager (reference: util/system.py cd)."""
    prevdir = os.getcwd()
    LOG.debug("CD: %r <- %r", newdir, prevdir)
    os.chdir(os.path.expanduser(newdir))
    try:
        yield
    finally:
        LOG.debug("CD: %r -> %r", newdir, prevdir)
        os.chdir(prevdir)


def symlink(actual, symbolic=None, force=True):
    """Symlink `actual` at `symbolic` (basename default), relative when
    they share a tree (reference: util/system.py:14-42 symlink)."""
    symbolic = symbolic or os.path.basename(actual)
    if os.path.abspath(actual) == os.path.abspath(symbolic):
        LOG.warning("Cannot symlink %r as %r, itself.", actual, symbolic)
        return
    rel = os.path.relpath(actual, os.path.dirname(symbolic) or ".")
    if force and (os.path.lexists(symbolic)):
        os.unlink(symbolic)
    os.symlink(rel, symbolic)


def maxrss_mb():
    """Peak RSS of this process in MB (0.0 if resource is unavailable)."""
    try:
        import resource
    except ImportError:  # non-posix
        return 0.0
    rss = resource.getrusage(resource.RUSAGE_SELF).ru_maxrss
    # ru_maxrss is KB on Linux but bytes on macOS
    import sys
    if sys.platform == "darwin":
        return rss / (1024.0 * 1024.0)
    return rss / 1024.0


def log_resources(label):
    """Log peak RSS at a phase milestone (reference: util/io.py:32-35
    system_resources logging called at ovlp_filter stage boundaries)."""
    LOG.info("[%s] maxrss: %.1f MB", label, maxrss_mb())


# -- worker recycling ------------------------------------------------------
# The remote-TPU client leaks host RSS (~100-240MB per consensus chunk,
# round-4 100Mb run) and once wedged at ~75GB.  The reference never hits
# this because every pypeflow task is a fresh process (pype_tasks.py task
# dirs).  falcon_tpu_torch gets the same hygiene from cooperative recycling:
# long phases call maybe_recycle() right after a durable checkpoint; when
# RSS exceeds FTPU_RSS_LIMIT_GB the process exits with RECYCLE_EXIT and
# the supervisor (pipeline.supervise) restarts it, resuming from the
# checkpoint.  os._exit is deliberate: all state that matters is already
# on disk, and atexit/finally paths must NOT run (they would finalize
# half-done phase outputs).

RECYCLE_EXIT = 17


def rss_gb():
    """Current (not peak) RSS of this process in GB; 0.0 off-Linux."""
    try:
        with open("/proc/self/statm") as f:
            pages = int(f.read().split()[1])
        return pages * os.sysconf("SC_PAGE_SIZE") / float(1 << 30)
    except (OSError, ValueError, IndexError):
        return 0.0


def rss_limit_gb():
    """FTPU_RSS_LIMIT_GB as float, or None when recycling is disabled."""
    v = os.environ.get("FTPU_RSS_LIMIT_GB", "")
    try:
        return float(v) if v else None
    except ValueError:
        return None


# liveness-tick registration: long device phases (a single 400MB block
# pair's align stage runs minutes with no durable checkpoint) tick the
# heartbeat from inside their batch loops so the supervisor's stall
# detector measures CLIENT liveness, not checkpoint cadence.  The driver
# registers its out_dir once; compute modules call heartbeat_tick()
# without knowing about the pipeline.
_HB = {"dir": None, "t": 0.0}


def set_heartbeat_dir(out_dir):
    _HB["dir"] = out_dir
    _HB["t"] = 0.0


def heartbeat_tick(min_interval_s=5.0):
    """Rate-limited heartbeat touch; no-op outside a supervised run."""
    d = _HB["dir"]
    if d is None:
        return
    now = time.time()
    if now - _HB["t"] < min_interval_s:
        return
    _HB["t"] = now
    touch_heartbeat(d)


def touch_heartbeat(out_dir):
    """Progress heartbeat for the supervisor's stall detector: touched at
    every durable checkpoint (overlap pair saved, consensus chunk
    marked).  A child that stops beating is assumed wedged (the observed
    failure mode: remote client spins in reconnect forever)."""
    try:
        with open(os.path.join(out_dir, ".heartbeat"), "w") as f:
            f.write(str(os.getpid()))
    except OSError:
        pass


def maybe_recycle(out_dir, where):
    """Exit RECYCLE_EXIT if RSS is over FTPU_RSS_LIMIT_GB.  Call ONLY
    immediately after a durable checkpoint; safe from any thread."""
    limit = rss_limit_gb()
    if limit is None:
        return
    cur = rss_gb()
    if cur >= limit:
        import sys
        LOG.warning("%s: rss %.1fGB >= limit %.1fGB; recycling "
                    "(exit %d; supervisor resumes from checkpoint)",
                    where, cur, limit, RECYCLE_EXIT)
        for h in logging.getLogger().handlers:
            try:
                h.flush()
            except Exception:
                pass
        sys.stderr.flush()
        os._exit(RECYCLE_EXIT)
