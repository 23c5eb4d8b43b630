"""What the per-layer readers (metrics/<name>.py) share.  Each returns
None when the run holds nothing to read, and the harness then leaves the
metric out of the line."""
import numpy as np

from . import devtrace, roofline

# the kernels' names in the device trace (csrc/*.cu)
KERNELS = {"K1": ("ftt_extend",), "K2": ("ftt_tb_fwd",)}
WORK = {"K1": roofline.k1_work, "K2": roofline.k2_work}


def span_share(run, name):
    """The time in the benchmark's spans of that name over the window."""
    t = run.spans.total(name)
    return t / run.window_s if t > 0 and run.window_s > 0 else None


def idle_share(run):
    """1 - the union of the device's intervals over the window."""
    if not run.events:
        return None
    return 1.0 - devtrace.union_s(run.events) / run.window_s


def kernel_roofline(run, kernel):
    """The kernel's share of its roofline, in percent: the least time its
    tasks need (roofline.py) over its device time in the window."""
    parts = run.cell.tasks[kernel]
    t = devtrace.kernel_s(run.events, KERNELS[kernel])
    if not parts or not t:
        return None
    q = np.concatenate([p[0] for p in parts])
    s = np.concatenate([p[1] for p in parts])
    ops, nbytes = WORK[kernel](q, s, run.cell.config["bands"][kernel])
    return roofline.roofline_pct(ops, nbytes, t)


def timing_share(run, keys):
    """sum over the window's pipeline runs of the timings `keys` over
    their totals."""
    tm = run.cell.timings
    total = sum(t.get("total", 0.0) for t in tm)
    if not tm or total <= 0:
        return None
    return sum(t.get(k, 0.0) for t in tm for k in keys) / total
