"""What the tools share: the --device argument, the kernels' launch
counters, and timers that wait for the card."""
import collections
import contextlib
import time

import torch

from ..ops import align_cuda, align_tb_cuda, cns_dp_cuda
from ..utils import trace
from ..utils.device import resolve_device


def add_device_arg(p, extra=""):
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; raises "
                        "without a GPU); cpu runs the kernels' plain "
                        "twins" + extra)


def device_of(name):
    """resolve_device(name) and the card's name ("host" on the CPU)."""
    dev = resolve_device(name)
    card = torch.cuda.get_device_name(dev) if dev.type == "cuda" \
        else "host"
    return dev, card


def sync(dev):
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def launch_counts():
    """Every kernel wrapper's launch counter, by key: K1 (align_cuda),
    K2 + K3 (align_tb_cuda), K4-K6 (cns_dp_cuda)."""
    out = {}
    for counts in (align_cuda.LAUNCHES, align_tb_cuda.LAUNCHES,
                   cns_dp_cuda.LAUNCHES):
        out.update(counts)
    return out


def launches_since(before):
    """The counters that moved since `before` (launch_counts()), by how
    much."""
    now = launch_counts()
    return {k: now[k] - before[k] for k in now if now[k] != before[k]}


class Stages:
    """Seconds, calls and kernel launches of named stages.  Each stage
    ends with a synchronize of the device, so its time is its own."""

    def __init__(self, dev):
        self.dev = dev
        self.seconds = collections.Counter()
        self.calls = collections.Counter()
        self.launches = collections.defaultdict(collections.Counter)
        self.h2d_copies = 0

    @contextlib.contextmanager
    def __call__(self, name):
        before = launch_counts()
        t0 = time.perf_counter()
        yield
        sync(self.dev)
        self.seconds[name] += time.perf_counter() - t0
        self.calls[name] += 1
        self.launches[name].update(launches_since(before))

    def h2d(self, *arrays):
        """Each host array (numpy or tensor) on the device, one copy each
        (trace.to_device), in the stage "h2d"."""
        with self("h2d"):
            out = [trace.to_device(a, self.dev) for a in arrays]
        self.h2d_copies += len(arrays)
        return out


def best_seconds(fn, dev, iters=3, pipe=1, setup=lambda: None):
    """Least seconds per call of fn(setup()) over `iters` runs of `pipe`
    calls queued back to back, after one warm-up call; setup() runs before
    the clock starts (a fresh buffer for a call that works in place).
    CUDA events on a GPU, the host clock on the CPU.  Returns (seconds,
    output of the warm-up call)."""
    out = fn(setup())
    best = float("inf")
    for _ in range(iters):
        args = [setup() for _ in range(pipe)]
        sync(dev)
        if dev.type == "cuda":
            with torch.cuda.device(dev):
                start, end = (torch.cuda.Event(enable_timing=True)
                              for _ in range(2))
                start.record()
                for a in args:
                    fn(a)
                end.record()
                end.synchronize()
            s = start.elapsed_time(end) / 1e3
        else:
            t0 = time.perf_counter()
            for a in args:
                fn(a)
            s = time.perf_counter() - t0
        best = min(best, s / pipe)
    return best, out
