"""The device trace of a run's window, and what is read from it.

The window runs under torch.profiler with CUDA activity only; its chrome
trace is read back for the device's intervals (kernels, copies, sets).
`union_s` is a copy of falcon_tpu_torch/pipeline/driver.py's device_busy
arithmetic (the union of the intervals, so overlapping streams count
once), here clipped to the window.

Times are seconds on the host's wall clock (time.time()): a trace event's
start is its `ts` (microseconds) plus the trace's baseTimeNanoseconds.
"""
import json
import os

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def load_events(trace_fn):
    """[(name, start_s, end_s, cat)] of the device events of a chrome
    trace, on the host's wall clock."""
    with open(trace_fn) as f:
        d = json.load(f)
    base = float(d.get("baseTimeNanoseconds", 0)) / 1e9
    out = []
    for e in d.get("traceEvents", []):
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            t0 = base + float(e["ts"]) / 1e6
            out.append((e["name"], t0, t0 + float(e["dur"]) / 1e6, e["cat"]))
    return out


def clip(events, w0, w1):
    """The events' parts inside [w0, w1]."""
    return [(n, max(a, w0), min(b, w1), c) for n, a, b, c in events
            if b > w0 and a < w1]


def busy_intervals(events):
    """The union of the events' intervals, as sorted disjoint (a, b)."""
    out = []
    for _, a, b, _ in sorted(events, key=lambda e: e[1]):
        if out and a <= out[-1][1]:
            out[-1] = (out[-1][0], max(out[-1][1], b))
        else:
            out.append((a, b))
    return out


def union_s(events):
    return sum(b - a for a, b in busy_intervals(events))


def idle_gaps(events, w0, w1):
    """The idle intervals of [w0, w1] between the busy ones."""
    gaps = []
    t = w0
    for a, b in busy_intervals(events):
        if a > t:
            gaps.append((t, a))
        t = max(t, b)
    if w1 > t:
        gaps.append((t, w1))
    return gaps


def kernel_s(events, match):
    """Summed device seconds of the kernels whose name contains one of
    the substrings in `match`."""
    return sum(b - a for n, a, b, c in events
               if c == "kernel" and any(m in n for m in match))


def top_ops(events, n=10):
    """[[name, seconds]] of the n device operations (by name) that took
    most time."""
    by = {}
    for name, a, b, _ in events:
        by[name] = by.get(name, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


def gaps_by_span(gaps, spans, n=10):
    """[[what the host was in, idle seconds]] of the n largest totals: each
    idle gap is cut at the benchmark's span edges and each piece named by
    the spans open over it ("+"-joined, "host" when none)."""
    edges = sorted({t for _, a, b in spans for t in (a, b)})
    by = {}
    for g0, g1 in gaps:
        cuts = [g0] + [t for t in edges if g0 < t < g1] + [g1]
        for a, b in zip(cuts, cuts[1:]):
            mid = 0.5 * (a + b)
            names = sorted({s for s, s0, s1 in spans if s0 <= mid < s1})
            key = "+".join(names) or "host"
            by[key] = by.get(key, 0.0) + (b - a)
    return [[k, v] for k, v in sorted(by.items(), key=lambda kv: -kv[1])[:n]]


class DeviceTrace:
    """torch.profiler around the window; read() exports the chrome trace
    to `trace_fn`, loads the device events, and deletes the file."""

    def __init__(self, trace_fn):
        self.trace_fn = trace_fn
        self.prof = None

    def __enter__(self):
        import torch
        self.prof = torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA])
        self.prof.__enter__()
        return self

    def __exit__(self, *exc):
        self.prof.__exit__(*exc)
        return False

    def read(self):
        self.prof.export_chrome_trace(self.trace_fn)
        try:
            return load_events(self.trace_fn)
        finally:
            os.unlink(self.trace_fn)
