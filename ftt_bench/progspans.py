"""What the readers of the program's own spans share.

falcon_tpu_torch records spans while a torch.profiler window is open
(falcon_tpu_torch/utils/trace.py), so a traced run's window gets them with
no hook of the benchmark's.  The readers take them clipped to the window,
on the clock the device trace is mapped onto (time.time()), and return
None where the program recorded nothing: a tree without the recorder, or
a cell whose path has no such layer.

A span's self time over some kinds of its descendants is its duration
less the part of it those descendants cover (the choosing-metrics guide's
self time, over the named kinds: cns.dispatch less its copies, launches
and device waits is the main thread's host prep).
"""
from collections import namedtuple

from . import devtrace

Sp = namedtuple("Sp", "name key a b tid id parent counts")

# spans that only wrap others: device idle under them and under no finer
# span has no name yet
WRAPPERS = ("pipeline.phase0", "pipeline.phase1", "cns.run")


def program_records():
    """The recorder's spans so far; [] where the program has none."""
    try:
        from falcon_tpu_torch.utils import trace
    except ImportError:
        return []
    return trace.records()


def window(run, records=None):
    """[Sp] of the spans that overlap the window, clipped to it, times in
    seconds."""
    records = program_records() if records is None else records
    out = []
    for s in records:
        a, b = s.t0 / 1e9, s.t1 / 1e9
        if b > run.w0 and a < run.w1:
            out.append(Sp(s.name, s.key, max(a, run.w0), min(b, run.w1),
                          s.tid, s.id, s.parent, s.counts))
    return out


def union_s(intervals):
    """Seconds covered by the union of (a, b) intervals."""
    total, end = 0.0, float("-inf")
    for a, b in sorted(intervals):
        if b > end:
            total += b - max(a, end)
            end = b
    return total


def _children(spans):
    kids = {}
    for s in spans:
        kids.setdefault(s.parent, []).append(s)
    return kids


def _below(s, kids, names):
    """The descendants of s whose name is in names."""
    out, todo = [], list(kids.get(s.id, ()))
    while todo:
        c = todo.pop()
        if c.name in names:
            out.append(c)
        todo.extend(kids.get(c.id, ()))
    return out


def total_s(spans, name):
    """Summed seconds of the spans of that name; None if there are
    none."""
    got = [s.b - s.a for s in spans if s.name == name]
    return sum(got) if got else None


def covered_s(spans, name, names):
    """Summed over the spans of `name`: the seconds its descendants of
    the kinds in `names` cover.  None if there is no span of `name`."""
    kids = _children(spans)
    tops = [s for s in spans if s.name == name]
    if not tops:
        return None
    return sum(union_s([(c.a, c.b) for c in _below(s, kids, names)])
               for s in tops)


def self_s(spans, name, names=None):
    """Summed over the spans of `name`: its duration less what its
    descendants of the kinds in `names` cover (its children, where names
    is None).  None if there is no span of `name`."""
    kids = _children(spans)
    tops = [s for s in spans if s.name == name]
    if not tops:
        return None
    out = 0.0
    for s in tops:
        under = kids.get(s.id, ()) if names is None else \
            _below(s, kids, names)
        out += (s.b - s.a) - union_s([(c.a, c.b) for c in under])
    return out


def count_below(spans, name, kind, key):
    """Summed over the spans of `name`: the count `key` of its
    descendants of kind `kind`.  None if there is no span of `name`."""
    kids = _children(spans)
    tops = [s for s in spans if s.name == name]
    if not tops:
        return None
    return sum(c.counts.get(key, 0) for s in tops
               for c in _below(s, kids, (kind,)))


def share(run, seconds):
    """seconds over the window; None stays None."""
    if seconds is None or run.window_s <= 0:
        return None
    return seconds / run.window_s


def layer_share(run, layer, name):
    """The spans of `name` over the window, 0 where the layer's span
    `layer` was recorded and `name` was not (a wait that never came)."""
    spans = window(run)
    if total_s(spans, layer) is None:
        return None
    return share(run, total_s(spans, name) or 0.0)


def untraced_idle_s(run, spans, none=WRAPPERS):
    """Seconds of the device's idle gaps in the window that no span (of
    any thread, those in `none` left out) covers.  None without device
    events or spans."""
    if not run.events or not spans:
        return None
    cover = devtrace.busy_intervals([(s.name, s.a, s.b, None) for s in spans
                                     if s.name not in none])
    out, k = 0.0, 0
    for g0, g1 in devtrace.idle_gaps(run.events, run.w0, run.w1):
        out += g1 - g0
        while k < len(cover) and cover[k][1] <= g0:
            k += 1
        j = k
        while j < len(cover) and cover[j][0] < g1:
            out -= min(cover[j][1], g1) - max(cover[j][0], g0)
            j += 1
    return out


def untraced_idle_share(run):
    return share(run, untraced_idle_s(run, window(run)))
