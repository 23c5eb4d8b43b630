"""Spans and copy counts of the port, on the host's wall clock.

A span is one named interval of one thread: its start and end in
nanoseconds of time.time_ns() (the clock a torch.profiler chrome trace is
based on: an event starts at baseTimeNanoseconds + ts), the thread's native
id, its parent (the span open on that thread when it opened), a `key` that
spans of one unit of work share across threads (a consensus chunk, a block
pair; new_key()), and counts that the body may add to (sp.add(bytes=n)).

    with trace.span("cns.dispatch", key=k, groups=len(chunk)) as sp:
        ...

Finished spans stay in memory, in one list, in the order they ended
(records()); nothing is written while a run goes on.  A span is recorded
only while this thread records (active()): inside recording(), in work
that carry() handed to another thread from a recording one, or while a
torch.profiler window is open on this thread (so a benchmark's traced
window and FTPU_PROFILE get spans with no option of their own).
Otherwise span() costs that check and returns a shared no-op object; a
span opened with clock=True still measures its own duration
(`sp.seconds`), for a log line, without being recorded.

Every host-to-device copy of the hot path goes through to_device and
every device-to-host one through to_host, which make the same copy as a
bare .to() / .cpu() under a copy.h2d / copy.d2h span with its bytes, and
for h2d the bytes that were pageable.  A pageable source waits for the
stream; a page-locked one (host_buffer) is copied non_blocking, and
PyTorch's caching host allocator keeps its block from reuse until the
copy has run.

append_to_chrome_trace adds spans to an exported torch.profiler trace as
"ftt" events on the trace's own base, so that they line up with the
device's lanes.
"""
import contextlib
import itertools
import json
import os
import threading
import time

import numpy as np
import torch


class _Local(threading.local):
    """A thread's open spans, and whether carry() made it record."""

    on = False

    def __init__(self):
        self.stack = []


_RECORDS = []                 # finished spans, in the order they ended
_ids = itertools.count(1)     # span ids (0: no parent)
_keys = itertools.count(1)
_local = _Local()
_forced = [0]                 # depth of recording() blocks
_forced_lock = threading.Lock()


def active():
    """Whether a span opened on this thread now is recorded."""
    return (_forced[0] > 0 or _local.on or
            torch.autograd._profiler_enabled())


class Span:
    """One interval of one thread (see the module's docstring)."""

    __slots__ = ("name", "key", "counts", "t0", "t1", "tid", "id",
                 "parent", "_keep")

    def __init__(self, name, key, counts, keep):
        self.name = name
        self.key = key
        self.counts = counts
        self._keep = keep
        self.t0 = self.t1 = None
        self.tid = self.id = self.parent = 0

    def add(self, **counts):
        for k, v in counts.items():
            self.counts[k] = self.counts.get(k, 0) + v

    @property
    def seconds(self):
        return (self.t1 - self.t0) / 1e9

    def __enter__(self):
        if self._keep:
            stack = _local.stack
            self.parent = stack[-1].id if stack else 0
            self.id = next(_ids)
            self.tid = threading.get_native_id()
            stack.append(self)
        self.t0 = time.time_ns()
        return self

    def __exit__(self, *exc):
        self.t1 = time.time_ns()
        if self._keep:
            _local.stack.pop()
            _RECORDS.append(self)
        return False


class _NoSpan:
    """What span() returns while nothing records."""

    __slots__ = ()

    def add(self, **counts):
        pass

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


NOOP = _NoSpan()


def span(name, key=None, clock=False, **counts):
    """A span to open with `with`; NOOP when this thread does not record,
    unless clock is set (the caller reads sp.seconds)."""
    if active():
        return Span(name, key, counts, True)
    return Span(name, key, counts, False) if clock else NOOP


def new_key():
    """A key no other unit of work of this process has."""
    return next(_keys)


def open_key():
    """The key of the innermost span open and recorded on this thread
    that has one; None where there is none."""
    for sp in reversed(_local.stack):
        if sp.key is not None:
            return sp.key
    return None


def carry(fn):
    """fn, to run on another thread, recording there when the calling
    thread records now (a profiler window is open only on the thread that
    opened it)."""
    if not active():
        return fn

    def run(*args, **kw):
        was = _local.on
        _local.on = True
        try:
            return fn(*args, **kw)
        finally:
            _local.on = was
    return run


@contextlib.contextmanager
def recording():
    """Record on every thread inside the block; yields the list that gets
    the spans that end inside it."""
    got = []
    n0 = len(_RECORDS)
    with _forced_lock:
        _forced[0] += 1
    try:
        yield got
    finally:
        with _forced_lock:
            _forced[0] -= 1
        got.extend(_RECORDS[n0:])


def mark():
    """A position in the records, for records(since=...)."""
    return len(_RECORDS)


def records(since=0):
    """The spans that ended since `since` (a mark())."""
    return _RECORDS[since:]


def host_buffer(shape, dtype, device):
    """An uninitialised host tensor to fill and hand to to_device:
    page-locked when `device` is CUDA, so that the copy does not wait for
    the stream, plain otherwise.  Write it through its .numpy() view, and
    upload the tensor itself (a tensor made anew from that view is not the
    allocator's block, and its copy would not hold the block)."""
    return torch.empty(shape, dtype=dtype,
                       pin_memory=torch.device(device).type == "cuda")


def to_device(x, device, dtype=None):
    """x (a numpy array or a tensor) on `device`, as x.to(device, dtype)
    makes it, non_blocking from page-locked memory; a copy from the host
    is a copy.h2d span (on a CPU device nothing moves, and the span still
    counts what was handed over)."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(x)
    if x.device.type != "cpu":
        return x.to(device, dtype)
    pinned = x.is_pinned()
    sp = span("copy.h2d")
    with sp:
        out = x.to(device, dtype, non_blocking=pinned)
    if sp is not NOOP:
        n = x.nbytes
        sp.add(bytes=n, pageable=0 if pinned else n)
    return out


def to_host(t):
    """A device tensor as a numpy array (t.cpu().numpy()), under a
    copy.d2h span."""
    with span("copy.d2h", bytes=t.nbytes):
        return t.cpu().numpy()


def append_to_chrome_trace(trace_fn, spans):
    """Add the spans to an exported torch.profiler trace as "X" events of
    cat "ftt": ts and dur in microseconds from the trace's own
    baseTimeNanoseconds, the thread as tid, the key and counts in args."""
    with open(trace_fn) as f:
        d = json.load(f)
    base = int(d.get("baseTimeNanoseconds", 0))
    pid = os.getpid()
    events = d.setdefault("traceEvents", [])
    for s in spans:
        args = dict(s.counts)
        if s.key is not None:
            args["key"] = s.key
        events.append({"ph": "X", "cat": "ftt", "name": s.name, "pid": pid,
                       "tid": s.tid, "ts": (s.t0 - base) / 1e3,
                       "dur": (s.t1 - s.t0) / 1e3, "args": args})
    with open(trace_fn, "w") as f:
        json.dump(d, f)
