"""Spans the benchmark records around its calls into the port's layers
(traced runs only).  A span is (name, start, end) in seconds of
time.time(), the device trace's clock; a wrapped call also hands its
arguments and result to an optional `note` hook, which is how the
benchmark counts the tasks a kernel was given.
"""
import threading
import time


class Spans:
    def __init__(self):
        self.items = []          # (name, t0, t1)
        self._lock = threading.Lock()
        self._undo = []

    def add(self, name, t0, t1):
        with self._lock:
            self.items.append((name, t0, t1))

    def total(self, name):
        return sum(b - a for n, a, b in self.items if n == name)

    def wrap(self, owner, attr, name, note=None):
        """Replace owner.attr (a module function or a class's method) by a
        timed call of the original, which hands its arguments and result
        to `note` where given."""
        orig = getattr(owner, attr)

        def timed(*args, **kw):
            t0 = time.time()
            try:
                out = orig(*args, **kw)
            finally:
                self.add(name, t0, time.time())
            if note is not None:
                note(args, kw, out)
            return out

        self.replace(owner, attr, timed)

    def replace(self, owner, attr, fn):
        """Set owner.attr to fn until restore() puts the original back."""
        raw = vars(owner).get(attr)
        if isinstance(raw, (staticmethod, classmethod)):
            raise TypeError("replace a plain function or method")
        self._undo.append((owner, attr, raw, attr in vars(owner)))
        setattr(owner, attr, fn)

    def restore(self):
        for owner, attr, raw, had in reversed(self._undo):
            if had:
                setattr(owner, attr, raw)
            else:
                delattr(owner, attr)
        self._undo = []
