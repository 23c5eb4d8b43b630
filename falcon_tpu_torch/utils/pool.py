"""Process-pool helper with an in-process fallback.

The reference runs consensus and filter workers through a Pool factory
that degrades to a synchronous fake when n_core=0, which doubles as the
determinism/debug mode (reference: falcon_kit/multiproc.py:10-36).  Same
contract here; used for the host-side consensus fan-out.
"""
import multiprocessing


class FakePool:
    """Synchronous in-process 'pool' (n_core=0 debug/determinism mode)."""

    def __init__(self, initializer=None, initargs=(), *args, **kwds):
        if initializer:
            initializer(*initargs)

    def map(self, func, iterable):
        return [func(x) for x in iterable]

    def imap(self, func, iterable):
        return (func(x) for x in iterable)

    def terminate(self):
        pass

    def close(self):
        pass

    def join(self):
        pass


def Pool(processes, initializer=None, initargs=(), **kwds):
    """multiprocessing.Pool, or FakePool when processes <= 0."""
    if processes and processes > 0:
        return multiprocessing.Pool(processes, initializer=initializer,
                                    initargs=initargs, **kwds)
    return FakePool(initializer=initializer, initargs=initargs)
