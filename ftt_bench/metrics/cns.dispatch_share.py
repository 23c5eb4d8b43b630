"""The main thread's time in DeviceCns.dispatch_chunk_dp / dispatch_chunk
(gating excluded) over the window."""
from ftt_bench import readers


def read(run):
    return readers.span_share(run, "cns.dispatch")
