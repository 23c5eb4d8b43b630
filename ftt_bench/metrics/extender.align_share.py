"""The time in overlap.engine.align_candidates (the packed gather, K1,
the records) over the window."""
from ftt_bench import readers


def read(run):
    return readers.span_share(run, "extender.align")
