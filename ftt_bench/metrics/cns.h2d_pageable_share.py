"""The share of the consensus dispatch's host-to-device bytes (copy.h2d
counts) that came from pageable memory."""
from ftt_bench import progspans


def read(run):
    spans = progspans.window(run)
    n = progspans.count_below(spans, "cns.dispatch", "copy.h2d", "bytes")
    if not n:
        return None
    return progspans.count_below(spans, "cns.dispatch", "copy.h2d",
                                 "pageable") / n
