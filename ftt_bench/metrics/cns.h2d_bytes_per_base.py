"""Bytes the consensus dispatch copies to the device (its copy.h2d counts)
a base of the window's K2 tasks (query plus target lengths, as the
benchmark counts them at _align_batches): 2 for the bases alone, more
for padding, offsets and the DP batches' seeds."""
from ftt_bench import progspans


def read(run):
    bases = sum(int(q.sum() + t.sum()) for q, t in run.cell.tasks["K2"])
    n = progspans.count_below(progspans.window(run), "cns.dispatch",
                              "copy.h2d", "bytes")
    return n / bases if n is not None and bases else None
