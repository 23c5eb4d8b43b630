"""The driver's main thread waiting on the block pair's host chain
(overlap.wait_chain: the prefetch thread's future) over the window: how
far the chain, not the alignment, sets the overlap phase's pace."""
from ftt_bench import progspans


def read(run):
    return progspans.layer_share(run, "overlap.align", "overlap.wait_chain")
