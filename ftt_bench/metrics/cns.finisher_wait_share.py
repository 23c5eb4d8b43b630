"""The main thread's wait on the finisher (cns.wait_finisher: the depth-2
bound and the last chunks) over the window."""
from ftt_bench import progspans


def read(run):
    return progspans.layer_share(run, "cns.dispatch", "cns.wait_finisher")
