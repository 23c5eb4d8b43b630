"""The main thread's time in host-to-device copies (copy.h2d spans) under
the consensus dispatch, over the window: blocking copies of pageable
memory, each of which waits for the stream's queued kernels."""
from ftt_bench import progspans


def read(run):
    return progspans.share(run, progspans.covered_s(
        progspans.window(run), "cns.dispatch", ("copy.h2d",)))
