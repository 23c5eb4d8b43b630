"""The main thread's wait on the DP path's in-flight bound (cns.wait_device:
the walk of the batch before last) over the window; 0 on a path that
dispatched and never waited so."""
from ftt_bench import progspans


def read(run):
    return progspans.layer_share(run, "cns.dispatch", "cns.wait_device")
