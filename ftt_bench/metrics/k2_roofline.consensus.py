"""K2's share of its roofline (percent) over the consensus tasks."""
from ftt_bench import readers


def read(run):
    return readers.kernel_roofline(run, "K2")
