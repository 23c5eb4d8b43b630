"""phase0_consensus over total, from the pipeline driver's timings."""
from ftt_bench import readers


def read(run):
    return readers.timing_share(run, ("phase0_consensus",))
