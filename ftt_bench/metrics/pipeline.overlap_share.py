"""(phase0_overlap + phase1_overlap) over total, from the pipeline
driver's timings."""
from ftt_bench import readers


def read(run):
    return readers.timing_share(run, ("phase0_overlap", "phase1_overlap"))
