"""Seconds of phase 0's ReadStore (pipeline.store: the FASTA read, masking,
blocks, the save and its sidecar) per unit of the window."""
from ftt_bench import progspans


def read(run):
    t = progspans.total_s(progspans.window(run), "pipeline.store")
    return t / run.units if t is not None and run.units else None
