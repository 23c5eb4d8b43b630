"""Seconds of the overlap table (overlap.table: concatenation, the
symmetric records, and phase 0's table write, sidecar and checkpoint
drop) per unit of the window."""
from ftt_bench import progspans


def read(run):
    t = progspans.total_s(progspans.window(run), "overlap.table")
    return t / run.units if t is not None and run.units else None
