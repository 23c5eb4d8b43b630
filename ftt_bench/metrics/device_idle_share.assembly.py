"""The device's idle share of an assembly window."""
from ftt_bench import readers


def read(run):
    return readers.idle_share(run)
