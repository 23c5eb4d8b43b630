"""The device's idle share of an overlap window."""
from ftt_bench import readers


def read(run):
    return readers.idle_share(run)
