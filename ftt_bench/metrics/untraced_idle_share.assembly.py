"""The device's idle time in an assembly window that no span of the program
covers (the phase spans and cns.run, which only wrap others, left out),
over the window: the idle the program's spans do not name yet."""
from ftt_bench import progspans


def read(run):
    return progspans.untraced_idle_share(run)
