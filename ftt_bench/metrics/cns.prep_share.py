"""The main thread's host prep in the consensus dispatch over the window:
the program's cns.dispatch spans less the parts their copy.h2d,
cns.launch and cns.wait_device spans cover (building tasks, packing,
bucketing)."""
from ftt_bench import progspans


def read(run):
    return progspans.share(run, progspans.self_s(
        progspans.window(run), "cns.dispatch",
        ("copy.h2d", "cns.launch", "cns.wait_device")))
