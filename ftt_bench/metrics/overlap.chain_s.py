"""Seconds of the host chain (overlap.engine.chain_blocks' own index and
chain times) per phase repeat of the window."""


def read(run):
    if not run.cell.chain or not run.units:
        return None
    return sum(a + b for a, b in run.cell.chain) / run.units
