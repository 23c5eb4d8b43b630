"""K1's useful over issued lane-steps: the pipeline driver's phase0_occupancy,
averaged over the window's phase repeats."""


def read(run):
    occ = [t["phase0_occupancy"] for t in run.cell.timings
           if "phase0_occupancy" in t]
    return sum(occ) / len(occ) if occ else None
