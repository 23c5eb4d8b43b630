"""Readings of a cell's checked numbers on several seeds in one process,
for setting its limits (limits/<cell>.json): the program as the cell runs
it (`sound`) and the cell's control, the program with the guarantee that
limits/<cell>.json's `control` breaks (`control`).  Not part of a
benchmark run.

    python -m ftt_bench.control --workload <cell> --seeds 1,2,3
        --seconds <s> [--modes sound,control]

One JSON line per (seed, mode) with the numbers and `correct`.
"""
import argparse
import json
import sys
import time

from ftt_bench import registry, run


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=5)
    ap.add_argument("--modes", default="sound,control")
    args = ap.parse_args(argv)
    reg = registry.Registry()
    wl = reg.workload(args.workload)
    ctl = reg.limits(wl["name"])["control"]
    for seed in (int(s) for s in args.seeds.split(",")):
        for mode in args.modes.split(","):
            t0 = time.time()
            res = run.run_cell(reg, wl, seed, args.seconds, 0, t_start=t0,
                               cfg_override=ctl if mode == "control"
                               else None)
            print(json.dumps({
                "workload": wl["name"], "seed": seed, "mode": mode,
                "correct": res["correct"],
                "checks": {k: c["value"] for k, c in res["checks"].items()},
                "rate": {k: m["value"] for k, m in res["metrics"].items()},
                "attempted": res["attempted"],
                "seconds": time.time() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
