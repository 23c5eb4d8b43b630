"""fc_report_pre_assembly equivalent: the pre-assembly stats JSON
(reference: falcon_kit/mains/report_pre_assembly.py + stats_preassembly)."""
import argparse
import json
import sys

from ..io import readstore
from ..pipeline import stats


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    p = argparse.ArgumentParser(
        description="Write the pre-assembly statistics report JSON.")
    p.add_argument("--raw-store", required=True,
                   help="ReadStore path (0-rawreads/raw_reads[.npz])")
    p.add_argument("--preads-fasta", required=True)
    p.add_argument("--length-cutoff", type=int, required=True)
    p.add_argument("--genome-length", type=int, required=True)
    p.add_argument("--out", default="-")
    args = p.parse_args(argv[1:])
    store = readstore.ReadStore.load(args.raw_store)
    report = stats.preassembly_report(store, args.preads_fasta,
                                      args.length_cutoff,
                                      args.genome_length)
    out = sys.stdout if args.out == "-" else open(args.out, "w")
    json.dump(report, out, indent=2)
    out.write("\n")
    if out is not sys.stdout:
        out.close()
    return 0


if __name__ == "__main__":
    sys.exit(main())
