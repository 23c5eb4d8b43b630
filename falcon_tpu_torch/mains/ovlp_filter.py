"""fc_ovlp_filter equivalent (reference: falcon_kit/mains/ovlp_filter.py).

Input: either --ovl-fn (a 13-column overlap table, possibly
'---'-terminated, as produced by the falcon_tpu_torch overlap engine) or
--las-fofn listing several such per-block tables.
"""
import argparse
import os
import sys

from ..io.fasta import read_fofn
from ..overlap import filter as ofilter


def file_stream(path):
    def readlines():
        with open(path) as f:
            for line in f:
                if line.startswith("-"):
                    break
                if line.strip():
                    yield line
    return readlines


def parse_args(argv):
    p = argparse.ArgumentParser(
        description="a simple multi-processes overlap data filter",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--out-fn", default="preads.ovl",
                   help="Output filename")
    p.add_argument("--n-core", type=int, default=4)
    p.add_argument("--las-fofn", type=str, default=None,
                   help="file listing per-block overlap tables")
    p.add_argument("--ovl-fn", type=str, default=None,
                   help="single overlap table")
    p.add_argument("--db", type=str, dest="db_fn", default=None,
                   help="accepted for compatibility; unused")
    p.add_argument("--max-diff", type=int, required=True,
                   help="max difference of 5' and 3' coverage")
    p.add_argument("--max-cov", type=int, required=True,
                   help="max coverage of 5' or 3' coverage")
    p.add_argument("--min-cov", type=int, required=True,
                   help="min coverage of 5' or 3' coverage")
    p.add_argument("--min-len", type=int, default=2500,
                   help="min length of the reads")
    p.add_argument("--bestn", type=int, default=10,
                   help="output at least best n overlaps per end")
    p.add_argument("--stream", action="store_true")
    p.add_argument("--debug", "-g", action="store_true")
    p.add_argument("--silent", action="store_true")
    return p.parse_args(argv[1:])


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv)
    if args.las_fofn:
        files = read_fofn(args.las_fofn)
    elif args.ovl_fn:
        files = [args.ovl_fn]
    else:
        print("need --ovl-fn or --las-fofn", file=sys.stderr)
        return 2
    streams = [file_stream(fn) for fn in files]
    tmp = args.out_fn + ".tmp"
    with open(tmp, "w") as out:
        ofilter.run_ovlp_filter(out, streams, args.max_diff, args.max_cov,
                                args.min_cov, args.min_len, args.bestn)
    os.rename(tmp, args.out_fn)
    return 0


if __name__ == "__main__":
    sys.exit(main())
