"""fc_ovlp_stats equivalent (reference: falcon_kit/mains/ovlp_stats.py)."""
import argparse
import sys

from ..io.fasta import read_fofn
from ..overlap import stats
from .ovlp_filter import file_stream


def parse_args(argv):
    p = argparse.ArgumentParser(
        description="overlap statistics (per-read 5'/3' counts)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--n-core", type=int, default=4)
    p.add_argument("--fofn", type=str, default=None,
                   help="file listing per-block overlap tables")
    p.add_argument("--ovl-fn", type=str, default=None,
                   help="single overlap table")
    p.add_argument("--db", type=str, dest="db_fn", default=None,
                   help="accepted for compatibility; unused")
    p.add_argument("--min-len", type=int, default=2500)
    return p.parse_args(argv[1:])


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv)
    if args.fofn:
        files = read_fofn(args.fofn)
    elif args.ovl_fn:
        files = [args.ovl_fn]
    else:
        print("need --ovl-fn or --fofn", file=sys.stderr)
        return 2
    stats.run_ovlp_stats(sys.stdout, [file_stream(f) for f in files],
                         args.min_len)
    return 0


if __name__ == "__main__":
    sys.exit(main())
