"""fc_fetch_reads equivalent: per-contig raw read FASTAs for unzip
(reference: falcon_kit/mains/fetch_reads.py)."""
import argparse
import sys

from .. import tracking


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    p = argparse.ArgumentParser(
        description="Extract per-contig raw-read FASTAs "
                    "(3-unzip/reads/<ctg>/reads.fa).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--base-dir", default=".")
    p.add_argument("--ctg-list", default="",
                   help="file with contig ids to extract (default: all)")
    p.add_argument("--min-ctg-size", type=int, default=0)
    args = p.parse_args(argv[1:])
    ctgs = None
    if args.ctg_list:
        ctgs = set(open(args.ctg_list).read().split())
    written = tracking.fetch_reads(args.base_dir, ctg_list=ctgs,
                                   min_ctg_size=args.min_ctg_size)
    for ctg in sorted(written):
        print(ctg, written[ctg])
    return 0


if __name__ == "__main__":
    sys.exit(main())
