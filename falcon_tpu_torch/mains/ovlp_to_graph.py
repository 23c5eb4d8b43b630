"""fc_ovlp_to_graph equivalent
(reference: falcon_kit/mains/ovlp_to_graph.py:1554-1576)."""
import argparse
import sys

from ..graph import unitigs


def parse_args(argv):
    p = argparse.ArgumentParser(
        description="a string graph assembler that is desinged for "
                    "handling diploid genomes",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--overlap-file", default="preads.ovl",
                   help="a file that contains the overlap information.")
    p.add_argument("--min_len", type=int, default=4000,
                   help="minimum length of the reads to be considered")
    p.add_argument("--min_idt", type=float, default=96,
                   help="minimum alignment identity of the reads")
    p.add_argument("--lfc", action="store_true", default=False,
                   help="use local flow constraint method to resolve knots")
    p.add_argument("--disable_chimer_bridge_removal", action="store_true",
                   default=False)
    p.add_argument("--out-dir", default=".")
    return p.parse_args(argv[1:])


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv)
    unitigs.ovlp_to_graph(
        args.overlap_file, args.out_dir, min_len=args.min_len,
        min_idt=args.min_idt, lfc=args.lfc,
        disable_chimer_bridge_removal=args.disable_chimer_bridge_removal)
    return 0


if __name__ == "__main__":
    sys.exit(main())
