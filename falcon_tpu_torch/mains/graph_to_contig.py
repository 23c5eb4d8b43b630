"""fc_graph_to_contig equivalent
(reference: falcon_kit/mains/graph_to_contig.py:397-425)."""
import argparse
import sys

from ..graph import to_contig


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    p = argparse.ArgumentParser(
        description="Generate primary/alternate contig fasta files and "
                    "tiling paths from the string graph.")
    p.add_argument("--improper-p-ctg", action="store_true",
                   help="Skip the initial read in each p_ctg path.")
    p.add_argument("--proper-a-ctg", action="store_true",
                   help="Skip the initial read in each a_ctg path.")
    p.add_argument("--out-dir", default=".")
    args = p.parse_args(argv[1:])
    to_contig.run(args.out_dir, improper_p_ctg=args.improper_p_ctg,
                  proper_a_ctg=args.proper_a_ctg)
    return 0


if __name__ == "__main__":
    sys.exit(main())
