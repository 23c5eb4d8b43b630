"""fc_graph_to_utgs equivalent
(reference: falcon_kit/mains/graph_to_utgs.py)."""
import argparse
import sys

from ..graph import to_utgs


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    p = argparse.ArgumentParser(description="Emit unitig sequences "
                                            "(utgs.fa)")
    p.add_argument("--out-dir", default=".")
    args = p.parse_args(argv[1:])
    to_utgs.run(args.out_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
