"""fc_gen_gfa_v2 equivalent: GFA JSON -> GFA-2 text on stdout
(reference: falcon_kit/mains/gen_gfa_v2.py)."""
import argparse
import sys

from ..graph.gfa import deserialize_gfa


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    p = argparse.ArgumentParser(
        description="Generates GFA-2 output (on stdout) from collected "
                    "GFA JSON.")
    p.add_argument("collected_gfa", type=str,
                   help="Path to the collected GFA JSON file")
    args = p.parse_args(argv[1:])
    with open(args.collected_gfa) as f:
        deserialize_gfa(f).write_gfa_v2(sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
