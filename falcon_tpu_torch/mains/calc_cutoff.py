"""fc_calc_cutoff equivalent: seed length cutoff for a target coverage
(reference: falcon_kit/mains/calc_cutoff.py + functional.calc_cutoff
:225-283 -- there it parses DBstats output; here it reads the reads
directly or a saved ReadStore)."""
import argparse
import sys


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    p = argparse.ArgumentParser(
        description="Calculate the seed length cutoff so that reads "
                    "above it total coverage * genome_size bases.")
    p.add_argument("--coverage", type=float, required=True)
    p.add_argument("--genome-size", type=float, required=True)
    p.add_argument("reads", help="FASTA/fofn path or ReadStore .npz")
    args = p.parse_args(argv[1:])

    from ..io import fasta, readstore
    if args.reads.endswith(".npz"):
        store = readstore.ReadStore.load(args.reads)
    elif args.reads.endswith(".fofn"):
        store = readstore.ReadStore.from_fasta_files(
            fasta.read_fofn(args.reads))
    else:
        store = readstore.ReadStore.from_fasta_files([args.reads])
    try:
        cutoff = store.calc_length_cutoff(args.coverage, args.genome_size)
    except ValueError as e:
        # the reference raises with a user-facing message in this case
        # (functional.py:252-258)
        print("GenomeCoverageError: %s" % e, file=sys.stderr)
        return 1
    print(cutoff)
    return 0


if __name__ == "__main__":
    sys.exit(main())
