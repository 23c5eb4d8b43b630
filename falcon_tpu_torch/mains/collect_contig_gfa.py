"""collect_contig_gfa equivalent
(reference: falcon_kit/mains/collect_contig_gfa.py:64-89)."""
import argparse
import sys

from ..graph.collect_gfa import collect_contig_gfa


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    p = argparse.ArgumentParser(
        description="Generates contig-level GFA JSON (on stdout).",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--p-ctg-tiling-path", default="p_ctg_tiling_path")
    p.add_argument("--a-ctg-tiling-path", default="a_ctg_tiling_path")
    p.add_argument("--p-ctg-fasta", default="p_ctg.fa")
    p.add_argument("--a-ctg-fasta", default="a_ctg.fa")
    p.add_argument("--write-contigs", "-c", action="store_true")
    p.add_argument("--min-p-len", type=int, default=0)
    p.add_argument("--min-a-len", type=int, default=0)
    p.add_argument("--only-these-contigs", default="")
    args = p.parse_args(argv[1:])
    collect_contig_gfa(
        sys.stdout, p_ctg_tiling_path=args.p_ctg_tiling_path,
        a_ctg_tiling_path=args.a_ctg_tiling_path,
        p_ctg_fasta=args.p_ctg_fasta, a_ctg_fasta=args.a_ctg_fasta,
        write_contigs=args.write_contigs, min_p_len=args.min_p_len,
        min_a_len=args.min_a_len,
        only_these_contigs=args.only_these_contigs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
