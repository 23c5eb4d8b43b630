"""fc_dedup_a_tigs equivalent
(reference: falcon_kit/mains/dedup_a_tigs.py)."""
import argparse
import sys

from ..graph import to_contig


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    p = argparse.ArgumentParser(
        description="Removes duplicate a-tigs (a_ctg_all.fa -> a_ctg.fa)",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--max_idt", type=int, default=96,
                   help="keep a-tig if identity (%%) to primary <= max_idt")
    p.add_argument("--max_aln_cov", type=int, default=97,
                   help="keep a-tig if alignment coverage (%%) <= max_aln_cov")
    p.add_argument("--min_len_diff", type=int, default=500,
                   help="keep a-tig if length difference > min_len_diff")
    p.add_argument("--out-dir", default=".")
    args = p.parse_args(argv[1:])
    to_contig.dedup_a_tigs(args.out_dir, max_idt=args.max_idt,
                           max_aln_cov=args.max_aln_cov,
                           min_len_diff=args.min_len_diff)
    return 0


if __name__ == "__main__":
    sys.exit(main())
