"""fc_consensus equivalent: seed-grouped consensus from an overlap stream.

Reads "id seq" lines on stdin, groups closed by '+' (emit), '*' (drop),
'-' (stop) -- the LA4Falcon -fo stream format the reference consumes
(reference: falcon_kit/mains/consensus.py get_seq_data:161-209) -- and
writes pread FASTA to stdout with identical gating/output rules.
"""
import argparse
import sys

from ..cns import runner


def stream_groups(f):
    seqs = []
    for line in f:
        parts = line.strip().split()
        if len(parts) != 2:
            continue
        read_id, seq = parts
        if read_id == "+":
            if seqs:
                yield seqs[0][0], seqs
            seqs = []
        elif read_id == "*":
            seqs = []
        elif read_id == "-":
            break
        else:
            seqs.append((read_id, seq))


def parse_args(argv):
    p = argparse.ArgumentParser(
        description="a simple multi-processor consensus sequence generator",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--n-core", type=int, default=24,
                   help="number of processes used for generating consensus; "
                   "0 for main process only")
    p.add_argument("--min-cov", type=int, default=6,
                   help="minimum coverage to break the consensus")
    p.add_argument("--min-cov-aln", type=int, default=10,
                   help="minimum coverage of alignment data")
    p.add_argument("--max-cov-aln", type=int, default=0,
                   help="maximum coverage of alignment data")
    p.add_argument("--min-len-aln", type=int, default=0,
                   help="minimum length of a sequence in an alignment")
    p.add_argument("--min-n-read", type=int, default=10,
                   help="1 + minimum number of reads used in consensus")
    p.add_argument("--max-n-read", type=int, default=500,
                   help="1 + maximum number of reads used in consensus")
    p.add_argument("--trim", action="store_true", default=False,
                   help="trim the input sequence to the aligned range")
    p.add_argument("--output-full", action="store_true", default=False,
                   help="output uncorrected regions too")
    p.add_argument("--output-multi", action="store_true", default=False,
                   help="output multi correct regions")
    p.add_argument("--min-idt", type=float, default=0.70,
                   help="minimum identity of the alignments used")
    p.add_argument("--edge-tolerance", type=int, default=1000,
                   help="for trimming, max unaligned edge length")
    p.add_argument("--trim-size", type=int, default=50,
                   help="trim size from both ends of the aligned region")
    p.add_argument("-v", "--verbose-level", type=float, default=2.0)
    return p.parse_args(argv[1:])


def main(argv=None):
    args = parse_args(argv if argv is not None else sys.argv)
    cfg = runner.ConsensusConfig(
        min_cov=args.min_cov, max_n_read=args.max_n_read,
        min_idt=args.min_idt, edge_tolerance=args.edge_tolerance,
        trim_size=args.trim_size, min_cov_aln=args.min_cov_aln,
        max_cov_aln=args.max_cov_aln, min_n_read=args.min_n_read,
        min_len_aln=args.min_len_aln, output_full=args.output_full,
        output_multi=args.output_multi, trim=args.trim)
    runner.run_consensus(stream_groups(sys.stdin), cfg, sys.stdout)
    return 0


if __name__ == "__main__":
    sys.exit(main())
