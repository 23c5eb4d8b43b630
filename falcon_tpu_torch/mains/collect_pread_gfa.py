"""collect_pread_gfa equivalent
(reference: falcon_kit/mains/collect_pread_gfa.py:201-240)."""
import argparse
import sys

from ..graph.collect_gfa import collect_pread_gfa


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    p = argparse.ArgumentParser(
        description="Generates GFA JSON (on stdout) from the assembly.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--p-ctg-tiling-path", default="p_ctg_tiling_path")
    p.add_argument("--a-ctg-tiling-path", default="a_ctg_tiling_path")
    p.add_argument("--preads-fasta", default="preads4falcon.fasta")
    p.add_argument("--p-ctg-fasta", default="p_ctg.fa")
    p.add_argument("--a-ctg-fasta", default="a_ctg.fa")
    p.add_argument("--sg-edges-list", default="sg_edges_list")
    p.add_argument("--preads-ovl", default="preads.ovl")
    p.add_argument("--utg-data", default="utg_data")
    p.add_argument("--ctg-paths", default="ctg_paths")
    p.add_argument("--add-string-graph", action="store_true")
    p.add_argument("--write-reads", "-r", action="store_true")
    p.add_argument("--min-p-len", type=int, default=0)
    p.add_argument("--min-a-len", type=int, default=0)
    p.add_argument("--only-these-contigs", default="")
    args = p.parse_args(argv[1:])
    collect_pread_gfa(
        sys.stdout, p_ctg_tiling_path=args.p_ctg_tiling_path,
        a_ctg_tiling_path=args.a_ctg_tiling_path,
        preads_fasta=args.preads_fasta, p_ctg_fasta=args.p_ctg_fasta,
        a_ctg_fasta=args.a_ctg_fasta, sg_edges_list=args.sg_edges_list,
        preads_ovl=args.preads_ovl, utg_data=args.utg_data,
        ctg_paths=args.ctg_paths, add_string_graph=args.add_string_graph,
        write_reads=args.write_reads, min_p_len=args.min_p_len,
        min_a_len=args.min_a_len,
        only_these_contigs=args.only_these_contigs)
    return 0


if __name__ == "__main__":
    sys.exit(main())
