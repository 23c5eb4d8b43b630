"""Read-to-contig tracking CLI: the fc_get_read_ctg_map +
fc_rr_ctg_track + fc_pr_ctg_track chain in one tool
(reference: falcon_kit/mains/{get_read_ctg_map,rr_ctg_track,
pr_ctg_track}.py)."""
import argparse
import sys

from .. import tracking


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    p = argparse.ArgumentParser(
        description="Build read_maps/{read_to_contig_map,"
                    "rawread_to_contigs,pread_to_contigs} for a run dir.",
        formatter_class=argparse.ArgumentDefaultsHelpFormatter)
    p.add_argument("--base-dir", default=".",
                   help="pipeline run directory (holds 0-rawreads/ etc.)")
    p.add_argument("--min-len", type=int, default=2500)
    p.add_argument("--stream", action="store_true",
                   help="accepted for compatibility; unused")
    p.add_argument("--bestn", type=int, default=40)
    args = p.parse_args(argv[1:])
    maps_dir = tracking.run_tracking(args.base_dir, min_len=args.min_len,
                                     bestn=args.bestn)
    print(maps_dir)
    return 0


if __name__ == "__main__":
    sys.exit(main())
