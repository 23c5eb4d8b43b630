"""fc_snakemake -- export a Snakefile that drives the falcon_tpu_torch
pipeline (the reference writes an equivalent mirror of its pypeflow DAG
from fc_run, falcon_kit/snakemake.py:25-231; see
pipeline.snakemake for why the falcon_tpu_torch export is three
artifact-gated phase rules)."""
import argparse
import logging
import sys


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    p = argparse.ArgumentParser(
        description="Write a Snakefile driving the falcon_tpu_torch pipeline "
                    "(3 artifact-gated phase rules).")
    p.add_argument("config", help="fc_run-style cfg (ini [General] or "
                                  "JSON)")
    p.add_argument("-o", "--output", default="Snakefile")
    p.add_argument("--run-dir", default=".",
                   help="pipeline run directory the rules operate in")
    args = p.parse_args(argv[1:])
    logging.basicConfig(level=logging.INFO)
    from ..pipeline.snakemake import write_snakefile
    out = write_snakefile(args.config, args.output, args.run_dir)
    logging.getLogger(__name__).info("wrote %s", out)
    return 0


if __name__ == "__main__":
    sys.exit(main())
