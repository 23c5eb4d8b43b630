"""Command-line tools (the reference's falcon_kit/mains CLI surface).

Each module is runnable as `python -m falcon_tpu_torch.mains.<tool>` and exposed
as a console script (setup.py), keeping the reference's tool names and
option vocabularies where the tool survives the architecture change:

  reference console script      falcon_tpu_torch equivalent
  ------------------------      ---------------------
  fc_run                        ftpu-run / mains.run
  fc_consensus                  mains.consensus
  fc_ovlp_filter                mains.ovlp_filter
  fc_ovlp_stats                 mains.ovlp_stats
  fc_ovlp_to_graph              mains.ovlp_to_graph
  fc_graph_to_contig            mains.graph_to_contig
  fc_graph_to_utgs              mains.graph_to_utgs
  fc_dedup_a_tigs               mains.dedup_a_tigs
  fc_calc_cutoff                mains.calc_cutoff
  fc_gen_gfa_v1 / v2            mains.gen_gfa_v1 / v2
  (collect_pread_gfa etc.)      mains.collect_pread_gfa / contig_gfa
  fc_rr_ctg_track etc.          mains.track_reads
  fc_fetch_reads                mains.fetch_reads

Tools that only existed to drive external Dazzler binaries or the
pypeFLOW file DAG (daligner_split, las_merge_*, LAsort/LAmerge, build_rdb,
generic_* unit-of-work runners, snakemake export, hgap4_adapt) have no
equivalent: their role is subsumed by the in-process overlap engine and
phase driver.  See MIGRATION.md.
"""
