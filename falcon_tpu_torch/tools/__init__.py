"""The port's tools, counterparts of falcon_tpu's tools/*.py, each runnable
as `python -m falcon_tpu_torch.tools.<name>`:

  check_assembly    score p_ctg.fa against a simulated truth genome
                    (tools/check_assembly.py; host code)
  verify_quick      simulate a 100 kb genome, assemble it, check the
                    contig (tools/verify_quick.py)
  profile_extender  the extender's packed gather, K1, and the two chained
                    (tools/profile_extender.py)
  profile_cns_dp    the device-DP consensus batch stage by stage, against
                    the production path (tools/profile_cns_dp.py)
  bench_accumulate  K4 against its twin and the scatter alone
                    (tools/bench_accumulate.py)

Every tool takes --device (default cuda) and raises on a machine without a
GPU unless it is asked for the CPU; inputs come from a seed through
utils.sim.  The tools that run kernels report the launches of each stage
from the wrappers' LAUNCHES counters (common.launch_counts).
"""
