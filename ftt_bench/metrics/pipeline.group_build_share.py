"""Phase 0's building of the consensus groups from the overlap table
(pipeline.make_group, on the main thread that also dispatches) over the
window."""
from ftt_bench import progspans


def read(run):
    return progspans.share(run, progspans.total_s(progspans.window(run),
                                                  "pipeline.make_group"))
