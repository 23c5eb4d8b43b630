"""Distribution of the overlap block-pair plan (the pure planners of
falcon_tpu/parallel/distributed.py).

Every host of a multi-host run owns a deterministic stripe of the
block-pair triangle; a single host owns all of it (host 0 of 1).  Only the
planners live here: the host and the host count are always given, and the
collectives that recombine the stripes' tables are not ported yet.
"""


def block_pair_plan(n_blocks):
    """The full upper-triangle (i, j) block-pair plan, i <= j.

    Deterministic order (row-major) == the reference's HPC.daligner job
    numbering; every host computes the same list.
    """
    return [(i, j) for i in range(n_blocks) for j in range(i, n_blocks)]


def host_block_pairs(n_blocks, host_id, n_hosts):
    """This host's stripe of the block-pair triangle.

    Pairs are dealt round-robin by plan index so the expensive diagonal
    (i == j, densest seed tables) and the cheap tail spread evenly across
    hosts -- the load-balance analog of the reference's scheduler pulling
    jobs from one queue.  Union over hosts == block_pair_plan, disjoint.
    """
    plan = block_pair_plan(n_blocks)
    return plan[host_id::n_hosts]
