"""Multi-process distribution of the overlap block-pair plan (port of
falcon_tpu/parallel/distributed.py).

Every process of a run owns a deterministic stripe of the block-pair
triangle (host_block_pairs), aligns it on its own devices, and the
symmetric overlap table is recombined with one all-gather at the end of
the phase (allgather_table), after which every process holds the same
table and runs the rest of the pipeline on it.  A single process owns the
whole triangle and its gathers are the identity.

falcon_tpu joins jax.distributed; the port joins a torch.distributed group
on the gloo backend, from the same three variables:
FTPU_COORDINATOR_ADDRESS (host:port of rank 0's rendezvous),
FTPU_NUM_PROCESSES and FTPU_PROCESS_ID.  Gloo and not NCCL, because what
is gathered is host data (falcon_tpu gathers host arrays too), and because
NCCL refuses two ranks on one GPU.  The gathers move raw bytes: lengths
travel as int64, each process's buffer is padded to the longest and cut
back, so no dtype is narrowed on the way.

Nothing here runs at import: init_process_group is called only inside
init_distributed().
"""
import logging
import os

import numpy as np
import torch
import torch.distributed as dist

LOG = logging.getLogger(__name__)


def want_distributed():
    """Whether this process was launched as one of a multi-process run:
    FTPU_COORDINATOR_ADDRESS is set."""
    return bool(os.environ.get("FTPU_COORDINATOR_ADDRESS"))


def _group_size():
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size()
    return 1


def init_distributed():
    """Join the run's torch.distributed group (gloo) when launched as one
    of several processes; returns (rank, world size), or (0, 1) when not
    launched so.  A group already joined is kept.

    A process that was asked to join (FTPU_COORDINATOR_ADDRESS set) and
    cannot raises: degrading to one process would make every process
    compute the whole triangle and skip the gather."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_rank(), dist.get_world_size()
    coord = os.environ.get("FTPU_COORDINATOR_ADDRESS")
    if not coord:
        return 0, 1
    try:
        num = int(os.environ["FTPU_NUM_PROCESSES"])
        pid = int(os.environ["FTPU_PROCESS_ID"])
    except (KeyError, ValueError) as e:
        raise RuntimeError("FTPU_COORDINATOR_ADDRESS is set, so "
                           "FTPU_NUM_PROCESSES and FTPU_PROCESS_ID must be "
                           "integers (%r)" % e) from None
    if not dist.is_available():
        raise RuntimeError("torch.distributed is not available in this "
                           "build of torch")
    dist.init_process_group("gloo", init_method="tcp://" + coord,
                            world_size=num, rank=pid)
    LOG.info("torch.distributed (gloo) initialized: process %d/%d via %s",
             pid, num, coord)
    return dist.get_rank(), dist.get_world_size()


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


def _allgather_ragged_1d(local):
    """All-gather ragged 1-D uint8 arrays; returns the per-process list,
    by rank."""
    n = _group_size()
    count = torch.tensor([local.shape[0]], dtype=torch.int64)
    counts = [torch.zeros(1, dtype=torch.int64) for _ in range(n)]
    dist.all_gather(counts, count)
    counts = [int(c) for c in counts]
    cap = max(1, max(counts))
    padded = np.zeros(cap, np.uint8)
    padded[:local.shape[0]] = local
    bufs = [torch.empty(cap, dtype=torch.uint8) for _ in range(n)]
    dist.all_gather(bufs, torch.from_numpy(padded))
    return [b[:c].numpy() for b, c in zip(bufs, counts)]


def allgather_lines(lines):
    """All-gather a list of text lines (one overlap record each).

    Every process returns the identical concatenated list, ordered by rank
    (then local order).  Single process: returns `lines` as-is."""
    if _group_size() == 1:
        return list(lines)
    buf = np.frombuffer(("\n".join(lines) + "\n" if lines else "")
                        .encode(), dtype=np.uint8)
    out = []
    for h_buf in _allgather_ragged_1d(buf):
        text = h_buf.tobytes().decode()
        out.extend(ln for ln in text.split("\n") if ln)
    return out


def allgather_table(tbl):
    """All-gather a columnar overlap table (overlap.table structured
    array) through its raw bytes.  Every process returns the same
    concatenated table, ordered by rank; single process: identity."""
    if _group_size() == 1:
        return tbl
    dt = tbl.dtype
    gathered = _allgather_ragged_1d(
        np.ascontiguousarray(tbl).view(np.uint8).reshape(-1))
    parts = [np.ascontiguousarray(b).view(dt) for b in gathered]
    out = np.concatenate(parts) if parts else tbl[:0]
    LOG.info("allgather_table: %d processes, %s local rows -> %d total",
             len(parts), [len(p) for p in parts], len(out))
    return out


def allgather_records(local_rows, n_cols, dtype=np.int64):
    """All-gather each process's overlap-record rows.

    local_rows: (N_local, n_cols) array (ragged N across processes).
    Every process returns the identical concatenated (N_total, n_cols)
    array, ordered by rank.  Single process: returns local_rows
    unchanged.  The rows travel as raw bytes, so int64 values keep all
    their bits."""
    local = np.ascontiguousarray(
        np.asarray(local_rows, dtype=dtype).reshape(-1, n_cols))
    if _group_size() == 1:
        return local
    gathered = _allgather_ragged_1d(local.view(np.uint8).reshape(-1))
    parts = [np.ascontiguousarray(b).view(dtype).reshape(-1, n_cols)
             for b in gathered]
    out = np.concatenate(parts, axis=0) if parts else local[:0]
    LOG.info("allgather_records: %d processes, %s local rows -> %d total",
             len(parts), [p.shape[0] for p in parts], out.shape[0])
    return out
