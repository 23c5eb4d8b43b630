"""Device consensus, host-MSA half (port of falcon_tpu/cns/device.py).

The device aligns every (support, seed-range) pair of a chunk of seed
groups with traceback -- K2 + K3 through ops.align_tb_cuda, batched and
length-bucketed -- and the host rebuilds the gapped strings and runs the
exact align-tag MSA + best-path DP (native C++ moves_to_alns and
cns_from_alns).  DeviceCns replaces falcon_tpu's DeviceCns with its
use_dp=False path (the single-host default); run_consensus_device
replaces its namesake.

Shared with falcon_tpu.cns.device, which imports no JAX at module level:
the group gates (gate_group_ranged, _clamp_range, _range_ok), the code
conversions, and the host-only methods dispatch_chunk, finish_chunk, _msa
and _host_range, bound here unchanged.  The device-DP consensus path
(ops/cns_dp.py) is not ported yet.
"""
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from falcon_tpu.cns import device as _ref
from falcon_tpu.cns import runner
from falcon_tpu.cns.device import gate_group_ranged
from falcon_tpu.ops import native

from ..ops.align_device import DeviceExtender, gather_pad2, pack_tasks
from ..ops.align_tb import moves_to_alignment, unpack_moves
from ..ops.align_tb_cuda import align_tb_batch_cuda
from ..utils.device import resolve_device

LOG = logging.getLogger(__name__)


class DeviceCns:
    """Chunked device consensus over gated groups."""

    def __init__(self, W=None, max_cells=None, chunk_tasks=None,
                 moves_budget=None, device=None):
        self.device = resolve_device(device)
        on_cpu = self.device.type == "cpu"
        # rows * L per batch; the K2 trace is 2 * L * B * W bytes, so
        # moves_budget / (2W) caps the cells too.  The plain twin keeps
        # the same planes in host memory (hence the smaller CPU budget)
        # and pays a Python step per anti-diagonal (hence few, wide
        # batches)
        self.max_cells = max_cells or ((1 << 20) if on_cpu else (1 << 22))
        self.moves_budget = moves_budget or (
            (1 << 30) if on_cpu else (1 << 31))
        # the consensus band (falcon_tpu's validated default, FTPU_CNS_W)
        self.W = W or int(os.environ.get("FTPU_CNS_W", "256"))
        self.chunk_tasks = chunk_tasks or int(
            os.environ.get("FTPU_CNS_CHUNK_TASKS", "8192"))

    def _batch_for(self, L):
        """Rows per batch.  K2/K3 run one block or thread per row, so B
        needs no tile rounding; the trace budget alone bounds it."""
        cells = min(self.max_cells, self.moves_budget // (2 * self.W))
        return max(1, min(1024, cells // max(L, 1)))

    def _align_tb(self, q, qlen, t, tlen):
        return align_tb_batch_cuda(q, qlen, t, tlen, W=self.W)

    def dispatch_tasks(self, tasks):
        """Queue every task batch on the device without waiting.

        tasks: [(q_codes, t_codes)].  Returns the in-flight list for
        collect_tasks: (task indices, (best_d, packed moves)) per batch,
        the device tensors kept referenced until they are copied back."""
        buckets = {}
        for idx, (qc, tc) in enumerate(tasks):
            m = max(len(qc), len(tc), 1)
            L = next(r for r in DeviceExtender.LADDER if m <= r)
            buckets.setdefault(L, []).append(idx)
        inflight = []
        t0 = time.time()
        dev = self.device
        for L in sorted(buckets):
            idxs = sorted(buckets[L],
                          key=lambda i: len(tasks[i][0]) + len(tasks[i][1]))
            B = self._batch_for(L)
            for ofs in range(0, len(idxs), B):
                chunk = idxs[ofs:ofs + B]
                packed = [torch.from_numpy(a).to(dev) for a in
                          pack_tasks(tasks, chunk, len(chunk), L)]
                q, t = gather_pad2(*packed, L, 4, 5)
                _, _, bd, mvp, _ = self._align_tb(q, packed[2], t,
                                                  packed[4])
                inflight.append((chunk, (bd, mvp)))
        LOG.info("cns.device: dispatched %d aln tasks, %d buckets %s, "
                 "%d batches in %.1fs", len(tasks), len(buckets),
                 sorted(buckets), len(inflight), time.time() - t0)
        return inflight

    def collect_tasks(self, tasks, inflight):
        """Copy dispatched batches back and rebuild the alignments.
        Returns per-task (dist, n_cols, q_aln, t_aln) (ASCII bytes;
        n_cols == 0 when no alignment)."""
        results = [None] * len(tasks)
        t0 = time.time()
        t_host = 0.0
        use_native = native.available()
        for chunk, (bd_d, mvp_d) in inflight:
            bd = bd_d.cpu().numpy()
            mvp = mvp_d.cpu().numpy()
            t1 = time.time()
            if use_native:
                alns = native.moves_to_alns(
                    mvp, np.arange(len(chunk), dtype=np.int32),
                    [tasks[idx][0] for idx in chunk],
                    [tasks[idx][1] for idx in chunk])
                for k, idx in enumerate(chunk):
                    ncols, qa, ta = alns[k]
                    results[idx] = (int(bd[k]), ncols, qa, ta)
            else:
                mv = unpack_moves(mvp)
                for k, idx in enumerate(chunk):
                    qc, tc = tasks[idx]
                    qa, ta = moves_to_alignment(qc, tc, mv[:, k])
                    results[idx] = (int(bd[k]), len(qa), qa, ta)
            t_host += time.time() - t1
        LOG.info("cns.device: collected %d aln tasks in %.1fs "
                 "(host reconstruct %.1fs)", len(tasks), time.time() - t0,
                 t_host)
        return results

    def align_tasks(self, tasks):
        """tasks: [(q_codes, t_codes)] -> [(dist, n_cols, q_aln, t_aln)]."""
        return self.collect_tasks(tasks, self.dispatch_tasks(tasks))

    # host-only chunk stages, unchanged from falcon_tpu
    dispatch_chunk = _ref.DeviceCns.dispatch_chunk
    finish_chunk = _ref.DeviceCns.finish_chunk
    _msa = _ref.DeviceCns._msa
    _host_range = _ref.DeviceCns._host_range


def run_consensus_device(groups, cfg, out, dev=None, progress_cb=None):
    """Drop-in for cns.runner.run_consensus on the device path.

    groups: iterable of (seed_id, [(read_id, seq, rng), ...]), seed first.
    Writes pread FASTA to `out`; returns the number of sequences emitted.
    progress_cb(k) runs after each chunk's output is written, with k the
    number of input groups fully processed (emission order is dispatch
    order), as in falcon_tpu."""
    dev = dev or DeviceCns()
    emitted = 0
    chunk = []
    n_tasks = 0
    futs = []
    n_pulled = 0
    chunk_mark = 0

    def finish(state, mark):
        # the one finisher thread writes `out`, in dispatch order; the
        # state holds each batch's device tensors until they are copied
        nonlocal emitted
        if dev.device.type == "cuda":
            torch.cuda.set_device(dev.device)
        for seed_id, cns in dev.finish_chunk(state):
            emitted += runner.format_output(cns, seed_id, cfg, out)
        if progress_cb is not None:
            progress_cb(mark)

    # depth-2 software pipeline: the main thread gates groups and queues
    # device batches; the finisher copies back, rebuilds and runs the MSA
    # (the C++ calls release the GIL)
    t0 = time.time()
    with ThreadPoolExecutor(1) as finisher:

        def flush():
            nonlocal chunk, n_tasks
            if not chunk:
                return
            state = dev.dispatch_chunk(chunk, cfg)
            chunk = []
            n_tasks = 0
            futs.append(finisher.submit(finish, state, chunk_mark))
            while len(futs) > 2:
                futs.pop(0).result()

        for seed_id, items in groups:
            n_pulled += 1
            gated = gate_group_ranged(seed_id, items, cfg)
            if gated is None:
                continue
            seed_seq, sups = gated
            chunk.append((seed_id, seed_seq, sups))
            chunk_mark = n_pulled
            n_tasks += len(sups)
            if n_tasks >= dev.chunk_tasks:
                flush()
        flush()
        if progress_cb is not None and n_pulled > chunk_mark:
            futs.append(finisher.submit(progress_cb, n_pulled))
        for f in futs:
            f.result()
    LOG.info("cns.device: total %.1fs", time.time() - t0)
    return emitted
