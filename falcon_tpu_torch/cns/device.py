"""Device consensus (port of falcon_tpu/cns/device.py).

Two paths, chosen as in falcon_tpu (use_dp; FTPU_CNS_DP=1 selects the
device-DP path, anything else the host-MSA path):

  host MSA   the device aligns every (support, seed-range) pair of a chunk
             of seed groups with traceback -- K2 + K3 through
             ops.align_tb_cuda, batched and length-bucketed -- and the host
             rebuilds the gapped strings and runs the exact align-tag MSA +
             best-path DP (native C++ moves_to_alns and cns_from_alns)
  device DP  the same alignments, then per DP batch of G groups the tags
             (K4), the forward scan (K5) and the backtrack walk (K6) on the
             device (ops.cns_dp_cuda); the host only decodes the emitted
             codes

DeviceCns replaces falcon_tpu's DeviceCns; run_consensus_device replaces
its namesake.  Shared with falcon_tpu.cns.device, which imports no JAX at
module level: the group gates (gate_group_ranged, _clamp_range, _range_ok),
the code conversions, and the host-only methods dispatch_chunk,
finish_chunk, _msa and _host_range, bound here unchanged.
"""
import collections
import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from falcon_tpu.cns import device as _ref
from falcon_tpu.cns import runner
from falcon_tpu.cns.device import (_clamp_range, _range_ok,
                                   gate_group_ranged, seq_to_codes)
from falcon_tpu.ops import native

from ..ops import cns_dp
from ..ops import cns_dp_cuda as dpk
from ..ops.align_device import DeviceExtender, gather_pad2, pack_tasks
from ..ops.align_tb import moves_to_alignment, unpack_moves
from ..ops.align_tb_cuda import align_tb_batch_cuda
from ..utils.device import resolve_device

LOG = logging.getLogger(__name__)


class DeviceCns:
    """Chunked device consensus over gated groups."""

    def __init__(self, W=None, max_cells=None, chunk_tasks=None,
                 moves_budget=None, device=None, use_dp=None,
                 dp_delta_cap=None, dp_budget=None):
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
        # the device-DP path: falcon_tpu's switch and sizes, read with the
        # same meanings (one process, so FTPU_CNS_DP alone decides)
        if use_dp is None:
            use_dp = os.environ.get("FTPU_CNS_DP", "") == "1"
        self.use_dp = use_dp
        self.dp_delta_cap = dp_delta_cap or int(
            os.environ.get("FTPU_CNS_DP_DELTA", str(cns_dp.D_DEFAULT)))
        self.dp_budget = dp_budget or int(float(
            os.environ.get("FTPU_CNS_DP_BUDGET", "3e9")))
        # larger chunks fill the DP batches; the host-MSA path keeps them
        # small so that its finisher overlaps the device
        self.chunk_tasks = chunk_tasks or int(
            os.environ.get("FTPU_CNS_CHUNK_TASKS") or
            (32768 if use_dp else 8192))
        self.dp_batches = collections.Counter()    # T -> DP batches run

    def _batch_for(self, L):
        """Rows per batch.  K2/K3 run one block or thread per row, so B
        needs no tile rounding; the trace budget alone bounds it."""
        cells = min(self.max_cells, self.moves_budget // (2 * self.W))
        return max(1, min(1024, cells // max(L, 1)))

    def _align_tb(self, q, qlen, t, tlen):
        return align_tb_batch_cuda(q, qlen, t, tlen, W=self.W)

    def _align_batches(self, tasks):
        """Queue K2 + K3 over every task, length-bucketed on the ladder and
        length-sorted within a bucket; yields (task indices, (best_i,
        best_j, best_d, packed moves, bases)) per batch, on the device."""
        buckets = {}
        for idx, (qc, tc) in enumerate(tasks):
            m = max(len(qc), len(tc), 1)
            L = next(r for r in DeviceExtender.LADDER if m <= r)
            buckets.setdefault(L, []).append(idx)
        for L in sorted(buckets):
            idxs = sorted(buckets[L],
                          key=lambda i: len(tasks[i][0]) + len(tasks[i][1]))
            B = self._batch_for(L)
            for ofs in range(0, len(idxs), B):
                chunk = idxs[ofs:ofs + B]
                packed = [torch.from_numpy(a).to(self.device) for a in
                          pack_tasks(tasks, chunk, len(chunk), L)]
                q, t = gather_pad2(*packed, L, 4, 5)
                yield chunk, self._align_tb(q, packed[2], t, packed[4])

    def dispatch_tasks(self, tasks):
        """Queue every task batch on the device without waiting.

        tasks: [(q_codes, t_codes)].  Returns the in-flight list for
        collect_tasks: (task indices, (best_d, packed moves)) per batch,
        the device tensors kept referenced until they are copied back."""
        t0 = time.time()
        inflight = [(chunk, (outs[2], outs[3]))
                    for chunk, outs in self._align_batches(tasks)]
        LOG.info("cns.device: dispatched %d aln tasks, %d batches in %.1fs",
                 len(tasks), len(inflight), time.time() - t0)
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

    def consensus_chunk(self, chunk, cfg):
        """chunk: [(seed_id, seed_seq, sups)] from gate_group_ranged.
        Returns [(seed_id, consensus_str)]."""
        if self.use_dp:
            return self.finish_chunk_dp(self.dispatch_chunk_dp(chunk, cfg))
        return self.finish_chunk(self.dispatch_chunk(chunk, cfg))

    # -- device-DP path: tags, scan and walk on the device ----------------
    def _dp_group_cap(self, T):
        """Groups per DP batch under dp_budget bytes of device memory.

        Per group: the uint16 counts, 2 * T * (5*NPC0 + (D-1)*5*NPCD)
        bytes (940 T at D = 14); K5's pred plane, D*5 T bytes, and
        coverage, 4 T; K6's emitted row, 2 T.  The port pads no trailing
        dim and transposes nothing (K5 reads the counts where K4 wrote
        them), unlike falcon_tpu's TPU model.  At D = 14: 1016 T bytes,
        90 groups at T = 32768 under the 3e9 default."""
        D = self.dp_delta_cap
        per_group = T * (2 * (5 * cns_dp.NPC0 + (D - 1) * 5 * cns_dp.NPCD)
                         + D * 5 + 4 + 2)
        return max(4, int(self.dp_budget // per_group))

    def _dispatch_dp_batch(self, chunk, sub, G, T, cfg):
        """One DP batch, queued on the device: self tags, the groups'
        alignments (K2 + K3) folded into the counts (K4), the scan (K5)
        and the walk (K6).  sub: indices into chunk (len <= G; the padded
        groups stay empty).  Returns (sub, emitted rows, counts, number of
        alignment tasks, CUDA event after the walk or None)."""
        D = self.dp_delta_cap
        dev = self.device
        seeds = np.full((G, T), 4, np.int8)
        tlens = np.zeros(G, np.int32)
        tasks, gidx, s2s = [], [], []
        for g, ci in enumerate(sub):
            _, seed_seq, sups = chunk[ci]
            sc = seq_to_codes(seed_seq)
            seeds[g, :len(sc)] = np.minimum(sc, 4)
            tlens[g] = len(sc)
            for sup, rng, is_self in sups:
                if is_self:
                    continue     # add_self_tags covers the seed exactly
                if rng is None:
                    rng = self._host_range(sup, seed_seq, cfg)
                    if rng is None:
                        continue
                rng = _clamp_range(rng, len(sup), len(seed_seq))
                if not _range_ok(rng):
                    continue
                s1, e1, s2, e2 = rng
                tasks.append((seq_to_codes(sup)[s1:e1], sc[s2:e2]))
                gidx.append(g)
                s2s.append(s2)
        msa = cns_dp.alloc_msa(G, T, D, dev)
        cns_dp.add_self_tags(msa, torch.from_numpy(seeds).to(dev),
                             torch.from_numpy(tlens).to(dev), T)
        max_diff = np.float32(1.0 - cfg.min_idt)
        gidx = np.asarray(gidx, np.int32)
        s2s = np.asarray(s2s, np.int32)
        for rows, (_, _, bd, mvp, bases) in self._align_batches(tasks):
            dpk.accumulate_tags_planes_cuda(
                msa, mvp, bases, bd, torch.from_numpy(gidx[rows]).to(dev),
                torch.from_numpy(s2s[rows]).to(dev), max_diff, T, D)
        scan = dpk.consensus_scan_cuda(msa, G, T, D)
        out, counts = dpk.backtrack_walk_cuda(*scan, int(cfg.min_cov), G, T,
                                              D)
        done = None
        if dev.type == "cuda":
            done = torch.cuda.Event()
            done.record()
        self.dp_batches[T] += 1
        return sub, out, counts, len(tasks), done

    def dispatch_chunk_dp(self, chunk, cfg):
        """Queue one chunk of gated groups through the device-DP path:
        groups bucketed by T = max(1024, next power of two of the seed
        length), G padded to a power of two in [8, _dp_group_cap(T)].
        Returns the state for finish_chunk_dp."""
        t0 = time.time()
        buckets = {}
        for ci, (_, seed_seq, _) in enumerate(chunk):
            T = max(1024, 1 << int(np.ceil(np.log2(max(len(seed_seq), 2)))))
            buckets.setdefault(T, []).append(ci)
        batches = []
        n_tasks = 0
        for T in sorted(buckets):
            cis = buckets[T]
            Gmax = self._dp_group_cap(T)
            for ofs in range(0, len(cis), Gmax):
                sub = cis[ofs:ofs + Gmax]
                G = min(Gmax, max(8, 1 << int(np.ceil(np.log2(
                    max(len(sub), 2))))))
                st = self._dispatch_dp_batch(chunk, sub, G, T, cfg)
                n_tasks += st[3]
                batches.append(st)
                # bound the batches in flight: wait for the walk of the
                # batch before last before queueing more
                if len(batches) > 2 and batches[-3][4] is not None:
                    batches[-3][4].synchronize()
        LOG.info("cns.device-dp: chunk of %d groups -> %d DP batches "
                 "(%d aln tasks, T buckets %s) dispatched in %.1fs",
                 len(chunk), len(batches), n_tasks, sorted(buckets),
                 time.time() - t0)
        return chunk, batches

    def finish_chunk_dp(self, state):
        """Copy back each DP batch's emitted codes and decode them.
        Returns [(seed_id, consensus_str)] in chunk order."""
        chunk, batches = state
        t0 = time.time()
        out = [None] * len(chunk)
        for sub, rows, counts, _, _ in batches:
            rows = rows.cpu().numpy()
            counts = counts.cpu().numpy()
            for g, ci in enumerate(sub):
                out[ci] = (chunk[ci][0],
                           cns_dp.assemble_compacted(rows[g], counts[g]))
        LOG.info("cns.device-dp: collected %d groups in %.1fs", len(chunk),
                 time.time() - t0)
        return out


def run_consensus_device(groups, cfg, out, dev=None, progress_cb=None):
    """Drop-in for cns.runner.run_consensus on the device path.

    groups: iterable of (seed_id, [(read_id, seq, rng), ...]), seed first.
    Writes pread FASTA to `out`; returns the number of sequences emitted.
    progress_cb(k) runs after each chunk's output is written, with k the
    number of input groups fully processed (emission order is dispatch
    order), as in falcon_tpu."""
    dev = dev or DeviceCns()
    if dev.use_dp:
        dispatch_chunk, finish_chunk = dev.dispatch_chunk_dp, \
            dev.finish_chunk_dp
    else:
        dispatch_chunk, finish_chunk = dev.dispatch_chunk, dev.finish_chunk
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
        for seed_id, cns in finish_chunk(state):
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
            state = dispatch_chunk(chunk, cfg)
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
