"""Device consensus (port of falcon_tpu/cns/device.py).

Two paths, chosen as in falcon_tpu (use_dp; FTPU_CNS_DP=1 selects the
device-DP path and another value the host-MSA path; unset, the device-DP
path runs when this process is one of several of a torch.distributed
group, the host-MSA path otherwise):

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
its namesake.  The host halves are copies of falcon_tpu/cns/device.py's:
the group gates (gate_group_ranged, _clamp_range, _range_ok), the code
conversions, and the methods dispatch_chunk, finish_chunk, _msa and
_host_range.
"""
import collections
import logging
import os
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from ..ops import cns_dp
from ..ops import cns_dp_cuda as dpk
from ..ops import consensus_dp
from ..ops import native
from ..ops.align_device import DeviceExtender, gather_pad2, pack_tasks
from ..ops.align_tb import moves_to_alignment, unpack_moves
from ..ops.align_tb_cuda import (align_tb_batch_cuda, kernel_for,
                                 trace_row_bytes)
from ..utils import trace
from ..utils.device import resolve_device
from . import runner

LOG = logging.getLogger(__name__)

MAX_SEQ_LEN = 100000  # reference clip (consensus.py:178)

_CODE = np.full(256, 4, dtype=np.uint8)
for _i, _c in enumerate(b"ACGT"):
    _CODE[_c] = _i
    _CODE[ord(chr(_c).lower())] = _i


def seq_to_codes(seq):
    if isinstance(seq, np.ndarray):
        return seq
    return _CODE[np.frombuffer(seq.encode() if isinstance(seq, str)
                               else seq, dtype=np.uint8)]


_A = np.frombuffer(b"ACGT", dtype=np.uint8)


def seq_to_ascii(seq):
    """bytes of the sequence; accepts str or uint8 code arrays (group
    items carry raw ReadStore codes to avoid a decode+re-encode round
    trip per support)."""
    if isinstance(seq, np.ndarray):
        return _A[np.minimum(seq, 3)].tobytes()
    return seq.encode() if isinstance(seq, str) else bytes(seq)


def gate_group_ranged(seed_id, items, cfg):
    """The get_seq_data gates (reference consensus.py:161-209) over
    (read_id, seq, rng) items, keeping each support's alignment range.

    items: seed first; rng = (s1, e1, s2, e2) in (support, seed)
    coordinates on the seed's strand, or None (seed / unknown).
    Returns (seed_seq, [(seq, rng, is_seed_self), ...]) or None."""
    sups = []
    seed_seq = None
    seed_len = 0
    read_ids = set()
    read_cov = 0
    for read_id, seq, rng in items:
        if len(seq) > MAX_SEQ_LEN:
            seq = seq[:MAX_SEQ_LEN - 1]
            rng = None if rng is None else (
                min(rng[0], len(seq)), min(rng[1], len(seq)),
                rng[2], rng[3])
        if len(seq) < cfg.min_len_aln:
            continue
        if seed_seq is None:
            seed_seq = seq
            seed_len = len(seq)
        if read_id not in read_ids:
            sups.append((seq, rng, read_id == items[0][0]))
            read_ids.add(read_id)
            read_cov += len(seq)
    if seed_seq is None:
        return None
    if len(sups) + 1 < cfg.min_n_read or \
            read_cov // seed_len < cfg.min_cov_aln:
        return None
    # get_longest_reads (consensus.py:26-45): sort supports by length desc,
    # cap by count and by coverage of the seed
    sups.sort(key=lambda x: -len(x[0]))
    longest_n = cfg.max_n_read - 1
    if cfg.max_cov_aln > 0:
        n = 0
        cov = 0
        for seq, _, _ in sups:
            if cov // seed_len > cfg.max_cov_aln:
                break
            n += 1
            cov += len(seq)
        longest_n = min(n, cfg.max_n_read - 1)
    return seed_seq, sups[:longest_n]


def _clamp_range(rng, sup_len, seed_len):
    s1, e1, s2, e2 = rng
    s1 = max(0, min(s1, sup_len))
    e1 = max(s1, min(e1, sup_len))
    s2 = max(0, min(s2, seed_len))
    e2 = max(s2, min(e2, seed_len))
    return s1, e1, s2, e2


def _range_ok(rng):
    """generate_consensus range gates (falcon.c:605-612)."""
    s1, e1, s2, e2 = rng
    l1 = e1 - s1
    l2 = e2 - s2
    return (l1 >= 100 and l2 >= 100 and
            abs(l1 - l2) <= int(0.5 * 0.10 * (l1 + l2)))


class DeviceCns:
    """Chunked device consensus over gated groups."""

    def __init__(self, W=None, max_cells=None, chunk_tasks=None,
                 moves_budget=None, device=None, use_dp=None,
                 dp_delta_cap=None, dp_budget=None):
        self.device = resolve_device(device)
        on_cpu = self.device.type == "cpu"
        # A batch is bounded three ways.  moves_budget caps the trace
        # between the sweep and the walk: on the card K2's two bits a cell
        # (align_tb_cuda.trace_row_bytes), on the CPU the plain twin's
        # byte-a-cell move planes, 2 * L * W a row, kept in host memory
        # (hence its smaller budget).  max_cells caps rows * L, which
        # sizes the [B, L] gather temporaries.  max_rows is where more rows
        # stop paying on the card: K2 + K3 per row at L = 1024 cost 1.25 us
        # in a launch of 1024 rows, 0.76 us at 4096 and 0.64 us at 16384
        # (NVIDIA H100 80GB HBM3, 700.00 W; tools/tb_compare.py), since 4096
        # warps put eight on every scheduler of the 132 SMs.  The twin pays
        # a Python step per anti-diagonal whatever the batch, and keeps
        # falcon_tpu's 1024.
        self.max_cells = max_cells or ((1 << 20) if on_cpu else (1 << 24))
        self.moves_budget = moves_budget or (
            (1 << 30) if on_cpu else (1 << 31))
        self.max_rows = 1024 if on_cpu else 4096
        # the consensus band (falcon_tpu's validated default, FTPU_CNS_W)
        self.W = W or int(os.environ.get("FTPU_CNS_W", "256"))
        try:
            kernel_for(self.W)   # K2/K3 and the twin take the same bands
        except ValueError as e:
            raise ValueError("the consensus band (FTPU_CNS_W): %s" % e) \
                from None
        # the device-DP path: falcon_tpu's switch and sizes, read with the
        # same meanings.  Unset, FTPU_CNS_DP defaults by the number of
        # processes, not of devices (falcon_tpu's rule): under several the
        # host-MSA stage would run whole on every one of them
        if use_dp is None:
            env = os.environ.get("FTPU_CNS_DP", "")
            if env:
                use_dp = env == "1"
            else:
                dist = torch.distributed
                use_dp = dist.is_available() and dist.is_initialized() and \
                    dist.get_world_size() > 1
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

    def _trace_row_bytes(self, L):
        """Bytes of trace one batch row of padded length L holds between
        the forward sweep and the walk, on this object's device."""
        if self.device.type == "cpu":
            return 2 * L * self.W
        return trace_row_bytes(L, self.W)

    def _batch_for(self, L):
        """Rows per batch: the trace budget, the cell cap and the row cap,
        whichever is smallest.  K2/K3 run a warp per row, so B needs no
        tile rounding."""
        rows = min(self.moves_budget // self._trace_row_bytes(max(L, 1)),
                   self.max_cells // max(L, 1), self.max_rows)
        return max(1, rows)

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
                packed = [trace.to_device(a, self.device) for a in
                          pack_tasks(tasks, chunk, len(chunk), L)]
                with trace.span("cns.launch"):
                    q, t = gather_pad2(*packed, L, 4, 5)
                    out = self._align_tb(q, packed[2], t, packed[4])
                yield chunk, out

    def dispatch_tasks(self, tasks):
        """Queue every task batch on the device without waiting.

        tasks: [(q_codes, t_codes)].  Returns the in-flight list for
        collect_tasks: (task indices, (best_d, packed moves)) per batch,
        the device tensors kept referenced until they are copied back."""
        with trace.span("cns.queue", clock=True) as sp:
            inflight = [(chunk, (outs[2], outs[3]))
                        for chunk, outs in self._align_batches(tasks)]
        LOG.info("cns.device: dispatched %d aln tasks, %d batches in %.1fs",
                 len(tasks), len(inflight), sp.seconds)
        return inflight

    def collect_tasks(self, tasks, inflight):
        """Copy dispatched batches back and rebuild the alignments.
        Returns per-task (dist, n_cols, q_aln, t_aln) (ASCII bytes;
        n_cols == 0 when no alignment)."""
        results = [None] * len(tasks)
        t_host = 0.0
        use_native = native.available()
        with trace.span("cns.collect", clock=True) as sp:
            for chunk, (bd_d, mvp_d) in inflight:
                bd = trace.to_host(bd_d)
                mvp = trace.to_host(mvp_d)
                with trace.span("cns.rebuild", clock=True) as rb:
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
                t_host += rb.seconds
        LOG.info("cns.device: collected %d aln tasks in %.1fs "
                 "(host reconstruct %.1fs)", len(tasks), sp.seconds, t_host)
        return results

    def align_tasks(self, tasks):
        """tasks: [(q_codes, t_codes)] -> [(dist, n_cols, q_aln, t_aln)]."""
        return self.collect_tasks(tasks, self.dispatch_tasks(tasks))

    # -- per-chunk consensus --------------------------------------------------
    def dispatch_chunk(self, chunk, cfg):
        """Build and queue one chunk's alignment tasks (non-blocking).

        chunk: [(seed_id, seed_seq, sups)] from gate_group_ranged.
        Returns an opaque state for finish_chunk."""
        tasks = []
        task_of = []    # (group_idx, sup_idx, s1, s2)
        group_alns = [[] for _ in chunk]  # per group: (order, aln tuple)
        for gi, (seed_id, seed_seq, sups) in enumerate(chunk):
            seed_codes = seq_to_codes(seed_seq)
            for si, (sup, rng, is_self) in enumerate(sups):
                if is_self:
                    # identity alignment, no device work needed
                    ascii_ = seq_to_ascii(seed_seq)
                    group_alns[gi].append((si, (ascii_, ascii_, 0, 0)))
                    continue
                if rng is None:
                    rng = self._host_range(sup, seed_seq, cfg)
                    if rng is None:
                        continue
                rng = _clamp_range(rng, len(sup), len(seed_seq))
                if not _range_ok(rng):
                    continue
                s1, e1, s2, e2 = rng
                tasks.append((seq_to_codes(sup)[s1:e1],
                              seed_codes[s2:e2]))
                task_of.append((gi, si, s1, s2))
        inflight = self.dispatch_tasks(tasks)
        return (chunk, cfg, tasks, task_of, group_alns, inflight)

    def finish_chunk(self, state):
        """Collect one dispatched chunk and run the host MSA/DP.
        Returns [(seed_id, consensus_str)]."""
        chunk, cfg, tasks, task_of, group_alns, inflight = state
        max_diff = 1.0 - cfg.min_idt
        res = self.collect_tasks(tasks, inflight)
        for (gi, si, s1, s2), r in zip(task_of, res):
            dist, ncols, qa, ta = r
            if ncols > 500 and (float(dist) / float(ncols)) < max_diff:
                group_alns[gi].append((si, (qa, ta, s1, s2)))
        import time as _time
        from concurrent.futures import ThreadPoolExecutor
        t_msa = _time.time()

        def one(gi):
            seed_id, seed_seq, sups = chunk[gi]
            alns = [a for _, a in sorted(group_alns[gi], key=lambda x: x[0])]
            if not alns:
                return (seed_id, "")
            return (seed_id, self._msa(len(seed_seq), alns, cfg.min_cov))

        # the native MSA releases the GIL; two workers keep both host
        # cores busy while the device aligns the next chunk
        with ThreadPoolExecutor(2) as tpe:
            out = list(tpe.map(one, range(len(chunk))))
        LOG.info("cns.device: chunk of %d groups: msa %.1fs",
                 len(chunk), _time.time() - t_msa)
        return out

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
        with trace.span("cns.launch"):
            msa = cns_dp.alloc_msa(G, T, D, dev)
        seeds = trace.to_device(seeds, dev)
        tlens = trace.to_device(tlens, dev)
        with trace.span("cns.launch"):
            cns_dp.add_self_tags(msa, seeds, tlens, T)
        max_diff = np.float32(1.0 - cfg.min_idt)
        gidx = np.asarray(gidx, np.int32)
        s2s = np.asarray(s2s, np.int32)
        for rows, (_, _, bd, mvp, bases) in self._align_batches(tasks):
            g = trace.to_device(gidx[rows], dev)
            s2 = trace.to_device(s2s[rows], dev)
            with trace.span("cns.launch"):
                dpk.accumulate_tags_planes_cuda(msa, mvp, bases, bd, g, s2,
                                                max_diff, T, D)
        with trace.span("cns.launch"):
            scan = dpk.consensus_scan_cuda(msa, G, T, D)
            out, counts = dpk.backtrack_walk_cuda(*scan, int(cfg.min_cov), G,
                                                  T, D)
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
        buckets = {}
        batches = []
        n_tasks = 0
        with trace.span("cns.queue", clock=True) as sp:
            for ci, (_, seed_seq, _) in enumerate(chunk):
                T = max(1024, 1 << int(np.ceil(np.log2(max(len(seed_seq),
                                                           2)))))
                buckets.setdefault(T, []).append(ci)
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
                        with trace.span("cns.wait_device"):
                            batches[-3][4].synchronize()
        LOG.info("cns.device-dp: chunk of %d groups -> %d DP batches "
                 "(%d aln tasks, T buckets %s) dispatched in %.1fs",
                 len(chunk), len(batches), n_tasks, sorted(buckets),
                 sp.seconds)
        return chunk, batches

    def finish_chunk_dp(self, state):
        """Copy back each DP batch's emitted codes and decode them.
        Returns [(seed_id, consensus_str)] in chunk order."""
        chunk, batches = state
        out = [None] * len(chunk)
        with trace.span("cns.collect", clock=True) as sp:
            for sub, rows, counts, _, _ in batches:
                rows = trace.to_host(rows)
                counts = trace.to_host(counts)
                with trace.span("cns.rebuild"):
                    for g, ci in enumerate(sub):
                        out[ci] = (chunk[ci][0], cns_dp.assemble_compacted(
                            rows[g], counts[g]))
        LOG.info("cns.device-dp: collected %d groups in %.1fs", len(chunk),
                 sp.seconds)
        return out

    def _msa(self, t_len, alns, min_cov):
        if native.available():
            return native.cns_from_alns(t_len, alns, min_cov)
        tag_seqs = [consensus_dp.get_align_tags(qa, ta, s1, s2, j, 0)
                    for j, (qa, ta, s1, s2) in enumerate(alns)]
        return consensus_dp.get_cns_from_align_tags(tag_seqs, t_len,
                                                    min_cov)

    def _host_range(self, sup, seed, cfg):
        """Range fallback when no overlap coordinates travel with the
        group (stream inputs): host k-mer chain, reference semantics."""
        from ..ops import kmer as _kmer
        if isinstance(seed, np.ndarray):
            seed = seq_to_ascii(seed).decode()
        if isinstance(sup, np.ndarray):
            sup = seq_to_ascii(sup).decode()
        lookup = _kmer.KmerLookup(seed, cfg.K)
        qp, tp = lookup.find_kmer_pos_for_seq(sup)
        if len(qp) == 0:
            return None
        r = _kmer.find_best_aln_range(qp, tp, cfg.K, cfg.K * 6, 5)
        return (r.s1, r.e1, r.s2, r.e2)


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

    def finish(state, mark, key):
        # the one finisher thread writes `out`, in dispatch order; the
        # state holds each batch's device tensors until they are copied
        nonlocal emitted
        if dev.device.type == "cuda":
            torch.cuda.set_device(dev.device)
        with trace.span("cns.finish", key=key) as sp:
            done = finish_chunk(state)
            sp.add(groups=len(done))
        with trace.span("cns.write"):
            for seed_id, cns in done:
                emitted += runner.format_output(cns, seed_id, cfg, out)
            if progress_cb is not None:
                progress_cb(mark)

    # depth-2 software pipeline: the main thread gates groups and queues
    # device batches; the finisher copies back, rebuilds and runs the MSA
    # (the C++ calls release the GIL)
    with trace.span("cns.run", clock=True) as run_sp, \
            ThreadPoolExecutor(1) as finisher:

        def flush():
            nonlocal chunk, n_tasks
            if not chunk:
                return
            key = trace.new_key()
            with trace.span("cns.dispatch", key=key, groups=len(chunk),
                            tasks=n_tasks):
                state = dispatch_chunk(chunk, cfg)
            chunk = []
            n_tasks = 0
            futs.append(finisher.submit(trace.carry(finish), state,
                                        chunk_mark, key))
            while len(futs) > 2:
                with trace.span("cns.wait_finisher"):
                    futs.pop(0).result()

        for seed_id, items in groups:
            n_pulled += 1
            with trace.span("cns.gate"):
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
            with trace.span("cns.wait_finisher"):
                f.result()
    LOG.info("cns.device: total %.1fs", run_sp.seconds)
    return emitted
