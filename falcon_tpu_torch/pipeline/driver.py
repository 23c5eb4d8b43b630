"""Pipeline driver of the port: raw reads -> preads -> string graph ->
contigs + GFA on one GPU (port of falcon_tpu/pipeline/driver.py).

Pipeline subclasses falcon_tpu's driver, whose phases, resume logic and
artifacts it keeps, and replaces only what reaches JAX there:

  __init__        no parallel.distributed (single host), explicit device
  _aligner        the port's make_device_aligner(W=256); no host fallback
  _overlap_store  the single-host block-pair triangle, no all-gather
  phase0          consensus through the port's run_consensus_device
                  (FTPU_CNS_DP=1: the device-DP path; its DP batches per
                  T bucket go into timings as phase0_cns_dp_batches)
  run             FTPU_PROFILE=<dir> maps to torch.profiler; the device's
                  busy time and idle share over the run's total go into
                  timings.json (device_busy)

Usage:  python -m falcon_tpu_torch.pipeline <cfg> [out_dir]
"""
import json
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from falcon_tpu import config as config_mod
from falcon_tpu.cns import runner as cns_runner
from falcon_tpu.io import fasta, integrity, readstore
from falcon_tpu.ops import native as native_ops
from falcon_tpu.overlap import engine
from falcon_tpu.overlap import table as otable
from falcon_tpu.parallel.distributed import host_block_pairs
from falcon_tpu.pipeline import driver as ref
from falcon_tpu.pipeline import stats as stats_mod
from falcon_tpu.utils import system

from ..cns.device import DeviceCns, run_consensus_device
from ..overlap.engine import make_device_aligner
from ..utils.device import resolve_device

LOG = logging.getLogger(__name__)

AVIEW_LRU = 4


class Pipeline(ref.Pipeline):
    def __init__(self, cfg_path, out_dir=".", device=None):
        self.device = resolve_device(device)
        self.cfg = config_mod.parse_cfg_file(cfg_path)
        self.p = config_mod.StageParams(self.cfg)
        self.out_dir = os.path.abspath(out_dir)
        self.dir0 = os.path.join(self.out_dir, "0-rawreads")
        self.dir1 = os.path.join(self.out_dir, "1-preads_ovl")
        self.dir2 = os.path.join(self.out_dir, "2-asm-falcon")
        for d in (self.dir0, self.dir1, self.dir2):
            os.makedirs(d, exist_ok=True)
        self.timings = {}
        system.set_heartbeat_dir(self.out_dir)

    def _aligner(self):
        """The device extension path (K1); None when the cfg turns the
        device off (use_device = false), which selects the host aligner
        as in falcon_tpu."""
        if not self.p.use_device:
            return None
        # W is the extension DP's band (drift tolerance W/2), not the
        # greedy band_tolerance
        return make_device_aligner(W=256, device=self.device)

    def _overlap_store(self, store, params, tag, ckpt_dir=None):
        """All-vs-all overlap over the store's block-pair triangle on this
        host; returns the symmetric columnar overlap table.  Pairs are
        walked grouped by B block (its k-mer tables are built once) with
        the A blocks snaked, per-pair checkpoints make the phase
        resumable, and the host chain of pair n+1 runs under the device
        alignment of pair n -- all as in falcon_tpu."""
        blocks = store.blocks or store.split_blocks()
        aligner = self._aligner()
        pairs = sorted(host_block_pairs(len(blocks), 0, 1),
                       key=lambda ij: (ij[1], ij[0]))
        stripes = []
        for pr in pairs:
            if not stripes or pr[1] != stripes[-1][-1][1]:
                stripes.append([])
            stripes[-1].append(pr)
        pairs = [pr for si, st in enumerate(stripes)
                 for pr in (st if si % 2 == 0 else reversed(st))]
        pair_dir = os.path.join(ckpt_dir, tag + "_pairs") if ckpt_dir \
            else None
        if pair_dir:
            os.makedirs(pair_dir, exist_ok=True)
        results = {}
        todo = []
        for k, (i, j) in enumerate(pairs):
            pf = os.path.join(pair_dir, "p%04d_%04d.npy" % (i, j)) \
                if pair_dir else None
            if pf and os.path.exists(pf):
                results[k] = np.load(pf)
                LOG.info("%s: block (%d,%d) %d/%d: %d overlaps "
                         "(checkpointed)", tag, i, j, k + 1, len(pairs),
                         len(results[k]))
            else:
                todo.append((k, i, j, pf))

        prep = {"j": -1, "index": None, "aviews": {}}

        def prepare(i, j):
            if j != prep["j"]:
                prep["index"] = None
                prep["index"] = engine.BlockIndex(
                    store, blocks[j], params,
                    build_tables=not native_ops.available())
                prep["j"] = j
            aviews = prep["aviews"]
            if i not in aviews:
                if len(aviews) >= AVIEW_LRU:
                    aviews.pop(next(iter(aviews)))
                aviews[i] = engine.AView(store, blocks[i], params)
            else:
                aviews[i] = aviews.pop(i)
            cands, idx, (t_index, t_chain) = engine.chain_blocks(
                store, blocks[i], blocks[j], params, same_block=(i == j),
                index=prep["index"], a_view=aviews[i])
            return cands, idx, t_index, t_chain

        prefetch = aligner is not None and \
            os.environ.get("FTPU_PIPELINE_CHAIN", "1") != "0"
        with ThreadPoolExecutor(1) as prep_exec:
            fut = None
            for n, (k, i, j, pf) in enumerate(todo):
                t0 = time.time()
                if fut is None:
                    fut = prep_exec.submit(prepare, i, j)
                cands, idx, t_index, t_chain = fut.result()
                fut = None
                if prefetch and n + 1 < len(todo):
                    fut = prep_exec.submit(prepare, todo[n + 1][1],
                                           todo[n + 1][2])
                t1 = time.time()
                ovls = engine.align_candidates(store, idx, blocks[i], cands,
                                               params, aligner)
                results[k] = ovls
                LOG.info("%s: block (%d,%d) %d/%d: %d cands -> %d "
                         "overlaps; index %.1fs chain %.1fs align %.1fs "
                         "(pair wall %.1fs)", tag, i, j, k + 1, len(pairs),
                         len(cands), len(ovls), t_index, t_chain,
                         time.time() - t1, time.time() - t0)
                if pf:
                    np.save(pf + ".tmp.npy", ovls)
                    os.replace(pf + ".tmp.npy", pf)
                    system.touch_heartbeat(self.out_dir)
                    system.maybe_recycle(self.out_dir, tag + " overlap")
        prep.clear()
        tbl = otable.concat([results[k] for k in range(len(pairs))])
        occ = aligner.ext.occupancy() if aligner is not None else None
        if occ:
            self.timings["%s_occupancy" % tag] = round(occ, 4)
        return engine.emit_symmetric(tbl)

    def phase0(self):
        preads_fn = os.path.join(self.dir0, "preads.fasta")
        if ref._resumable(preads_fn, "phase0 preads"):
            LOG.info("phase0: %s exists; skipping", preads_fn)
            return preads_fn
        t_start = time.time()
        p = self.p
        system.touch_heartbeat(self.out_dir)

        store_fn = os.path.join(self.dir0, "raw_reads")
        if ref._resumable(store_fn + ".npz", "phase0 readstore"):
            store = readstore.ReadStore.load(store_fn)
        else:
            fofn = self.cfg["input_fofn"]
            paths = fasta.read_fofn(fofn) if fofn.endswith(".fofn") \
                else [fofn]
            store = readstore.ReadStore.from_fasta_files(
                paths, min_len=p.raw_min_len)
            if p.mask_dust or p.mask_tandem:
                t_mask = time.time()
                store.build_masks(dust=p.mask_dust, tandem=p.mask_tandem)
                self.timings["phase0_masking"] = time.time() - t_mask
            store.split_blocks(int(p.raw_block_mb * 1e6))
            store.save(store_fn)
            integrity.write_sidecar(store_fn + ".npz", rows=len(store))
            system.touch_heartbeat(self.out_dir)
        LOG.info("phase0: %d raw reads, %d bases, %d blocks",
                 len(store), store.total_bases, len(store.blocks))

        if p.length_cutoff >= 0:
            cutoff = p.length_cutoff
        else:
            cutoff = store.calc_length_cutoff(p.seed_coverage, p.genome_size)
        LOG.info("phase0: seed length cutoff %d", cutoff)
        with open(os.path.join(self.dir0, "length_cutoff"), "w") as f:
            f.write(str(cutoff) + "\n")

        ovl_fn = os.path.join(self.dir0, "raw_overlaps.ovl")
        if ref._resumable(ovl_fn, "phase0 overlap table"):
            LOG.info("phase0: %s exists; skipping overlap", ovl_fn)
            recs = otable.read_table(ovl_fn)
            self.timings["phase0_overlap"] = 0.0
        else:
            recs = self._overlap_store(store, self._engine_params(0),
                                       "phase0", ckpt_dir=self.dir0)
            self.timings["phase0_overlap"] = time.time() - t_start
            otable.write_table(ovl_fn + ".tmp", recs, terminator=True)
            os.rename(ovl_fn + ".tmp", ovl_fn)
            integrity.write_sidecar(ovl_fn, rows=len(recs))
            self._drop_pair_ckpts(self.dir0, "phase0")
        if p.target == "overlapping":
            LOG.info("phase0: target=overlapping; stopping after overlap")
            return None

        t_cns = time.time()
        ccfg = cns_runner.ConsensusConfig.from_option_string(
            p.falcon_sense_option)
        n_core = ccfg.n_core if ccfg.n_core is not None else \
            (p.cns_nproc or os.cpu_count() or 1)
        # --trim pre-aligns each support on the host, so it keeps the host
        # runner (as in falcon_tpu)
        use_dev_cns = (p.use_device and not ccfg.trim and
                       os.environ.get("FTPU_CNS_DEVICE", "1") != "0")

        # resume past the groups a previous run wrote durably
        prog_fn = preads_fn + ".progress"
        done_groups = 0
        out_mode = "w"
        if os.path.exists(prog_fn) and os.path.exists(preads_fn + ".tmp"):
            try:
                parts = open(prog_fn).read().split()
                done_groups, good_bytes = int(parts[0]), int(parts[1])
                with open(preads_fn + ".tmp", "r+") as tf:
                    tf.truncate(good_bytes)
                out_mode = "a"
                LOG.info("phase0: resuming consensus past %d finished "
                         "groups (%d bytes kept)", done_groups, good_bytes)
            except (ValueError, IndexError, OSError):
                done_groups = 0

        def groups(skip=0):
            a_ids = recs["a_id"]
            if len(recs) == 0:
                return
            starts = np.flatnonzero(
                np.r_[True, a_ids[1:] != a_ids[:-1]]).tolist()
            starts.append(len(recs))
            live_idx = 0
            for gi in range(len(starts) - 1):
                rows = recs[starts[gi]:starts[gi + 1]]
                if store.lengths[int(rows["a_id"][0])] < cutoff:
                    continue
                live_idx += 1
                if live_idx <= skip:
                    continue
                yield self._make_group(store, rows, cutoff,
                                       as_codes=use_dev_cns)

        with open(preads_fn + ".tmp", out_mode) as out_f:

            def save_progress(k):
                out_f.flush()
                with open(prog_fn + ".tmp", "w") as pf:
                    pf.write("%d %d" % (done_groups + k, out_f.tell()))
                os.replace(prog_fn + ".tmp", prog_fn)
                system.touch_heartbeat(self.out_dir)
                system.maybe_recycle(self.out_dir, "phase0 consensus")

            live = (g for g in groups(done_groups) if g is not None)
            if use_dev_cns:
                dev = DeviceCns(device=self.device)
                LOG.info("phase0: device consensus (falcon_tpu_torch), %s "
                         "path", "device-DP" if dev.use_dp else "host-MSA")
                emitted = run_consensus_device(
                    live, ccfg, out_f, dev=dev, progress_cb=save_progress)
                if dev.use_dp:
                    self.timings["phase0_cns_dp_batches"] = dict(
                        sorted(dev.dp_batches.items()))
            else:
                emitted = cns_runner.run_consensus(
                    ((sid, [(rid, seq) for rid, seq, _ in items])
                     for sid, items in live), ccfg, out_f,
                    n_core=n_core, progress_cb=save_progress)
        os.rename(preads_fn + ".tmp", preads_fn)
        if os.path.exists(prog_fn):
            os.unlink(prog_fn)
        integrity.write_sidecar(preads_fn, rows=emitted)
        self.timings["phase0_consensus"] = time.time() - t_cns
        LOG.info("phase0: %d pread sequences -> %s", emitted, preads_fn)

        try:
            report = stats_mod.preassembly_report(
                store, preads_fn, cutoff, p.genome_size)
            with open(os.path.join(self.dir0, "pre_assembly_stats.json"),
                      "w") as f:
                json.dump(report, f, indent=2)
        except Exception:
            LOG.exception("phase0: stats report failed (non-fatal)")
        return preads_fn

    def run(self):
        profile_dir = os.environ.get("FTPU_PROFILE", "")
        if not profile_dir:
            return self._run()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        LOG.info("profiling to %s", profile_dir)
        with torch.profiler.profile(activities=acts) as prof:
            p_ctg = self._run()
        trace_fn = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(trace_fn)
        busy, by_name = device_busy(trace_fn)
        self.timings["device_busy_s"] = busy
        self.timings["device_idle_share"] = 1 - busy / self.timings["total"]
        with open(os.path.join(self.out_dir, "timings.json"), "w") as f:
            json.dump(self.timings, f, indent=2, sort_keys=True)
        with open(os.path.join(profile_dir, "device_time.json"), "w") as f:
            json.dump(by_name, f, indent=2)
        LOG.info("device busy %.3fs of %.3fs (idle share %.4f)", busy,
                 self.timings["total"], self.timings["device_idle_share"])
        return p_ctg

    def _run(self):
        t0 = time.time()
        p = self.p
        if p.input_type == "preads":
            # stage 0 skipped: the input FASTAs are the preads
            if p.target == "pre-assembly":
                LOG.info("target=pre-assembly; nothing to do for "
                         "input_type=preads")
                p_ctg = None
            else:
                fofn = self.cfg["input_fofn"]
                paths = fasta.read_fofn(fofn) if fofn.endswith(".fofn") \
                    else [fofn]
                p_ctg = self.phase2(self.phase1(paths))
        else:
            preads = self.phase0()
            if preads is None or p.target == "pre-assembly":
                p_ctg = preads
            else:
                p_ctg = self.phase2(self.phase1(preads))
        self.timings["total"] = time.time() - t0
        with open(os.path.join(self.out_dir, "timings.json"), "w") as f:
            json.dump(self.timings, f, indent=2, sort_keys=True)
        LOG.info("pipeline done in %.1fs -> %s", self.timings["total"],
                 p_ctg)
        return p_ctg


DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


def device_busy(trace_fn):
    """Device time of a torch.profiler chrome trace: (busy seconds, the
    union of every kernel, memcpy and memset interval, so overlapping
    streams count once; {name: [count, summed seconds]}, largest first)."""
    with open(trace_fn) as f:
        events = [e for e in json.load(f)["traceEvents"]
                  if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    by_name = {}
    for e in events:
        n = by_name.setdefault(e["name"], [0, 0.0])
        n[0] += 1
        n[1] += e["dur"] / 1e6
    busy = 0.0
    end = float("-inf")
    for t0, dur in sorted((e["ts"], e["dur"]) for e in events):
        start = max(t0, end)
        end = max(end, t0 + dur)
        busy += max(0.0, end - start)
    return busy / 1e6, dict(sorted(by_name.items(),
                                   key=lambda kv: -kv[1][1]))


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    if not argv:
        print("usage: python -m falcon_tpu_torch.pipeline <cfg> "
              "[logger.json|out_dir]", file=sys.stderr)
        return 2
    out_dir = "."
    logger_cfg = None
    if len(argv) > 1:
        if argv[1].endswith((".json", ".ini")) and os.path.isfile(argv[1]):
            logger_cfg = argv[1]
        else:
            out_dir = argv[1]
    ref.setup_logging(logger_cfg)
    Pipeline(argv[0], out_dir).run()
    return 0
