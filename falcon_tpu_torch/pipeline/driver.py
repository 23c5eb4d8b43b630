"""Pipeline driver of the port: raw reads -> preads -> string graph ->
contigs + GFA on GPUs (port of falcon_tpu/pipeline/driver.py).

Pipeline keeps falcon_tpu's phases, resume logic and artifact writers
(_engine_params, _make_group, phase1, phase2 and the helpers are copies of
falcon_tpu/pipeline/driver.py's) and differs where that driver reaches
JAX:

  __init__        joins the torch.distributed group (gloo) when
                  FTPU_COORDINATOR_ADDRESS is set
                  (parallel.distributed.init_distributed); an explicit
                  device; use_device= overrides the cfg
  _aligner        the port's make_device_aligner(W=256), whose extender
                  shards every batch over all visible GPUs when the
                  device is a bare "cuda", else runs on the named device
                  (parallel.mesh.extender_mesh); no host fallback
  _overlap_store  this process's stripe of the block-pair triangle, then
                  one all-gather of the table when there are several
                  processes (parallel.distributed)
  phase0          consensus through the port's run_consensus_device
                  (the device-DP path when FTPU_CNS_DP=1, or when it is
                  unset and the run has several processes; its DP batches
                  per T bucket go into timings as phase0_cns_dp_batches)
  run             FTPU_PROFILE=<dir> maps to torch.profiler; the device's
                  busy time and idle share over the run's total go into
                  timings.json (device_busy)

Consensus and the graph are replicated: every process runs them whole on
the gathered table and writes the same artifacts into its own out_dir.
Under several processes the host consensus runner (use_device = false,
--trim, or FTPU_CNS_DEVICE=0) must run with --n-core 0 in
falcon_sense_option: it otherwise forks a worker pool, and a fork of a
process that holds a gloo group can deadlock (falcon_tpu's rule,
tests/test_multiprocess.py).  The device consensus uses threads only.

Usage:  python -m falcon_tpu_torch.pipeline <cfg> [out_dir]
        (several processes: the same command in each, with
        FTPU_COORDINATOR_ADDRESS=<host:port> FTPU_NUM_PROCESSES=<n>
        FTPU_PROCESS_ID=<0..n-1>)
"""
import json
import logging
import os
import sys
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

from .. import config as config_mod
from ..cns import runner as cns_runner
from ..cns.device import DeviceCns, run_consensus_device
from ..graph import to_contig, unitigs
from ..graph.collect_gfa import collect_contig_gfa, collect_pread_gfa
from ..graph.gfa import deserialize_gfa
from ..io import fasta, integrity, readstore
from ..ops import native as native_ops
from ..overlap import engine, filter as ofilter
from ..overlap import table as otable
from ..parallel import distributed
from ..utils import system, trace
from ..utils.device import resolve_device
from . import stats as stats_mod

LOG = logging.getLogger(__name__)

AVIEW_LRU = 4


def _done(path):
    return os.path.exists(path)


def _resumable(path, what):
    """Artifact-presence resume + integrity gate (the LAcheck analog,
    io.integrity): present AND not failing its sidecar check."""
    return os.path.exists(path) and integrity.check_resume(path, what)


class Pipeline:
    def __init__(self, cfg_path, out_dir=".", device=None, use_device=None):
        if distributed.want_distributed():
            distributed.init_distributed()
        self.device = resolve_device(device)
        # as asked: a bare "cuda" lets the extender take every GPU
        self.device_request = device
        self.cfg = config_mod.parse_cfg_file(cfg_path)
        self.p = config_mod.StageParams(self.cfg)
        if use_device is not None:
            self.p.use_device = use_device
        self.out_dir = os.path.abspath(out_dir)
        self.dir0 = os.path.join(self.out_dir, "0-rawreads")
        self.dir1 = os.path.join(self.out_dir, "1-preads_ovl")
        self.dir2 = os.path.join(self.out_dir, "2-asm-falcon")
        for d in (self.dir0, self.dir1, self.dir2):
            os.makedirs(d, exist_ok=True)
        self.timings = {}
        self.mesh = None     # the device extender's, once it is built
        system.set_heartbeat_dir(self.out_dir)

    # -- helpers -----------------------------------------------------------
    def _engine_params(self, stage):
        p = self.p
        if stage == 0:
            return engine.OverlapParams(
                k=p.overlap_k, min_hits=p.overlap_min_hits,
                band_tolerance=p.overlap_band, stride=p.overlap_stride,
                min_overlap=p.raw_ovl_minlen, min_idt=p.raw_ovl_idt)
        # preads are ~99.9%% identical: sparse seeding suffices
        return engine.OverlapParams(
            k=p.overlap_k, min_hits=p.overlap_min_hits,
            band_tolerance=p.overlap_band, stride=p.overlap_stride_pr,
            min_overlap=p.pr_ovl_minlen, min_idt=p.pr_ovl_idt)

    def _aligner(self):
        """The device extension path (K1); None when the cfg turns the
        device off (use_device = false), which selects the host aligner
        as in falcon_tpu."""
        if not self.p.use_device:
            return None
        # W is the extension DP's band (drift tolerance W/2), not the
        # greedy band_tolerance
        return engine.make_device_aligner(W=256,
                                          device=self.device_request)

    def _overlap_store(self, store, params, tag, ckpt_dir=None):
        """All-vs-all overlap over this process's stripe of the store's
        block-pair triangle; returns the symmetric columnar overlap table,
        gathered from every process when there are several (one raw-byte
        all-gather; emit_symmetric's canonical sort makes it equal to a
        single process's).  Pairs are walked grouped by B block (its k-mer
        tables are built once) with the A blocks snaked, per-pair
        checkpoints make the phase resumable, and the host chain of pair
        n+1 runs under the device alignment of pair n -- all as in
        falcon_tpu."""
        blocks = store.blocks or store.split_blocks()
        aligner = self._aligner()
        if aligner is not None:
            self.mesh = aligner.ext.mesh
        host_id, n_hosts = distributed.init_distributed()
        pairs = sorted(distributed.host_block_pairs(len(blocks), host_id,
                                                    n_hosts),
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

        def prepare(key, i, j):
            with trace.span("overlap.chain", key=key) as sp:
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
                sp.add(candidates=len(cands))
            return cands, idx, t_index, t_chain

        prefetch = aligner is not None and \
            os.environ.get("FTPU_PIPELINE_CHAIN", "1") != "0"
        # a key a block pair: its chain (on the prefetch thread) and its
        # alignment share it
        keys = [trace.new_key() for _ in todo]
        with ThreadPoolExecutor(1) as prep_exec:
            fut = None
            for n, (k, i, j, pf) in enumerate(todo):
                if fut is None:
                    fut = prep_exec.submit(trace.carry(prepare), keys[n], i,
                                           j)
                with trace.span("overlap.wait_chain", key=keys[n],
                                clock=True) as waited:
                    cands, idx, t_index, t_chain = fut.result()
                fut = None
                if prefetch and n + 1 < len(todo):
                    fut = prep_exec.submit(trace.carry(prepare),
                                           keys[n + 1], todo[n + 1][1],
                                           todo[n + 1][2])
                with trace.span("overlap.align", key=keys[n],
                                clock=True) as aligned:
                    ovls = engine.align_candidates(store, idx, blocks[i],
                                                   cands, params, aligner)
                    aligned.add(records=len(ovls))
                results[k] = ovls
                LOG.info("%s: block (%d,%d) %d/%d: %d cands -> %d "
                         "overlaps; index %.1fs chain %.1fs align %.1fs "
                         "(pair wall %.1fs)", tag, i, j, k + 1, len(pairs),
                         len(cands), len(ovls), t_index, t_chain,
                         aligned.seconds, waited.seconds + aligned.seconds)
                if pf:
                    with trace.span("overlap.checkpoint"):
                        np.save(pf + ".tmp.npy", ovls)
                        os.replace(pf + ".tmp.npy", pf)
                        system.touch_heartbeat(self.out_dir)
                        system.maybe_recycle(self.out_dir, tag + " overlap")
        prep.clear()
        with trace.span("overlap.table") as sp:
            tbl = otable.concat([results[k] for k in range(len(pairs))])
            occ = aligner.ext.occupancy() if aligner is not None else None
            if occ:
                self.timings["%s_occupancy" % tag] = round(occ, 4)
            if n_hosts > 1:
                tbl = distributed.allgather_table(tbl)
            tbl = engine.emit_symmetric(tbl)
            sp.add(rows=len(tbl))
        return tbl

    @staticmethod
    def _drop_pair_ckpts(ckpt_dir, tag):
        """Per-pair checkpoints are subsumed by the phase's final table;
        drop them once that table is durable."""
        import shutil
        d = os.path.join(ckpt_dir, tag + "_pairs")
        if os.path.isdir(d):
            shutil.rmtree(d, ignore_errors=True)

    # -- phase 0: raw reads -> preads --------------------------------------
    def phase0(self):
        preads_fn = os.path.join(self.dir0, "preads.fasta")
        if _resumable(preads_fn, "phase0 preads"):
            LOG.info("phase0: %s exists; skipping", preads_fn)
            return preads_fn
        t_start = time.time()
        p = self.p
        system.touch_heartbeat(self.out_dir)

        store_fn = os.path.join(self.dir0, "raw_reads")
        with trace.span("pipeline.store") as sp:
            if _resumable(store_fn + ".npz", "phase0 readstore"):
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
            sp.add(reads=len(store), bases=store.total_bases)
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
        if _resumable(ovl_fn, "phase0 overlap table"):
            LOG.info("phase0: %s exists; skipping overlap", ovl_fn)
            recs = otable.read_table(ovl_fn)
            self.timings["phase0_overlap"] = 0.0
        else:
            recs = self._overlap_store(store, self._engine_params(0),
                                       "phase0", ckpt_dir=self.dir0)
            self.timings["phase0_overlap"] = time.time() - t_start
            with trace.span("overlap.table", rows=len(recs)):
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
                with trace.span("pipeline.make_group") as sp:
                    group = self._make_group(store, rows, cutoff,
                                             as_codes=use_dev_cns)
                    sp.add(supports=len(group[1]) - 1 if group else 0)
                yield group

        with open(preads_fn + ".tmp", out_mode) as out_f:

            def save_progress(k):
                out_f.flush()
                with open(prog_fn + ".tmp", "w") as pf:
                    pf.write("%d %d" % (done_groups + k, out_f.tell()))
                os.replace(prog_fn + ".tmp", prog_fn)
                system.touch_heartbeat(self.out_dir)
                # a marker with no group of this run is no point to recycle
                # at: the host runner calls it once more at its end, so a
                # driver restarted there with nothing left would exit again
                # at once, without end (falcon_tpu's driver does so)
                if k:
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
            with trace.span("pipeline.stats"):
                report = stats_mod.preassembly_report(
                    store, preads_fn, cutoff, p.genome_size)
                with open(os.path.join(self.dir0,
                                       "pre_assembly_stats.json"), "w") as f:
                    json.dump(report, f, indent=2)
        except Exception:
            LOG.exception("phase0: stats report failed (non-fatal)")
        return preads_fn

    def _make_group(self, store, rows, cutoff, as_codes=False):
        """(seed_id, [(read_id, seq, rng), ...]) with the seed first.

        rows: one seed's slice of the columnar overlap table.
        rng = (s1, e1, s2, e2): the support/seed alignment range from the
        overlap record, on the seed's strand (the device consensus path
        reuses these instead of re-seeding; reference fc_consensus gets
        bare sequences over the LA4Falcon pipe and must re-seed).
        as_codes: supports stay uint8 code arrays (the device path
        consumes codes; decoding 10^5..10^6 supports to strings just to
        re-encode them costs tens of seconds at E. coli scale)."""
        rid = int(rows["a_id"][0])
        if store.lengths[rid] < cutoff:
            return None
        seed_id = "%09d" % rid
        seed_seq = store.get_seq(rid)
        out = [(seed_id, seed_seq, None)]
        skip_contained = self.p.skip_contained
        for o in rows:
            if skip_contained and int(o["klass"]) == otable.CONTAINS:
                # falcon_sense_skip_contained: LA4Falcon -s drops supports
                # contained in the seed (reference bash.py:350-351)
                continue
            b_rid = int(o["b_id"])
            codes = store.get_codes(b_rid)
            b_start, b_end = int(o["b_start"]), int(o["b_end"])
            a_start, a_end = int(o["a_start"]), int(o["a_end"])
            if int(o["b_strand"]) == 1:
                codes = readstore.revcomp_codes(codes)
                b_len = int(o["b_len"])
                rng = (b_len - b_end, b_len - b_start, a_start, a_end)
            else:
                rng = (b_start, b_end, a_start, a_end)
            out.append(("%09d" % b_rid, codes if as_codes
                        else readstore.decode_seq(codes), rng))
        return seed_id, out

    # -- phase 1: pread overlap --------------------------------------------
    def phase1(self, preads_fn):
        """preads_fn: one pread FASTA path (the phase-0 product) or a
        list of paths (input_type=preads: the user's own pread FASTAs
        feed this phase directly, stage 0 skipped -- the working version
        of reference run1.py:485-508's unfinished preads branch)."""
        ovl_fn = os.path.join(self.dir1, "preads.ovl")
        p4f = os.path.join(self.dir2, "preads4falcon.fasta")
        if _resumable(ovl_fn, "phase1 preads.ovl") and \
                _resumable(p4f, "phase1 preads4falcon"):
            LOG.info("phase1: %s exists; skipping", ovl_fn)
            return ovl_fn
        t_start = time.time()
        p = self.p
        system.touch_heartbeat(self.out_dir)

        paths = [preads_fn] if isinstance(preads_fn, str) else \
            list(preads_fn)
        store = readstore.ReadStore.from_fasta_files(
            paths, min_len=p.pr_min_len)
        store.split_blocks(int(p.pr_block_mb * 1e6))
        LOG.info("phase1: %d preads, %d bases", len(store),
                 store.total_bases)
        # renumber preads: DB2Falcon gives dense %09d ids; keep the
        # original (prolog/<seed>) names as the id-dump for read tracking
        orig_names = list(store.names)
        names = ["%09d" % i for i in range(len(store))]
        store.names = names
        with open(os.path.join(self.dir1, "pread_ids"), "w") as f:
            for pid, name in zip(names, orig_names):
                f.write("%s %s\n" % (pid, name))
        fasta.write_fasta(p4f, ((names[i], store.get_seq(i))
                                for i in range(len(store))))
        integrity.write_sidecar(p4f, rows=len(store))

        recs = self._overlap_store(store, self._engine_params(1), "phase1",
                                   ckpt_dir=self.dir1)
        self.timings["phase1_overlap"] = time.time() - t_start

        with open(ovl_fn + ".tmp", "w") as f:
            ofilter.filter_table(
                f, recs, max_diff=p.filt_max_diff,
                max_cov=p.filt_max_cov, min_cov=p.filt_min_cov,
                min_len=p.filt_min_len, bestn=p.filt_bestn)
        os.rename(ovl_fn + ".tmp", ovl_fn)
        integrity.write_sidecar(ovl_fn)
        self._drop_pair_ckpts(self.dir1, "phase1")
        return ovl_fn

    # -- phase 2: assembly --------------------------------------------------
    def phase2(self, ovl_fn):
        d = self.dir2
        p = self.p
        system.touch_heartbeat(self.out_dir)
        if not _done(os.path.join(d, "p_ctg.fa")):
            t0 = time.time()
            local_ovl = os.path.join(d, "preads.ovl")
            if os.path.abspath(ovl_fn) != os.path.abspath(local_ovl):
                import shutil
                shutil.copyfile(ovl_fn, local_ovl)
            unitigs.ovlp_to_graph(local_ovl, d, min_len=p.graph_min_len,
                                  min_idt=p.graph_min_idt, lfc=p.graph_lfc)
            to_contig.run(d)
            to_contig.dedup_a_tigs(d)
            self.timings["phase2_graph"] = time.time() - t0

        # GFA outputs (reference: TASK_RUN_FALCON_ASM_SCRIPT,
        # pype_tasks.py:121-164)
        cwd = os.getcwd()
        os.chdir(d)
        try:
            with open("asm.gfa.json", "w") as f:
                collect_pread_gfa(f)
            with open("sg.gfa.json", "w") as f:
                collect_pread_gfa(f, add_string_graph=True)
            with open("contig.gfa2.json", "w") as f:
                collect_contig_gfa(f)
            with open("asm.gfa.json") as j, open("asm.gfa", "w") as f:
                deserialize_gfa(j).write_gfa_v1(f)
            with open("sg.gfa.json") as j, open("sg.gfa", "w") as f:
                deserialize_gfa(j).write_gfa_v1(f)
            with open("contig.gfa2.json") as j, open("contig.gfa2", "w") as f:
                deserialize_gfa(j).write_gfa_v2(f)
        finally:
            os.chdir(cwd)
        return os.path.join(d, "p_ctg.fa")

    def run(self):
        profile_dir = os.environ.get("FTPU_PROFILE", "")
        if not profile_dir:
            return self._run()
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        os.makedirs(profile_dir, exist_ok=True)
        LOG.info("profiling to %s", profile_dir)
        since = trace.mark()
        with torch.profiler.profile(activities=acts) as prof:
            p_ctg = self._run()
        trace_fn = os.path.join(profile_dir, "trace.json")
        prof.export_chrome_trace(trace_fn)
        # the port's own spans over the device's lanes (cat "ftt")
        trace.append_to_chrome_trace(trace_fn, trace.records(since))
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

    def _assemble(self, preads):
        """Phases 1 and 2 on the preads."""
        with trace.span("pipeline.phase1"):
            ovl_fn = self.phase1(preads)
        with trace.span("pipeline.phase2"):
            return self.phase2(ovl_fn)

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
                p_ctg = self._assemble(paths)
        else:
            with trace.span("pipeline.phase0"):
                preads = self.phase0()
            if preads is None or p.target == "pre-assembly":
                p_ctg = preads
            else:
                p_ctg = self._assemble(preads)
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


def setup_logging(logger_cfg=None):
    """Default stderr INFO logging, or a user logging config file --
    .json (logging.config.dictConfig) or .ini (fileConfig), the reference
    fc_run's second positional argument
    (reference: run_support.py:463-534)."""
    if logger_cfg:
        import json as _json
        import logging.config as _lc
        if logger_cfg.endswith(".json"):
            with open(logger_cfg) as f:
                _lc.dictConfig(_json.load(f))
        else:
            _lc.fileConfig(logger_cfg)
        return
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")


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
    setup_logging(logger_cfg)
    Pipeline(argv[0], out_dir).run()
    return 0


if __name__ == "__main__":
    sys.exit(main())
