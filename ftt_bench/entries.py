"""The entries a window drives, one class per traffic `entry`:

  consensus  the production entry cns.device.run_consensus_device over seed
             groups built from the simulator's truth; the unit is a group
  pipeline   pipeline.driver.Pipeline.run() in a fresh directory, to the
             traffic's `target` (overlapping: the phase-0 overlap;
             assembly: reads to p_ctg.fa); the unit is one run

The window rule (window()): units are started until `seconds` have passed,
and the rate is the work of every unit started over the time to the end of
the last one.
"""
import hashlib
import os
import shutil
import time

import numpy as np

from . import reference, traffic


def run_units(seconds, unit):
    """The window rule: start unit(k) for k = 0, 1, ... until `seconds`
    have passed (at least one), each run to its end.  Returns (units,
    seconds to the end of the last one)."""
    t0 = time.perf_counter()
    k = 0
    while k == 0 or time.perf_counter() - t0 < seconds:
        unit(k)
        k += 1
    return k, time.perf_counter() - t0


def cfg_text(cfg):
    """An fc_run.cfg [General] section from a dict of keys."""
    lines = ["[General]"] + ["%s = %s" % (k, v) for k, v in cfg.items()]
    return "\n".join(lines) + "\n"


class Cell:
    """What an entry needs of the run (the cell's files, the seed, a work
    directory, the device), and what the run counts for the per-layer
    readers (set-up stages, and in a traced run the kernels' tasks and the
    chain's times)."""

    def __init__(self, workload, config, traffic_, limits, seed, workdir,
                 device, cfg_override=None):
        self.workload = workload
        self.config = config
        self.traffic = traffic_
        self.limits = limits
        self.seed = int(seed)
        self.workdir = workdir
        self.device = device
        cfg = dict(config["cfg"])
        cfg.update(traffic_.get("cfg", {}))
        cfg.update(cfg_override or {})
        self.cfg = cfg
        self.tasks = {"K1": [], "K2": []}     # (qlen, tlen) arrays
        self.chain = []                        # (t_index, t_chain) a pair
        self.timings = []                      # Pipeline.timings a unit
        self.setup_parts = {}                  # set-up stage -> seconds
        self._t = time.time()

    def mark(self, stage):
        """Log the seconds since the last mark under `stage`."""
        t = time.time()
        self.setup_parts[stage] = t - self._t
        self._t = t

    def check_seed(self):
        """The seed that draws the reference's sample."""
        return int(np.random.SeedSequence([self.seed, 7]).generate_state(1)[0])


class ConsensusEntry:
    """run_consensus_device over truth-built seed groups, cycled."""

    WARM_GROUPS = 64       # a DP batch's worth of groups

    def __init__(self, cell):
        from falcon_tpu_torch.cns.device import DeviceCns
        from falcon_tpu_torch.cns.runner import ConsensusConfig
        self.cell = cell
        tr = cell.traffic
        cfg = cell.cfg
        self.rs = traffic.make_reads(tr["reads"], cell.seed)
        cell.mark("reads")
        cutoff = int(cfg["length_cutoff"])
        if cutoff < 0:
            cutoff = traffic.seed_cutoff(self.rs.lengths,
                                         cfg["seed_coverage"],
                                         tr["reads"]["genome_size"])
        self.groups = traffic.truth_groups(self.rs, cutoff,
                                           tr["min_overlap"])
        cell.mark("groups")
        self.ccfg = ConsensusConfig.from_option_string(
            cfg["falcon_sense_option"])
        self.dev = DeviceCns(device=cell.device,
                             use_dp=cell.config["consensus_path"] == "dp")
        self.n_groups = len(self.groups)
        self.pulled = []
        self.out_path = os.path.join(cell.workdir, "preads.fa")

    def _run(self, groups, path):
        from falcon_tpu_torch.cns.device import run_consensus_device
        with open(path, "w") as f:
            run_consensus_device(groups, self.ccfg, f, dev=self.dev)

    def warm(self):
        """The shapes of the window: a DP batch's worth of groups in every
        T bucket the seeds fall in (the device-DP path), or as many groups
        (the host-MSA path)."""
        n = self.WARM_GROUPS
        by_T = {}
        for g in self.groups:
            L = len(g.items[0][1])
            T = max(1024, 1 << int(np.ceil(np.log2(max(L, 2)))))
            by_T.setdefault(T, [])
            if len(by_T[T]) < n:
                by_T[T].append(g)
        pick = [g for T in sorted(by_T) for g in by_T[T]]
        if self.cell.config["consensus_path"] != "dp":
            pick = self.groups[:n]
        path = os.path.join(self.cell.workdir, "warm.fa")
        self._run(((g.items[0][0], g.items) for g in pick), path)
        os.unlink(path)
        self.cell.mark("warm")

    def window(self, seconds):
        groups = self.groups
        n = len(groups)
        pulled = self.pulled
        work = [0]
        t0 = time.perf_counter()

        def gen():
            k = 0
            while k == 0 or time.perf_counter() - t0 < seconds:
                g = groups[k % n]
                cyc = k // n
                items = g.items
                if cyc:
                    # each pull of a later cycle under a name of its own
                    sid = "%09d" % (cyc * 100000000 + g.rid)
                    items = [(sid,) + tuple(items[0][1:])] + items[1:]
                pulled.append(g.rid)
                work[0] += g.bases
                k += 1
                yield items[0][0], items

        self._run(gen(), self.out_path)
        elapsed = time.perf_counter() - t0
        return {"work": work[0], "elapsed": elapsed, "units": len(pulled)}

    def release(self):
        self.dev = None
        self.groups = None

    def check(self):
        """The reference's numbers over a sample of the window's pulls."""
        index = {}
        for p, rid in enumerate(self.pulled):
            cyc = p // self.n_groups
            index["%09d" % (cyc * 100000000 + rid)] = p
        preads = {}
        for name, seq in reference.read_fasta(self.out_path):
            # prolog/<seed id><one-digit piece>/0_<len>
            p = index.get(name[7:name.index("/", 7) - 1])
            if p is not None:
                preads.setdefault(p, []).append(seq)
        return reference.check_preads(self.rs, self.pulled, preads,
                                      self.cell.limits["sample"],
                                      self.cell.check_seed())


class PipelineEntry:
    """Pipeline(cfg, fresh dir).run() on the set-up's reads, repeated."""

    PRODUCT = {"overlapping": "0-rawreads/raw_overlaps.ovl",
               "assembly": "2-asm-falcon/p_ctg.fa"}

    def __init__(self, cell):
        self.cell = cell
        tr = cell.traffic
        self.target = tr["target"]
        self.rs = traffic.make_reads(tr["reads"], cell.seed)
        cell.mark("reads")
        self.reads_fa = os.path.join(cell.workdir, "reads.fa")
        traffic.write_fasta(self.reads_fa, self.rs)
        cell.mark("fasta")
        self.products = []
        self.dirs = []

    def _pipeline(self, name, reads_fa, cfg_extra=None):
        from falcon_tpu_torch.pipeline.driver import Pipeline
        d = os.path.join(self.cell.workdir, name)
        os.makedirs(d)
        fofn = os.path.join(d, "input.fofn")
        with open(fofn, "w") as f:
            f.write(reads_fa + "\n")
        cfg = dict(self.cell.cfg)
        cfg.update(input_fofn=fofn, target=self.target)
        cfg.update(cfg_extra or {})
        path = os.path.join(d, "fc_run.cfg")
        with open(path, "w") as f:
            f.write(cfg_text(cfg))
        p = Pipeline(path, d, device=self.cell.device)
        p.run()
        return d, p

    def warm(self):
        """One small run of the same target: a genome of warm_genome_size
        from the same seed, its blocks cut to keep several block pairs."""
        tr = self.cell.traffic
        rs = traffic.make_reads(tr["reads"], self.cell.seed,
                                genome_size=tr["warm_genome_size"])
        fa = os.path.join(self.cell.workdir, "warm.fa")
        traffic.write_fasta(fa, rs)
        d, _ = self._pipeline("warm", fa, tr.get("warm_cfg"))
        shutil.rmtree(d)
        os.unlink(fa)
        self.cell.mark("warm")

    def window(self, seconds):
        def unit(k):
            d, p = self._pipeline("unit%d" % k, self.reads_fa)
            self.dirs.append(d)
            self.products.append(os.path.join(d, self.PRODUCT[self.target]))
            self.cell.timings.append(dict(p.timings))

        k, elapsed = run_units(seconds, unit)
        return {"work": self.rs.total_bases * k, "elapsed": elapsed,
                "units": k}

    def release(self):
        pass

    def check(self):
        """The reference's numbers for each distinct product of the window
        (a deterministic program writes one), the worst reading of each."""
        lim = self.cell.limits
        seen = {}
        for path in self.products:
            if not os.path.exists(path):
                digest = None
            else:
                with open(path, "rb") as f:
                    digest = hashlib.sha1(f.read()).hexdigest()
            if digest in seen:
                continue
            if digest is None:
                nums = {k: 1.0 for k in lim["checks"]}
            elif self.target == "overlapping":
                nums = reference.check_overlaps(
                    self.rs, reference.read_table(path),
                    self.cell.traffic["check_overlap"], lim["sample"],
                    self.cell.check_seed())
            else:
                nums = reference.check_contigs(self.rs.genome,
                                               reference.read_fasta(path))
            seen[digest] = nums
        out = {}
        for nums in seen.values():
            for k, v in nums.items():
                out[k] = max(out.get(k, v), v)
        return out

    def cleanup(self):
        for d in self.dirs:
            shutil.rmtree(d, ignore_errors=True)


ENTRIES = {"consensus": ConsensusEntry, "pipeline": PipelineEntry}
