"""Stage-by-stage profile of the device-DP consensus (the FTPU_CNS_DP path)
on the card (counterpart of falcon_tpu's tools/profile_cns_dp.py).

One chunk of simulated seed groups (build_groups) goes through
DeviceCns._dispatch_dp_batch rebuilt here stage by stage, with a
synchronize of the device after each stage, so that each stage's seconds
are its own:

  hostprep  gating (gate_group_ranged), T buckets, seed codes, task
            building with the host range (DeviceCns._host_range) of every
            support that carries none, the alignment batches' length
            buckets and pack_tasks
  h2d       every copy to the device: seeds and lengths, each alignment
            batch's packed tasks (pack_tasks' two tensors, page-locked on
            the card as production stages them) and its block of group and
            seed-start rows (h2d_copies counts them)
  alloc     the zeroed count buffer (cns_dp.alloc_msa)
  selftags  the seeds' own tags (cns_dp.add_self_tags)
  align     gather_pad2 + K2 + K3 (DeviceCns._align_tb), batch by batch
  acc       K4 (accumulate_tags_planes_cuda), an alignment batch a call
  scan      K5 (consensus_scan_cuda)
  walk      K6 (backtrack_walk_cuda)
  fetch     the emitted rows and counts back to the host
  hostasm   cns_dp.assemble_compacted of every group

The rebuild follows the production path, not the reference tool: a
support without a range gets DeviceCns._host_range as _dispatch_dp_batch
gives it one, where the reference tool skipped it and so profiled fewer
alignment tasks than a real run.  The same chunk then goes through
dispatch_chunk_dp + finish_chunk_dp unbarriered (production_s, gating
included), which is the parity check: the rebuild must give the same
consensus byte for byte, the same number of alignment tasks and the same
launches of every kernel (parity).  Its wall beside sum_stage_s shows
what the production overlap hides.

Every stage's kernel launches come from the wrappers' LAUNCHES counters.
--repeat runs the rebuild that many times and reports the last (the first
loads the CUDA library); the production run follows the last.

Usage: python -m falcon_tpu_torch.tools.profile_cns_dp [--genome-size N]
       [--repeat N] [--unranged F] [--seed S] [--device D]
"""
import argparse
import json
import sys
import time

import numpy as np

from ..cns import runner
from ..cns.device import (DeviceCns, _clamp_range, _range_ok,
                          gate_group_ranged, seq_to_codes)
from ..ops import cns_dp
from ..ops import cns_dp_cuda as dpk
from ..ops.align_device import LADDER, gather_pad2, pack_tasks
from ..utils import sim
from .common import (Stages, add_device_arg, device_of, launch_counts,
                     launches_since, sync)


def build_groups(genome_size, coverage, error, seed,
                 group_len=(8000, 14000), unranged=0.0):
    """Simulated seed groups, those of bench_consensus.py's build_groups (a
    copy on this package's sim and runner, less the reads it simulated and
    never used): genome_size // 12000 groups (at least 4), each a template
    of group_len[0] to group_len[1] bases cut from a random genome, the
    seed and int(coverage) supports noisy copies of it (error split evenly
    into substitutions, insertions and deletions), every support ranged
    over its whole length.  unranged: the fraction of supports that carry
    no range, as groups from a stream input do (drawn from a RandomState of
    its own, so the sequences are the same at any fraction).  Returns
    (groups, ConsensusConfig)."""
    genome = sim.random_genome(genome_size, seed=seed)
    rng = np.random.RandomState(seed + 2)
    drop = np.random.RandomState(seed + 3)
    cfg = runner.ConsensusConfig(min_cov=2, min_idt=0.70, min_n_read=4,
                                 min_cov_aln=4, max_n_read=40,
                                 output_multi=False)
    groups = []
    g = np.frombuffer(genome.encode(), np.uint8)
    n_groups = max(4, genome_size // 12000)
    lo, hi = group_len
    for k in range(n_groups):
        s = rng.randint(0, max(1, len(g) - hi))
        ln = rng.randint(lo, hi)
        tmpl = g[s:s + ln]
        seed_seq = sim.mutate(tmpl, rng, error / 3, error / 3,
                              error / 3).tobytes().decode()
        items = [("%09d" % (k * 100), seed_seq, None)]
        for si in range(int(coverage)):
            sup = sim.mutate(tmpl, rng, error / 3, error / 3,
                             error / 3).tobytes().decode()
            rng_ = None if drop.rand() < unranged else \
                (0, len(sup), 0, len(seed_seq))
            items.append(("%09d" % (k * 100 + si + 1), sup, rng_))
        groups.append(("%09d" % (k * 100), items))
    return groups, cfg


def gate(groups, cfg):
    """The chunk of every group that passes gate_group_ranged, as
    run_consensus_device builds it."""
    chunk = []
    for seed_id, items in groups:
        g = gate_group_ranged(seed_id, items, cfg)
        if g is not None:
            chunk.append((seed_id, g[0], g[1]))
    return chunk


def dp_batches(dev, chunk):
    """(sub, G, T) of each DP batch, in dispatch_chunk_dp's order."""
    buckets = {}
    for ci, (_, seed_seq, _) in enumerate(chunk):
        T = max(1024, 1 << int(np.ceil(np.log2(max(len(seed_seq), 2)))))
        buckets.setdefault(T, []).append(ci)
    out = []
    for T in sorted(buckets):
        cis = buckets[T]
        Gmax = dev._dp_group_cap(T)
        for ofs in range(0, len(cis), Gmax):
            sub = cis[ofs:ofs + Gmax]
            G = min(Gmax, max(8, 1 << int(np.ceil(np.log2(
                max(len(sub), 2))))))
            out.append((sub, G, T))
    return out


def staged_batch(dev, st, chunk, sub, G, T, cfg, out):
    """DeviceCns._dispatch_dp_batch and finish_chunk_dp's part of one
    batch, stage by stage; writes (seed_id, consensus) into out at each
    group's chunk index.  Returns (alignment tasks, those from a host
    range)."""
    D = dev.dp_delta_cap
    with st("hostprep"):
        seeds = np.full((G, T), 4, np.int8)
        tlens = np.zeros(G, np.int32)
        tasks, gidx, s2s = [], [], []
        n_host = 0
        for g, ci in enumerate(sub):
            _, seed_seq, sups = chunk[ci]
            sc = seq_to_codes(seed_seq)
            seeds[g, :len(sc)] = np.minimum(sc, 4)
            tlens[g] = len(sc)
            for sup, rng, is_self in sups:
                if is_self:
                    continue
                host = rng is None
                if host:
                    rng = dev._host_range(sup, seed_seq, cfg)
                    if rng is None:
                        continue
                rng = _clamp_range(rng, len(sup), len(seed_seq))
                if not _range_ok(rng):
                    continue
                s1, e1, s2, e2 = rng
                tasks.append((seq_to_codes(sup)[s1:e1], sc[s2:e2]))
                gidx.append(g)
                s2s.append(s2)
                n_host += host
        gidx = np.asarray(gidx, np.int32)
        s2s = np.asarray(s2s, np.int32)
    with st("alloc"):
        msa = cns_dp.alloc_msa(G, T, D, dev.device)
    seeds_d, tlens_d = st.h2d(seeds, tlens)
    with st("selftags"):
        cns_dp.add_self_tags(msa, seeds_d, tlens_d, T)
    max_diff = np.float32(1.0 - cfg.min_idt)
    # DeviceCns._align_batches, a stage at a time
    with st("hostprep"):
        buckets = {}
        for idx, (qc, tc) in enumerate(tasks):
            m = max(len(qc), len(tc), 1)
            L = next(r for r in LADDER if m <= r)
            buckets.setdefault(L, []).append(idx)
    for L in sorted(buckets):
        with st("hostprep"):
            idxs = sorted(buckets[L],
                          key=lambda i: len(tasks[i][0]) + len(tasks[i][1]))
            B = dev._batch_for(L)
        for ofs in range(0, len(idxs), B):
            rows = idxs[ofs:ofs + B]
            with st("hostprep"):
                host = pack_tasks(tasks, rows, len(rows), dev.device)
            cat, meta = st.h2d(*host)
            with st("align"):
                q, t = gather_pad2(cat, *meta, L, 4, 5)
                _, _, bd, mvp, bases = dev._align_tb(q, meta[1], t, meta[3])
            (blk,) = st.h2d(np.stack([gidx[rows], s2s[rows]]))
            gi, s2 = blk
            with st("acc"):
                dpk.accumulate_tags_planes_cuda(msa, mvp, bases, bd, gi, s2,
                                                max_diff, T, D)
    with st("scan"):
        scan = dpk.consensus_scan_cuda(msa, G, T, D)
    with st("walk"):
        rows_d, counts_d = dpk.backtrack_walk_cuda(*scan, int(cfg.min_cov),
                                                   G, T, D)
    with st("fetch"):
        emitted = rows_d.cpu().numpy()
        counts = counts_d.cpu().numpy()
    with st("hostasm"):
        for g, ci in enumerate(sub):
            out[ci] = (chunk[ci][0],
                       cns_dp.assemble_compacted(emitted[g], counts[g]))
    return len(tasks), n_host


def staged(dev, groups, cfg):
    """The whole chunk through staged_batch.  Returns (Stages, consensus in
    chunk order, alignment tasks, tasks from host ranges, DP batches)."""
    st = Stages(dev.device)
    with st("hostprep"):
        chunk = gate(groups, cfg)
        plan = dp_batches(dev, chunk)
    out = [None] * len(chunk)
    n_tasks = n_host = 0
    for sub, G, T in plan:
        n, h = staged_batch(dev, st, chunk, sub, G, T, cfg, out)
        n_tasks += n
        n_host += h
    return st, out, n_tasks, n_host, len(plan)


def production(dev, groups, cfg):
    """Gating, dispatch_chunk_dp and finish_chunk_dp as a run does them,
    unbarriered.  Returns (consensus, seconds, launches, alignment
    tasks)."""
    before = launch_counts()
    t0 = time.perf_counter()
    state = dev.dispatch_chunk_dp(gate(groups, cfg), cfg)
    out = dev.finish_chunk_dp(state)
    sync(dev.device)
    seconds = time.perf_counter() - t0
    return out, seconds, launches_since(before), sum(b[3] for b in state[1])


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--genome-size", type=int, default=300_000)
    p.add_argument("--coverage", type=float, default=24)
    p.add_argument("--error", type=float, default=0.08)
    p.add_argument("--repeat", type=int, default=2)
    p.add_argument("--seed", type=int, default=11)
    p.add_argument("--unranged", type=float, default=0.0,
                   help="fraction of supports with no range, which get a "
                        "host range (0)")
    add_device_arg(p)
    return p.parse_args(argv)


def run(args):
    device, card = device_of(args.device)
    t0 = time.perf_counter()
    groups, cfg = build_groups(args.genome_size, args.coverage, args.error,
                               seed=args.seed, unranged=args.unranged)
    sim_s = time.perf_counter() - t0
    res = profile(groups, cfg, device, args.repeat)
    res.update(card=card, genome_size=args.genome_size, sim_s=sim_s)
    return res


def profile(groups, cfg, device, repeat=2):
    """The staged rebuild `repeat` times (the last reported) and the
    production run on (groups, cfg) on `device`; the tool's result."""
    total_bases = sum(sum(len(s) for _, s, _ in items)
                      for _, items in groups)
    dev = DeviceCns(use_dp=True, device=device)
    for _ in range(repeat):
        st, out, n_tasks, n_host, n_batches = staged(dev, groups, cfg)
    prod, prod_s, prod_launches, prod_tasks = production(dev, groups, cfg)
    launches = {}
    for by_kernel in st.launches.values():
        for k, n in by_kernel.items():
            launches[k] = launches.get(k, 0) + n
    wall = sum(st.seconds.values())
    return {
        "metric": "cns_dp_profile",
        "device": str(device), "groups": len(groups),
        "gated_groups": len(out), "dp_batches": n_batches,
        "support_mbases": round(total_bases / 1e6, 2),
        "stages_s": dict(sorted(st.seconds.items(), key=lambda x: -x[1])),
        "stage_calls": dict(st.calls),
        "launches": {k: dict(v) for k, v in st.launches.items() if v},
        "h2d_copies": st.h2d_copies,
        "sum_stage_s": wall,
        "eff_support_bases_per_s": total_bases / max(wall, 1e-9),
        "tasks": n_tasks, "tasks_from_host_ranges": n_host,
        "production_s": prod_s,
        "production_tasks": prod_tasks,
        "launches_by_kernel": launches,
        "production_launches": prod_launches,
        "parity": out == prod and n_tasks == prod_tasks and
        launches == prod_launches,
    }


def main(argv=None):
    res = run(parse_args(argv))
    print(json.dumps(res))
    return 0 if res["parity"] else 1


if __name__ == "__main__":
    sys.exit(main())
