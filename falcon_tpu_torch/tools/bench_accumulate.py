"""Microbenchmark of the MSA tag accumulation (K4) at production shapes
(counterpart of falcon_tpu's tools/bench_accumulate.py).

Shapes mirror what dispatch_chunk_dp produces at E. coli scale: B tasks
of ~L bases (a noisy copy, err/3 of its bases deleted, against its
template) against T-column groups, the trace from K2 + K3
(align_tb_batch_cuda, W 256).  Timed on the same inputs, each on a fresh
count buffer, best of --reps by CUDA events (the host clock on the CPU):

  k4         ops.cns_dp_cuda.accumulate_tags_planes_cuda (K4: decode and
             scatter in one kernel)
  plain      its plain twin, ops.cns_dp.accumulate_tags_planes
  index_add  one index_add_ of the same decoded tags
             (ops.cns_dp.tag_indices) into the same counts: the scatter
             alone, the nearest library call; not K4's library call, since
             it does not decode
  decode     tag_indices alone (the plain decode)

parity: K4's counts equal the twin's; index_add_parity: the scatter of the
decoded tags gives the same counts.  scatter_ns_per_slot and
scatter_ns_per_kept are K4's time over the move slots and the kept tags.
The reference tool's two variants (the combined-buffer accumulate_tags and
accumulate_tags_mm) have no counterpart in the port.

Usage: python -m falcon_tpu_torch.tools.bench_accumulate [--B 64]
       [--L 16384] [--T 16384] [--G 32] [--D 14] [--err 0.12] [--device D]
"""
import argparse
import json
import sys
import time

import numpy as np
import torch

from ..ops import cns_dp
from ..ops import cns_dp_cuda as dpk
from ..ops.align_tb_cuda import align_tb_batch_cuda
from .common import (add_device_arg, best_seconds, device_of,
                     launch_counts, launches_since, sync)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--B", type=int, default=64)
    p.add_argument("--L", type=int, default=16384)
    p.add_argument("--T", type=int, default=16384)
    p.add_argument("--G", type=int, default=32)
    p.add_argument("--D", type=int, default=14)
    p.add_argument("--err", type=float, default=0.12)
    p.add_argument("--reps", type=int, default=5)
    add_device_arg(p)
    return p.parse_args(argv)


def make_batch(B, L, G, err):
    """The reference tool's inputs (RandomState(5)): q, t [B, L] int8
    (pad 4 / 5), their lengths, each row's group (sorted) and seed start
    (0)."""
    rng = np.random.RandomState(5)
    qs = np.full((B, L), 4, np.int8)
    ts = np.full((B, L), 5, np.int8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    gidx = np.sort(rng.randint(0, G, B)).astype(np.int32)
    s2 = np.zeros(B, np.int32)
    for b in range(B):
        n = rng.randint(int(L * 0.55), int(L * 0.95))
        t_arr = rng.randint(0, 4, n).astype(np.uint8)
        # noisy copy
        keep = rng.rand(n) > err / 3
        q_arr = t_arr[keep]
        qs[b, :len(q_arr)] = q_arr
        ts[b, :n] = t_arr
        qlen[b] = len(q_arr)
        tlen[b] = n
    return qs, qlen, ts, tlen, gidx, s2


def run(args):
    dev, card = device_of(args.device)
    B, L, T, G, D = args.B, args.L, args.T, args.G, args.D
    qs, qlen, ts, tlen, gidx, s2 = (
        torch.from_numpy(a).to(dev)
        for a in make_batch(B, L, G, args.err))
    before = launch_counts()
    t0 = time.perf_counter()
    _, _, bd, mvp, bases = align_tb_batch_cuda(qs, qlen, ts, tlen, W=256)
    sync(dev)
    res = {"device": str(dev), "card": card, "B": B, "L": L, "T": T,
           "G": G, "D": D, "align_s": time.perf_counter() - t0,
           "align_launches": launches_since(before),
           "updates_per_call": int(B * mvp.shape[0] * 4)}
    max_diff = np.float32(0.5)
    rows = (mvp, bases, bd, gidx, s2, max_diff)

    def fresh():
        return cns_dp.alloc_msa(G, T, D, dev)

    idx = cns_dp.tag_indices(*rows, G, T, D)
    ones = torch.ones(idx.numel(), dtype=torch.int16, device=dev)
    variants = {
        "k4": lambda m: dpk.accumulate_tags_planes_cuda(m, *rows, T, D),
        "plain": lambda m: cns_dp.accumulate_tags_planes(m, *rows, T, D),
        "index_add": lambda m: m.view(torch.int16).index_add_(0, idx, ones),
        "decode": lambda _: cns_dp.tag_indices(*rows, G, T, D)}
    outs = {}
    for name, fn in variants.items():
        before = launch_counts()
        res[name + "_s"], outs[name] = best_seconds(
            fn, dev, iters=args.reps, setup=fresh)
        res[name + "_launches"] = launches_since(before)
    k4, plain, ia = (outs[k].view(torch.int16)
                     for k in ("k4", "plain", "index_add"))
    res["parity"] = bool(torch.equal(k4, plain))
    res["index_add_parity"] = bool(torch.equal(k4, ia))
    kept = int(cns_dp.counts_i32(k4).sum())
    res["kept_columns"] = kept
    res["scatter_ns_per_slot"] = res["k4_s"] * 1e9 / res["updates_per_call"]
    res["scatter_ns_per_kept"] = res["k4_s"] * 1e9 / max(kept, 1)
    return res


def main(argv=None):
    res = run(parse_args(argv))
    print(json.dumps(res))
    return 0 if res["parity"] and res["index_add_parity"] else 1


if __name__ == "__main__":
    sys.exit(main())
