"""Micro-profile of the overlap extension path on the card (counterpart of
falcon_tpu's tools/profile_extender.py).

Splits one production-shaped batch into its device stages to attribute
the extender's time: (a) the spec gather (ops.align_device.
gather_specs2_packed: packed-word gather + unpack -> [B, L] planes),
(b) K1 on resident planes (ops.align_cuda.extend_batch_cuda), (c) the two
chained as DeviceExtender runs them.  Each stage is timed by CUDA events
over 4 calls in flight (the extender's dispatch pattern), best of 3, after
a warm-up call; on the CPU (--device cpu: the plain twin) by the host
clock.  The chain's (i, j, d) must be bit-equal to the plain twin
ops.align_device.extend_batch on the gathered planes.

The flat block is 64 Mb of random codes (RandomState(0), as the
reference tool's), 2-bit packed, with B (q, t) slices of L/2 to L bases at
random offsets.

Usage: python -m falcon_tpu_torch.tools.profile_extender [B] [L]
       [--W 256] [--device D]
"""
import argparse
import json
import sys

import numpy as np
import torch

from ..ops.align_cuda import extend_batch_cuda
from ..ops.align_device import (extend_batch, gather_specs2_packed,
                                pack_flat_2bit)
from .common import (add_device_arg, best_seconds, device_of,
                     launch_counts, launches_since)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("B", type=int, nargs="?", default=2048)
    p.add_argument("L", type=int, nargs="?", default=4096)
    p.add_argument("--W", type=int, default=256)
    add_device_arg(p)
    return p.parse_args(argv)


def run(args):
    dev, card = device_of(args.device)
    B, L, W = args.B, args.L, args.W
    rng = np.random.RandomState(0)
    n_flat = 64 << 20                           # 64 Mb flat block
    flat = rng.randint(0, 4, n_flat).astype(np.uint8)
    words = torch.from_numpy(pack_flat_2bit(flat).astype(np.int64)).to(dev)
    sel = np.zeros((6, B), np.int32)
    sel[0] = rng.randint(0, n_flat - L, B)      # q_off
    sel[1] = rng.randint(L // 2, L, B)          # q_len
    sel[2] = 1
    sel[3] = rng.randint(0, n_flat - L, B)      # t_off
    sel[4] = rng.randint(L // 2, L, B)          # t_len
    sel[5] = 1
    sel_d = torch.from_numpy(sel).to(dev)
    qlen, tlen = sel_d[1].contiguous(), sel_d[4].contiguous()

    def gather(_=None):
        return gather_specs2_packed(words, *sel_d, L=L, fill_q=4, fill_t=5)

    def kernel(_=None):
        return extend_batch_cuda(q, qlen, t, tlen, W=W)

    def chain(_=None):
        q_, t_ = gather()
        return extend_batch_cuda(q_, qlen, t_, tlen, W=W)

    times, launches = {}, {}
    q = t = None
    for name, fn in (("gather", gather), ("kernel", kernel),
                     ("chain", chain)):
        before = launch_counts()
        times[name], out = best_seconds(fn, dev, iters=3, pipe=4)
        launches[name] = launches_since(before)
        if name == "gather":
            q, t = out
        elif name == "chain":
            got = out
    ref = extend_batch(q, qlen, t, tlen, W=W)
    bases = float(np.minimum(sel[1], sel[4]).sum())
    return {"device": str(dev), "card": card, "B": B, "L": L, "W": W,
            "gather_s": times["gather"],
            "kernel_s": times["kernel"], "chain_s": times["chain"],
            "kernel_bases_per_s": bases / times["kernel"],
            "launches": launches,
            "bit_equal": bool(torch.equal(got, ref))}


def main(argv=None):
    res = run(parse_args(argv))
    print("B=%d L=%d: gather %.3fs | kernel %.3fs (%.1fM bases/s) | "
          "chain %.3fs" % (res["B"], res["L"], res["gather_s"],
                           res["kernel_s"], res["kernel_bases_per_s"] / 1e6,
                           res["chain_s"]), file=sys.stderr)
    print(json.dumps(res))
    return 0 if res["bit_equal"] else 1


if __name__ == "__main__":
    sys.exit(main())
