"""Time the kernels of two trees of falcon_tpu_torch on one card, in one call.

    python tools/tb_compare.py --parent DIR [--change DIR] [--band W,...]
        [--shapes BxL,...] [--k1-shapes BxL,...] [--k4-shapes TxG,...]
        [--k5-shapes TxG,...] [--k6-shapes TxG,...]

DIR holds another tree's falcon_tpu_torch/ and nothing else of it (say
`git archive <commit> falcon_tpu_torch | tar -x -C DIR`, or a copy of the
package with a variant of a kernel in it).  The
trees are timed in the order parent, change, change, parent, each in a
process of its own (both packages are called falcon_tpu_torch, and each
builds its own kernels), on the same inputs made from --seed:

  --band       the bands W of K1, K2 and K3, each timed in turn (default
               256, the warp routes; a band of the block routes times
               those, with each tree's own layout)
  --shapes     K2 and K3 at (B, L): chip_smoke.make_pairs without its edge
               rows, read-vs-read pairs at 8-15% error, lengths in
               [L/2, L]; every launch's trace exceeds L2
  --k1-shapes  K1 at (B, L), on the same kind of pairs
  --k4-shapes  K4 at (T, G), D = 14, on one DP batch's 2G rows at
               L = min(T/2, 16384) (chip_smoke.dp_batch through the tree's
               own K2 + K3), the timed launches adding to one buffer
  --k5-shapes  K5 at (T, G), D = 14, on the counts of one DP batch
               (chip_smoke.dp_batch through the tree's own K2-K4)
  --k6-shapes  K6 at (T, G), D = 14, on that batch's scan (the tree's own
               K4 + K5) with group G - 2 on the 2T-code ladder
               (chip_smoke.ladder_walk), as chip_smoke's dp_kernels times it

An empty list skips its kernels.  Kernel times are CUDA events, the mean of
--reps launches after a warm-up.  One JSON line per (tree, kernel, shape,
band), then a summary line per kernel, shape and band; `same` says whether
the two trees' outputs agreed (a checksum of K2's end cells and K3's two
streams, of K1's end cells, of K4's counts, of K5's six outputs or of
K6's two).
"""
import argparse
import json
import os
import subprocess
import sys

D = 14
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(args):
    """Times the falcon_tpu_torch that PYTHONPATH puts first."""
    import numpy as np
    import torch
    from chip_smoke import cuda_ms, dp_batch, ladder_walk
    from falcon_tpu_torch.ops import align_cuda, cns_dp_cuda
    tree = os.path.dirname(os.path.dirname(os.path.dirname(
        align_cuda.__file__)))

    def out(**kv):
        print(json.dumps(dict(tree=tree, **kv)), flush=True)
    rng = np.random.default_rng(args.seed)
    for W in args.band:
        time_band(args, rng, W, out)
    for T, G in args.k4_shapes:
        msa, rest = dp_batch(rng, G, T, min(T // 2, 16384), D,
                             np.float32(0.3))
        got = cns_dp_cuda.accumulate_tags_planes_cuda(msa.clone(), *rest)
        # the timed launches add to one scratch copy, as chip_smoke does
        _, ms = cuda_ms(
            lambda: cns_dp_cuda.accumulate_tags_planes_cuda(msa, *rest),
            reps=args.reps)
        out(kernel="K4", shape=[T, G], D=D, rows=rest[0].shape[1],
            k4_ms=ms, checksum=int(got.view(torch.int16).to(
                torch.int64).sum()))
        del msa, rest, got
        torch.cuda.empty_cache()
    for T, G in args.k5_shapes:
        msa, rest = dp_batch(rng, G, T, min(T // 2, 16384), D,
                             np.float32(0.3))
        cns_dp_cuda.accumulate_tags_planes_cuda(msa, *rest)
        del rest
        torch.cuda.empty_cache()
        scan, ms = cuda_ms(
            lambda: cns_dp_cuda.consensus_scan_cuda(msa, G, T, D),
            reps=args.reps)
        out(kernel="K5", shape=[T, G], D=D, k5_ms=ms,
            checksum=sum(int(x.long().sum()) for x in scan))
        del msa, scan
        torch.cuda.empty_cache()
    for T, G in args.k6_shapes:
        msa, rest = dp_batch(rng, G, T, min(T // 2, 16384), D,
                             np.float32(0.3))
        cns_dp_cuda.accumulate_tags_planes_cuda(msa, *rest)
        del rest
        scan = ladder_walk(cns_dp_cuda.consensus_scan_cuda(msa, G, T, D),
                           G - 2, T, D)
        del msa
        torch.cuda.empty_cache()
        walk, ms = cuda_ms(
            lambda: cns_dp_cuda.backtrack_walk_cuda(*scan, 2, G, T, D),
            reps=args.reps)
        out(kernel="K6", shape=[T, G], D=D, k6_ms=ms,
            checksum=int(walk[0].long().sum()) + int(walk[1].sum()))
        del scan, walk
        torch.cuda.empty_cache()


def time_band(args, rng, W, out):
    """K2 + K3 at --shapes, then K1 at --k1-shapes, at band W."""
    import torch
    from chip_smoke import cuda_ms, make_pairs
    from falcon_tpu_torch.ops import align_cuda, align_tb_cuda
    for B, L in args.shapes:
        q, ql, t, tl = make_pairs(rng, B, L, W, edge=False)
        (ends, trace), fwd = cuda_ms(
            lambda: align_tb_cuda.tb_forward_cuda(q, ql, t, tl, W, 3),
            reps=args.reps)
        (mv, bs), bwd = cuda_ms(
            lambda: align_tb_cuda.tb_backward_cuda(trace, ends, q, W),
            reps=args.reps)
        out(kernel="K2+K3", shape=[B, L], W=W, k2_ms=fwd, k3_ms=bwd,
            checksum=[int(ends.long().sum()), int(mv.long().sum()),
                      int(bs.long().sum())])
        del mv, bs
        del trace
        torch.cuda.empty_cache()
    for B, L in args.k1_shapes:
        q, ql, t, tl = make_pairs(rng, B, L, W, edge=False)
        ends, ms = cuda_ms(
            lambda: align_cuda.extend_batch_cuda(q, ql, t, tl, W=W),
            reps=args.reps)
        out(kernel="K1", shape=[B, L], W=W, k1_ms=ms,
            checksum=int(ends.sum()))


def shape_list(text):
    return [tuple(int(x) for x in s.split("x"))
            for s in text.split(",") if s]


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--change", default=HERE)
    ap.add_argument("--band", type=lambda text: [int(x) for x in
                                                 text.split(",")],
                    default="256")
    ap.add_argument("--shapes", type=shape_list,
                    default="1024x1024,256x16384")
    ap.add_argument("--k1-shapes", type=shape_list,
                    default="16384x1024,4096x8192")
    ap.add_argument("--k4-shapes", type=shape_list,
                    default="8192x360,32768x90")
    ap.add_argument("--k5-shapes", type=shape_list,
                    default="8192x360,32768x90")
    ap.add_argument("--k6-shapes", type=shape_list,
                    default="8192x360,32768x90")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    if args.worker:
        worker(args)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    passed = list(argv if argv is not None else sys.argv[1:])
    runs = []
    for side, root in (("parent", args.parent), ("change", args.change),
                       ("change", args.change), ("parent", args.parent)):
        # the tree's package first, then this checkout for chip_smoke
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.abspath(root), HERE]))
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker"] + passed,
            capture_output=True, text=True, env=env)
        if out.returncode:
            sys.stderr.write(out.stderr)
            return out.returncode
        for ln in out.stdout.splitlines():
            if ln.startswith("{"):
                runs.append(dict(json.loads(ln), side=side))
                print(json.dumps(runs[-1]), flush=True)
    seen = []
    for r in runs:
        if (r["kernel"], r["shape"], r.get("W")) not in seen:
            seen.append((r["kernel"], r["shape"], r.get("W")))
    for key in seen:
        rows = [r for r in runs
                if (r["kernel"], r["shape"], r.get("W")) == key]
        kernel, shape, W = key
        print(json.dumps(dict(
            card=card, kernel=kernel, shape=shape, W=W,
            same=len({json.dumps(r["checksum"]) for r in rows}) == 1,
            **{"%s_%s" % (side, key): [r[key] for r in rows
                                       if r["side"] == side]
               for side in ("parent", "change")
               for key in rows[0] if key.endswith("_ms")})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
