"""Time K2 and K3 of two trees of falcon_tpu_torch on one card, in one call.

    python tools/tb_compare.py --parent DIR [--change DIR] [--shapes BxL,...]

DIR holds another tree's falcon_tpu_torch/ and nothing else of it (say
`git archive <commit> falcon_tpu_torch | tar -x -C DIR`, or a copy of the
package with a variant of a kernel in it).  The
trees are timed in the order parent, change, change, parent, each in a
process of its own (both packages are called falcon_tpu_torch, and each
builds its own kernels), on the same inputs made from --seed by
chip_smoke.make_pairs without its edge rows: read-vs-read pairs at 8-15%
error, lengths in [L/2, L], W = 256.  Kernel times are CUDA events, the mean
of --reps launches after a warm-up; every launch's trace exceeds L2.  One
JSON line per (tree, shape), then a summary line per shape; `same_ends`
says whether the two trees' K2 agreed on the end cells.
"""
import argparse
import json
import os
import subprocess
import sys

W = 256
HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def worker(shapes, seed, reps):
    """Times the falcon_tpu_torch that PYTHONPATH puts first."""
    import numpy as np
    import torch
    from chip_smoke import cuda_ms, make_pairs
    from falcon_tpu_torch.ops import align_tb_cuda as k
    rng = np.random.default_rng(seed)
    for B, L in shapes:
        q, ql, t, tl = make_pairs(rng, B, L, W, edge=False)
        (ends, trace), fwd = cuda_ms(
            lambda: k.tb_forward_cuda(q, ql, t, tl, W, 3), reps=reps)
        _, bwd = cuda_ms(lambda: k.tb_backward_cuda(trace, ends, q, W),
                         reps=reps)
        print(json.dumps(dict(tree=os.path.dirname(os.path.dirname(
            os.path.dirname(k.__file__))), B=B, L=L, W=W, k2_ms=fwd,
            k3_ms=bwd, ends_sum=int(ends.sum()))), flush=True)
        del trace
        torch.cuda.empty_cache()


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--parent")
    ap.add_argument("--change", default=HERE)
    ap.add_argument("--shapes", default="1024x1024,256x16384")
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    args = ap.parse_args(argv)
    shapes = [tuple(int(x) for x in s.split("x"))
              for s in args.shapes.split(",")]
    if args.worker:
        worker(shapes, args.seed, args.reps)
        return 0
    if not args.parent:
        ap.error("--parent is required")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    runs = []
    for side, root in (("parent", args.parent), ("change", args.change),
                       ("change", args.change), ("parent", args.parent)):
        # the tree's package first, then this checkout for chip_smoke
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [os.path.abspath(root), HERE]))
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), "--worker",
             "--shapes", args.shapes, "--seed", str(args.seed), "--reps",
             str(args.reps)], capture_output=True, text=True, env=env)
        if out.returncode:
            sys.stderr.write(out.stderr)
            return out.returncode
        for ln in out.stdout.splitlines():
            if ln.startswith("{"):
                runs.append(dict(json.loads(ln), side=side))
                print(json.dumps(runs[-1]), flush=True)
    for B, L in shapes:
        rows = [r for r in runs if (r["B"], r["L"]) == (B, L)]
        print(json.dumps(dict(
            card=card, B=B, L=L, W=W,
            same_ends=len({r["ends_sum"] for r in rows}) == 1,
            **{"%s_%s" % (side, key): [r[key] for r in rows
                                       if r["side"] == side]
               for side in ("parent", "change")
               for key in ("k2_ms", "k3_ms")})), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
