#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (falcon_tpu_torch) on one GPU.

    python3 chip_smoke.py [--genome-size N] [--block-mb M] [--seed S]
                          [--log FILE]

Phases, in order; any failure ends the run with a non-zero exit code:

  env       card name and power limit (nvidia-smi), torch / CUDA / nvcc
            versions, whether the host C++ library builds
  build     nvcc builds the port's kernels from csrc/ (build time, ptxas
            register and shared-memory counts)
  k1        K1 (banded extension) against its plain twin on the card,
            bit-equal on (i, j, d) at W = 256 and W = 64, L = 1024, 4096,
            16384; then bit-equal and timed at the (B, L) the pipeline's
            extender launches at L = 1024 and 8192
  k2        K2 + K3 (alignment with traceback) against their plain twin,
            bit-equal on (i, j, d, packed moves, bases) at the consensus
            shapes; then both timed
  pipeline  the port's Pipeline on a simulated genome (24x coverage, 9 kb
            mean reads, 8% error), host-MSA consensus: timings, occupancy,
            kernel launch counts (K1-K3 must be > 0, K4-K6 0), contigs,
            genome recovery (>= 0.95) and sampled identity (>= 0.995)
  pipeline_dp  the same on the same genome with FTPU_CNS_DP=1, the
            device-DP consensus: every kernel K1-K6 must launch, the same
            bars; its phase walls beside the host-MSA run's
  dp_kernels  K4 (tags), K5 (consensus scan) and K6 (backtrack walk)
            against their plain twins on the card, bit-equal, at the
            smallest and largest T bucket the DP pipeline ran, with G from
            DeviceCns._dp_group_cap; then each timed

The line before the last is one JSON object describing every kernel; the
last line is {"ok": true, "device": {...}}.  Without a CUDA device the
script exits non-zero before printing either.  It imports no JAX.
"""
import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

W_MAIN = 256


def log(**kv):
    print(json.dumps(kv), flush=True)


def cuda_ms(fn, reps=1, warm=True):
    """(output of the last call, mean milliseconds per call on the card by
    CUDA events) of fn(), after one warm-up call (warm)."""
    if warm:
        fn()
    torch.cuda.synchronize()
    e0 = torch.cuda.Event(enable_timing=True)
    e1 = torch.cuda.Event(enable_timing=True)
    e0.record()
    for _ in range(reps):
        out = fn()
    e1.record()
    e1.synchronize()
    return out, e0.elapsed_time(e1) / reps


def make_pairs(rng, B, L, W, edge=True):
    """[B, L] q/t code planes of read-vs-read extension tasks: t random,
    q = t at 8-15% error (equal substitutions, insertions, deletions),
    lengths in [L/2, L].  With edge, rows 0-4 are: both sides empty,
    q empty, t empty, a full-length pair, and a pair whose path drifts
    off the band (a W-base insertion in q)."""
    q = np.full((B, L), 4, np.int8)
    t = np.full((B, L), 5, np.int8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(L // 2, L + 1))
        tt = rng.integers(0, 4, n, dtype=np.int8)
        e = rng.uniform(0.08, 0.15) / 3
        r = rng.random(n)
        qq = tt.copy()
        sub = r < e
        qq[sub] = (qq[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        ins = np.nonzero((r >= e) & (r < 2 * e))[0]
        qq = np.insert(qq, ins, rng.integers(0, 4, len(ins), dtype=np.int8))
        keep = rng.random(len(qq)) >= e
        qq = qq[keep][:L]
        q[b, :len(qq)] = qq
        t[b, :n] = tt
        ql[b], tl[b] = len(qq), n
    if edge:
        q[:5] = 4
        t[:5] = 5
        ql[:5] = tl[:5] = 0
        t[1, :L // 2] = rng.integers(0, 4, L // 2)
        tl[1] = L // 2
        q[2, :L // 2] = rng.integers(0, 4, L // 2)
        ql[2] = L // 2
        q[3] = t[3] = rng.integers(0, 4, L)
        ql[3] = tl[3] = L
        base = rng.integers(0, 4, L // 2, dtype=np.int8)
        qq = np.concatenate([base[:L // 8],
                             rng.integers(0, 4, W, dtype=np.int8),
                             base[L // 8:]])[:L]
        q[4, :len(qq)] = qq
        ql[4] = len(qq)
        t[4, :len(base)] = base
        tl[4] = len(base)
    dev = torch.device("cuda")
    return [torch.from_numpy(a).to(dev) for a in (q, ql, t, tl)]


def max_err(got, ref):
    return max(int((g.long() - r.long()).abs().max()) if g.numel() else 0
               for g, r in zip(got, ref))


def phase_env():
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], check=True, capture_output=True,
        text=True).stdout.strip().splitlines()[0]
    print(card, flush=True)
    from falcon_tpu_torch.ops import _build
    nvcc = subprocess.run([_build._nvcc(), "--version"], check=True,
                          capture_output=True, text=True).stdout
    from falcon_tpu_torch.utils import simcheck
    log(phase="env", card=card, torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0],
        nvcc=[ln for ln in nvcc.splitlines() if "release" in ln][0],
        device_count=torch.cuda.device_count(),
        host_native=simcheck.native.available())
    return card


def phase_build():
    from falcon_tpu_torch.ops import _build
    t0 = time.time()
    secs = _build.build()
    _build.lib()
    with open(_build.LOG_PATH) as f:
        ptxas = [ln.strip() for ln in f if "ptxas info" in ln]
    log(phase="build", compile_s=round(secs, 3),
        total_s=round(time.time() - t0, 3), ptxas=ptxas)


def k1_check(got, ref, W, L, B, **kv):
    """Bit-equality of K1 and its twin; logs and raises on a difference."""
    e = max_err(got, ref)
    log(phase="k1_parity", W=W, L=L, B=B, max_abs_err=e,
        bit_equal=bool(torch.equal(got, ref)), **kv)
    if e:
        bad = (got != ref).any(0).nonzero()[:5, 0].tolist()
        raise SystemExit("K1 differs from its twin at W=%d L=%d B=%d rows "
                         "%s: kernel %s plain %s" % (
                             W, L, B, bad, got[:, bad].tolist(),
                             ref[:, bad].tolist()))
    return e


def phase_k1(rng, card):
    """Parity at small batches of both widths, then parity and times at
    the (B, L) the pipeline's extender launches (its _batch_for)."""
    from falcon_tpu_torch.ops.align_cuda import extend_batch_cuda
    from falcon_tpu_torch.ops.align_device import extend_batch
    from falcon_tpu_torch.overlap.engine import make_device_aligner
    err = 0
    for W, L, B in ((256, 1024, 96), (64, 1024, 64), (256, 4096, 64),
                    (64, 4096, 32), (256, 16384, 32)):
        args = make_pairs(rng, B, L, W)
        got = extend_batch_cuda(*args, W=W)
        ref = extend_batch(*args, W=W)
        torch.cuda.synchronize()
        err = max(err, k1_check(got, ref, W, L, B))
    ext = make_device_aligner(W=W_MAIN, device="cuda").ext
    times = {}
    for L in (1024, 8192):
        B = ext._batch_for(L)
        args = make_pairs(rng, B, L, W_MAIN)
        got, ms = cuda_ms(lambda: extend_batch_cuda(*args, W=W_MAIN),
                          reps=3)
        ref, plain = cuda_ms(lambda: extend_batch(*args, W=W_MAIN))
        err = max(err, k1_check(got, ref, W_MAIN, L, B, main_path=True))
        cells = int((args[1] + args[3]).sum()) * W_MAIN
        times[L] = (B, ms, plain)
        log(phase="k1_time", card=card, B=B, L=L, W=W_MAIN, kernel_ms=ms,
            plain_ms=plain, lane_steps=cells,
            kernel_glane_steps_per_s=cells / ms / 1e6)
        del args, got, ref
        torch.cuda.empty_cache()
    return err, times


def phase_k2(rng, card):
    from falcon_tpu_torch.ops import align_tb_cuda as k
    from falcon_tpu_torch.ops.align_device import band_sweep
    from falcon_tpu_torch.ops.align_tb import align_tb_batch, walk_back
    err2 = err3 = 0
    times = {}
    for B, L in ((1024, 1024), (256, 16384)):
        args = make_pairs(rng, B, L, W_MAIN)
        got = k.align_tb_batch_cuda(*args, W=W_MAIN)
        ref = align_tb_batch(*args, W=W_MAIN)
        torch.cuda.synchronize()
        e2 = max_err(got[:3], ref[:3])
        e3 = max_err(got[3:], ref[3:])
        log(phase="k2_k3_parity", W=W_MAIN, L=L, B=B, ends_max_abs_err=e2,
            moves_bases_max_abs_err=e3)
        if e2 or e3:
            raise SystemExit("K2/K3 differ from their twin at B=%d L=%d"
                             % (B, L))
        err2, err3 = max(err2, e2), max(err3, e3)
        (ends, trace), fwd = cuda_ms(
            lambda: k.tb_forward_cuda(*args, W_MAIN, 3), reps=3)
        _, bwd = cuda_ms(lambda: k.tb_backward_cuda(trace, ends, W_MAIN),
                         reps=3)
        del trace
        (p_ends, planes), p_fwd = cuda_ms(
            lambda: band_sweep(*args, W_MAIN, 3, keep_moves=True))
        _, p_bwd = cuda_ms(
            lambda: walk_back(args[0], p_ends, planes, W_MAIN))
        del planes
        times[(B, L)] = (fwd, p_fwd, bwd, p_bwd)
        log(phase="k2_k3_time", card=card, B=B, L=L, W=W_MAIN,
            k2_ms=fwd, k2_plain_ms=p_fwd, k3_ms=bwd, k3_plain_ms=p_bwd,
            trace_bytes=2 * L * B * W_MAIN)
        torch.cuda.empty_cache()
    return err2, err3, times


def counters():
    """Every kernel's launch counter, by kernel: (LAUNCHES dict, key)."""
    from falcon_tpu_torch.ops import align_cuda, align_tb_cuda, cns_dp_cuda
    return {"K1": (align_cuda.LAUNCHES, "extend"),
            "K2": (align_tb_cuda.LAUNCHES, "tb_fwd"),
            "K3": (align_tb_cuda.LAUNCHES, "tb_bwd"),
            "K4": (cns_dp_cuda.LAUNCHES, "tags"),
            "K5": (cns_dp_cuda.LAUNCHES, "cns_scan"),
            "K6": (cns_dp_cuda.LAUNCHES, "cns_walk")}


def phase_pipeline(args, workdir, dp):
    """The port's Pipeline on the simulated genome, consensus through the
    device-DP path (dp) or the host-MSA path; returns (launches by kernel,
    timings).  The DP run must launch every kernel, the host-MSA run
    K1-K3 and none of K4-K6."""
    from falcon_tpu_torch.pipeline.driver import Pipeline
    from falcon_tpu_torch.utils import simcheck
    name = "pipeline_dp" if dp else "pipeline"
    t0 = time.time()
    genome = simcheck.write_sim_run(
        workdir, args.genome_size, coverage=24, mean_len=9000, error=0.08,
        seed=args.seed, block_mb=args.block_mb)
    log(phase=name + "_sim", genome_size=args.genome_size,
        block_mb=args.block_mb, seed=args.seed,
        sim_s=round(time.time() - t0, 3))
    cnt = counters()
    for d, key in cnt.values():
        d[key] = 0
    env = os.environ.get("FTPU_CNS_DP")
    os.environ["FTPU_CNS_DP"] = "1" if dp else "0"
    t0 = time.time()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        pipe = Pipeline("fc_run.cfg", workdir, device="cuda")
        p_ctg = pipe.run()
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        if env is None:
            del os.environ["FTPU_CNS_DP"]
        else:
            os.environ["FTPU_CNS_DP"] = env
    launches = {k: d[key] for k, (d, key) in cnt.items()}
    log(phase=name + "_timings", wall_s=round(time.time() - t0, 3),
        **pipe.timings)
    log(phase=name + "_launches", **launches)
    score = simcheck.score_assembly(p_ctg, genome)
    log(phase=name + "_assembly", **score)
    need = list(launches) if dp else ["K1", "K2", "K3"]
    if min(launches[k] for k in need) < 1 or \
            (not dp and any(launches[k] for k in ("K4", "K5", "K6"))):
        raise SystemExit("%s: kernels launched %s" % (name, launches))
    if score["recovery"] < 0.95 or not score["mean_identity"] or \
            score["mean_identity"] < 0.995:
        raise SystemExit("%s: assembly below bar: recovery %.4f identity %s"
                         % (name, score["recovery"], score["mean_identity"]))
    return launches, pipe.timings


def dp_batch(rng, G, T, L, D, max_diff):
    """One DP batch's K4 input at (G, T), on the card: the self tags of
    random seeds (none for group G - 1, which stays empty), and 2G
    make_pairs rows at L aligned by K2 + K3, row b in group b % (G - 1) at
    a seed offset s2 in [0, T - L/4), so that some rows run past T.  The
    rows of groups 1 and 2 open with 5-12 inserted bases, at s2 = 0 for
    group 1 (tpos < 0 drops each such row) and s2 >= 1 for group 2.
    Returns (counts, K4's arguments after the count buffer)."""
    from falcon_tpu_torch.ops import cns_dp
    from falcon_tpu_torch.ops.align_tb_cuda import align_tb_batch_cuda
    dev = torch.device("cuda")
    B = 2 * G
    q, ql, t, tl = make_pairs(rng, B, L, W_MAIN)
    gidx = np.arange(B, dtype=np.int32) % (G - 1)
    s2 = rng.integers(0, T - L // 4, B).astype(np.int32)
    for b in np.nonzero((gidx == 1) | (gidx == 2))[0]:
        k = int(rng.integers(5, 13))
        n = min(int(ql[b]) + k, L)
        q[b, k:n] = q[b, :n - k].clone()
        q[b, :k] = torch.from_numpy(rng.integers(0, 4, k, dtype=np.int8))
        ql[b] = n
        s2[b] = 0 if gidx[b] == 1 else max(1, s2[b])
    _, _, bd, mvp, bases = align_tb_batch_cuda(q, ql, t, tl, W=W_MAIN)
    seeds = rng.integers(0, 4, (G, T), dtype=np.int8)
    tlens = rng.integers(T // 2, T + 1, G).astype(np.int32)
    tlens[G - 1] = 0
    msa = cns_dp.add_self_tags(cns_dp.alloc_msa(G, T, D, dev),
                               torch.from_numpy(seeds).to(dev),
                               torch.from_numpy(tlens).to(dev), T)
    return msa, (mvp, bases, bd, torch.from_numpy(gidx).to(dev),
                 torch.from_numpy(s2).to(dev), max_diff, T, D)


def ladder_walk(scan, g, T, D):
    """Point group g of a scan's outputs at a pred ladder that visits every
    delta level of every column (stay codes at d >= 1, jumps to d = D - 1
    at d = 0, the start at t = 0): its walk emits 2T codes."""
    bp, cov, gb_s, gb_t, gb_d, gb_b = (x.clone() for x in scan)
    d = torch.arange(D, device=bp.device).repeat_interleave(5)
    b = torch.arange(5, device=bp.device).repeat(D)
    bp[:, g] = torch.where(d == 0, (D - 1) * 5 + b, 128 + b).to(torch.uint8)
    bp[0, g, :5] = 254
    gb_s[g], gb_t[g], gb_d[g], gb_b[g] = 1.0, T - 1, D - 1, 2
    return bp, cov, gb_s, gb_t, gb_d, gb_b


def dp_equal(got, ref):
    """(max abs difference over paired tensors, all bit-equal)."""
    err = max(float((g.double() - r.double()).abs().max()) if g.numel()
              else 0.0 for g, r in zip(got, ref))
    return err, all(torch.equal(g, r) for g, r in zip(got, ref))


def phase_dp_kernels(rng, card, buckets, min_cov=2, min_idt=0.70):
    """K4, K5 and K6 bit-equal to their twins at each T bucket, G from the
    port's _dp_group_cap, then timed (kernels by cuda_ms, twins once).
    K6 runs on the scan's outputs with group G - 2 moved onto a 2T-code
    ladder.  Returns ({kernel: max abs err}, {T: times})."""
    from falcon_tpu_torch.cns.device import DeviceCns
    from falcon_tpu_torch.ops import cns_dp
    from falcon_tpu_torch.ops import cns_dp_cuda as k
    cns = DeviceCns(device="cuda", use_dp=True)
    D = cns.dp_delta_cap
    max_diff = np.float32(1.0 - min_idt)
    errs = {"K4": 0.0, "K5": 0.0, "K6": 0.0}
    times = {}
    for T in buckets:
        G = cns._dp_group_cap(T)
        L = min(T // 2, 16384)
        msa0, rest = dp_batch(rng, G, T, L, D, max_diff)

        def fresh():
            return msa0.view(torch.int16).clone().view(torch.uint16)
        got = k.accumulate_tags_planes_cuda(fresh(), *rest)
        ref, p4 = cuda_ms(lambda: cns_dp.accumulate_tags_planes(
            fresh(), *rest), warm=False)
        c_got, c_ref = cns_dp.counts_i32(got), cns_dp.counts_i32(ref)
        e4, eq4 = dp_equal([c_got[:-1]], [c_ref[:-1]])
        scratch = fresh()
        _, t4 = cuda_ms(lambda: k.accumulate_tags_planes_cuda(scratch,
                                                              *rest), reps=3)
        del ref, c_ref, scratch
        scan, t5 = cuda_ms(lambda: k.consensus_scan_cuda(got, G, T, D),
                           reps=3)
        ref, p5 = cuda_ms(lambda: cns_dp.consensus_scan(got, G, T, D),
                          warm=False)
        e5, eq5 = dp_equal(scan, ref)
        del ref
        lad = ladder_walk(scan, G - 2, T, D)
        walk, t6 = cuda_ms(lambda: k.backtrack_walk_cuda(*lad, min_cov, G, T,
                                                         D), reps=3)
        ref, p6 = cuda_ms(lambda: cns_dp.backtrack_walk(*lad, min_cov, G, T,
                                                        D), warm=False)
        e6, eq6 = dp_equal(walk, ref)
        n = walk[1].tolist()
        log(phase="dp_kernels", card=card, T=T, G=G, D=D, L=L,
            rows=rest[0].shape[1], tags=int(c_got[:-1].sum()) - int(
                cns_dp.counts_i32(msa0).sum()),
            k4_max_abs_err=e4, k4_bit_equal=eq4, k5_max_abs_err=e5,
            k5_bit_equal=eq5, k6_max_abs_err=e6, k6_bit_equal=eq6,
            emitted_min=min(n), emitted_max=max(n),
            k4_ms=t4, k4_plain_ms=p4, k5_ms=t5, k5_plain_ms=p5, k6_ms=t6,
            k6_plain_ms=p6)
        if not (eq4 and eq5 and eq6):
            raise SystemExit("K4/K5/K6 differ from their twins at T=%d G=%d:"
                             " %s %s %s" % (T, G, e4, e5, e6))
        if n[G - 1] != 0 or n[G - 2] != 2 * T:
            raise SystemExit("K6: empty group emitted %d, ladder group %d "
                             "of %d" % (n[G - 1], n[G - 2], 2 * T))
        errs = {"K4": max(errs["K4"], e4), "K5": max(errs["K5"], e5),
                "K6": max(errs["K6"], e6)}
        times[T] = {"K4": (t4, p4), "K5": (t5, p5), "K6": (t6, p6)}
        del msa0, rest, got, scan, lad, walk, ref
        torch.cuda.empty_cache()
    return errs, times


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-size", type=int, default=1_000_000)
    ap.add_argument("--block-mb", type=float, default=10)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--log", default=None,
                    help="write the pipeline's INFO log to this file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 1
    if args.log:
        logging.basicConfig(
            filename=args.log, level=logging.INFO,
            format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    rng = np.random.default_rng(args.seed)
    card = phase_env()
    phase_build()
    e1, t1 = phase_k1(rng, card)
    e2, e3, t2 = phase_k2(rng, card)
    with tempfile.TemporaryDirectory() as d:
        launches, host_t = phase_pipeline(args, d, dp=False)
    with tempfile.TemporaryDirectory() as d:
        launches_dp, dp_t = phase_pipeline(args, d, dp=True)
    log(phase="pipeline_compare", card=card, **{
        key: {"host_msa": host_t.get(key), "device_dp": dp_t.get(key)}
        for key in ("phase0_masking", "phase0_overlap", "phase0_consensus",
                    "phase1_overlap", "phase2_graph", "total")})
    buckets = sorted(dp_t["phase0_cns_dp_batches"])
    buckets = sorted({buckets[0], buckets[-1]})
    log(phase="dp_buckets", hit=dp_t["phase0_cns_dp_batches"],
        checked=buckets)
    e_dp, t_dp = phase_dp_kernels(rng, card, buckets)
    _, ms, plain = t1[1024]
    fwd, p_fwd, bwd, p_bwd = t2[(1024, 1024)]
    t_top = t_dp[buckets[-1]]
    kernels = [
        dict(name="K1 banded extension", route="cuda",
             source="falcon_tpu_torch/csrc/extend.cu",
             replaces="falcon_tpu/ops/align_pallas.py:50",
             launches=launches["K1"], max_abs_err=e1, ms=ms,
             plain_ms=plain),
        dict(name="K2 traceback forward", route="cuda",
             source="falcon_tpu_torch/csrc/align_tb.cu",
             replaces="falcon_tpu/ops/align_tb_pallas.py:39",
             launches=launches["K2"], max_abs_err=e2, ms=fwd,
             plain_ms=p_fwd),
        dict(name="K3 traceback walk", route="cuda",
             source="falcon_tpu_torch/csrc/align_tb.cu",
             replaces="falcon_tpu/ops/align_tb_pallas.py:151",
             launches=launches["K3"], max_abs_err=e3, ms=bwd,
             plain_ms=p_bwd),
    ] + [
        dict(name=name, route="cuda",
             source="falcon_tpu_torch/csrc/cns_dp.cu",
             replaces="falcon_tpu/ops/cns_dp.py:%d" % line,
             launches=launches_dp[kk], max_abs_err=e_dp[kk],
             ms=t_top[kk][0], plain_ms=t_top[kk][1])
        for kk, name, line in (("K4", "K4 tag accumulation", 203),
                               ("K5", "K5 consensus scan", 456),
                               ("K6", "K6 backtrack walk", 562))]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
