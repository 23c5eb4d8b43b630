#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (falcon_tpu_torch) on one GPU.

    python3 chip_smoke.py [--genome-size N] [--block-mb M] [--seed S]
                          [--log FILE]

Phases, in order; any failure ends the run with a non-zero exit code:

  env       card name and power limit (nvidia-smi), torch / CUDA / nvcc
            versions, whether the host C++ library builds
  build     nvcc builds the port's kernels from csrc/ (build time, ptxas
            register and shared-memory counts)
  latency   a pointer chase (csrc/latency.cu) measures the latency of one
            dependent read from shared memory and from device memory, in
            SM clocks: what the chain floors below rest on
  k1        K1 (banded extension) against its plain twin on the card,
            bit-equal on (i, j, d) at W = 256 and W = 64, L = 1024, 4096,
            16384, at W = 32, 128 and 512 (the warp kernel's other bands)
            and at W = 96 (the block kernel); then bit-equal and timed at
            the (B, L) the pipeline's extender launches at L = 1024 and
            8192
  k2        K2 (forward DP, two-bit trace) against band_sweep on the cells
            each row swept, K3 (walk) against walk_back on the twin's
            trace, and the pair against align_tb_batch, all bit-equal, at
            the (B, L) DeviceCns._batch_for launches at L = 1024 and 16384
            and at (1024, 1024) and (256, 16384); K2 and K3 timed apart,
            each with its bound
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
            DeviceCns._dp_group_cap; then each timed (K5 with its clocks
            per column and the mean highest level in use); and K5 on
            adversarial counts (adversarial_counts) at D = 3, 14 and 16

Every timing line carries the kernel's bound: the larger of its bytes
(each input once, each output once) over 3.35 TB/s and its int32 operations
(this run's cells times the least operations the recurrence needs per cell,
whatever the implementation spends) over 64 lanes x 132 SMs x the SM clock
nvidia-smi reported during the phase.  A bound above the kernel's time
fails the run.  The timing line of a kernel that is one dependent chain
(K3, K5, K6) also carries the chain's floor, steps times the latency of the
memory its design reads per step as the `latency` phase measured it; the
floors stay out of the `kernels` line.

With FTPU_PROFILE=<absolute dir> both pipelines run under torch.profiler
and a `_device_time` line lists each run's device time by kernel.

An `imports` line reports that no jax and no falcon_tpu module was loaded
(else the run fails).  The line before the last is one JSON object
describing every kernel; the last line is {"ok": true, "device": {...}}.
Without a CUDA device the script exits non-zero before printing either.
"""
import argparse
import json
import logging
import os
import subprocess
import sys
import tempfile
import threading
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


PEAK_BYTES_S = 3.35e12          # H100 SXM HBM3
INT32_LANES = 64 * 132          # int32 lanes per clock on the card
# The least int32 operations the recurrence needs per DP cell, counted
# from D[i, j] = min(min(up, left) + 1, diag + (q != t)) and not from any
# kernel: the compare, the add of its result, two mins and the +1 for K1;
# those and the move's two bits (diag or not, up or left) for K2.
OPS_PER_CELL = {"K1": 5, "K2": 7}
OPS_PER_WALK_STEP = 30          # K3, csrc/align_tb.cu, per walked step
CHASE_STEPS = 4096              # dependent loads per latency measurement


class ClockSampler:
    """SM clock (MHz) as nvidia-smi reports it, sampled every 100 ms by one
    child process for as long as the object lives; peak() is the highest
    sample since the last mark()."""

    def __init__(self):
        self.samples = []
        self.proc = subprocess.Popen(
            ["nvidia-smi", "--query-gpu=clocks.sm",
             "--format=csv,noheader,nounits", "-lms", "100"],
            stdout=subprocess.PIPE, text=True)
        self.thread = threading.Thread(target=self._read, daemon=True)
        self.thread.start()
        self.start = 0

    def _read(self):
        for ln in self.proc.stdout:
            if ln.strip().isdigit():
                self.samples.append(int(ln))

    def mark(self):
        self.start = len(self.samples)

    def peak(self):
        got = self.samples[self.start:] or self.samples[-1:]
        if not got:
            raise SystemExit("nvidia-smi reported no SM clock")
        return max(got)

    def close(self):
        self.proc.terminate()
        self.proc.wait()


def bound_ms(nbytes, ops, clock_mhz):
    """(least milliseconds the card could take, which resource sets it) for
    work of nbytes through device memory and ops int32 operations."""
    t_bytes = nbytes / PEAK_BYTES_S * 1e3
    t_ops = ops / (INT32_LANES * clock_mhz * 1e6) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def chain_ms(steps, latency_clk, clock_mhz):
    """Floor of one dependent chain: steps x the measured latency of one
    dependent read (phase_latency), in milliseconds."""
    return steps * latency_clk / (clock_mhz * 1e6) * 1e3


def share_of_bound(what, ms, bnd):
    """bnd / ms; a bound above the measured time is a fault of the bound."""
    if bnd > ms:
        raise SystemExit("%s: bound %.4f ms above its time %.4f ms"
                         % (what, bnd, ms))
    return bnd / ms


def make_pairs(rng, B, L, W, edge=True):
    """[B, L] q/t code planes of read-vs-read extension tasks: t random,
    q = t at 8-15% error (equal substitutions, insertions, deletions),
    lengths in [L/2, L].  With edge, rows 0-5 are: both sides empty,
    q empty, t empty, a full-length pair, a pair whose path drifts off
    the band (a W-base insertion in q), and a pair of 150 bases."""
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
        q[5, 150:] = 4
        t[5, 150:] = 5
        ql[5] = min(ql[5], 150)
        tl[5] = 150
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
        host_native=simcheck.native.available(),
        host_native_dir=simcheck.native.BUILD_DIR)
    return card


def phase_build():
    from falcon_tpu_torch.ops import _build
    t0 = time.time()
    secs = _build.build()
    _build.lib()
    with open(_build.LOG_PATH) as f:
        ptxas = [ln.strip() for ln in f if "ptxas info" in ln]
    spills = [ln for ln in ptxas if "spill" in ln and
              "0 bytes spill stores, 0 bytes spill loads" not in ln]
    log(phase="build", compile_s=round(secs, 3),
        total_s=round(time.time() - t0, 3), ptxas=ptxas,
        kernels_with_spills=len(spills))


def phase_latency(card):
    """Clocks per dependent read by pointer chase, the least of three
    runs: in shared memory over a random cycle of 8192 words; in device
    memory at a stride of ~25 KB through a 512 MB buffer, each run from a
    start of its own, so that every load is a new line that L2 does not
    hold.  Returns {"shared": clocks, "global": clocks}."""
    from falcon_tpu_torch.ops import _build
    dev = torch.device("cuda")
    lib = _build.lib()
    out = torch.zeros(1, dtype=torch.int32, device=dev)
    clocks = torch.zeros(1, dtype=torch.int64, device=dev)

    def chase(nxt, n_shared):
        best = None
        for rep in range(3):
            _build.check(lib.ftt_chase(
                nxt.data_ptr(), n_shared, 64 * rep, CHASE_STEPS,
                out.data_ptr(), clocks.data_ptr(), _build.stream_of(nxt)),
                "chase")
            torch.cuda.synchronize()
            c = int(clocks) / CHASE_STEPS
            best = c if best is None else min(best, c)
        return best
    n = 8192
    order = torch.randperm(n, device=dev)
    cyc = torch.empty(n, dtype=torch.int32, device=dev)
    cyc[order] = order.roll(-1).to(torch.int32)
    shared = chase(cyc, n)
    n = 1 << 27
    far = ((torch.arange(n, device=dev) + 6421) % n).to(torch.int32)
    glob = chase(far, 0)
    del far
    torch.cuda.empty_cache()
    log(phase="latency", card=card, dependent_loads=CHASE_STEPS,
        shared_clk_per_load=shared, global_clk_per_load=glob)
    return {"shared": shared, "global": glob}


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


def phase_k1(rng, card, clock):
    """Parity at small batches of every band of the warp kernel and one
    of the block kernel, then parity, times and bounds at the (B, L) the
    pipeline's extender launches (its _batch_for).  Returns (max abs err,
    {L: timing dict})."""
    from falcon_tpu_torch.ops.align_cuda import extend_batch_cuda, kernel_for
    from falcon_tpu_torch.ops.align_device import band_cells, extend_batch
    from falcon_tpu_torch.overlap.engine import make_device_aligner
    err = 0
    for W, L, B in ((256, 1024, 96), (64, 1024, 64), (256, 4096, 64),
                    (64, 4096, 32), (256, 16384, 32), (32, 1024, 32),
                    (128, 1024, 32), (512, 1024, 32), (512, 4096, 32),
                    (96, 1024, 32)):
        args = make_pairs(rng, B, L, W)
        got = extend_batch_cuda(*args, W=W)
        ref = extend_batch(*args, W=W)
        torch.cuda.synchronize()
        err = max(err, k1_check(got, ref, W, L, B, kernel=kernel_for(W)))
    ext = make_device_aligner(W=W_MAIN, device="cuda").ext
    times = {}
    for L in (1024, 8192):
        B = ext._batch_for(L)
        args = make_pairs(rng, B, L, W_MAIN)
        clock.mark()
        got, ms = cuda_ms(lambda: extend_batch_cuda(*args, W=W_MAIN),
                          reps=3)
        mhz = clock.peak()
        ref, plain = cuda_ms(lambda: extend_batch(*args, W=W_MAIN))
        err = max(err, k1_check(got, ref, W_MAIN, L, B, main_path=True,
                                kernel=kernel_for(W_MAIN)))
        ql, tl = args[1].cpu().numpy(), args[3].cpu().numpy()
        cells = int(band_cells(ql, tl, W_MAIN).sum())
        bnd, by = bound_ms(2 * B * L + 8 * B + 12 * B,
                           cells * OPS_PER_CELL["K1"], mhz)
        times[L] = dict(B=B, ms=ms, plain_ms=plain, bound_ms=bnd,
                        bound_by=by)
        log(phase="k1_time", card=card, B=B, L=L, W=W_MAIN, kernel_ms=ms,
            plain_ms=plain, band_cells=cells, sm_clock_mhz=mhz,
            bound_ms=bnd, bound_by=by,
            share_of_bound=share_of_bound("K1 L=%d" % L, ms, bnd),
            lane_steps=int((ql + tl).sum()) * W_MAIN)
        del args, got, ref
        torch.cuda.empty_cache()
    return err, times


def swept_cells_equal(got, planes, ql, tl, W):
    """Whether two [S', B, W] move-plane stacks agree on every DP cell the
    rows swept: step s <= qlen + tlen, 0 <= i <= qlen, 0 <= j <= tlen.
    Returns (equal, cells compared)."""
    from falcon_tpu_torch.ops.align_device import band_off
    S = planes.shape[0]
    dev = planes.device
    lanes = torch.arange(W, device=dev)
    n = 0
    for s0 in range(0, S, 256):
        ss = torch.arange(s0 + 1, min(s0 + 256, S) + 1, device=dev)
        o = torch.tensor([band_off(int(x), W) for x in ss], device=dev)
        i = (o[:, None] + lanes)[:, None, :]               # [s, 1, W]
        j = ss[:, None, None] - i
        ok = (ss[:, None, None] <= (ql + tl)[None, :, None]) & \
            (i <= ql[None, :, None]) & (j >= 0) & (j <= tl[None, :, None])
        sl = slice(s0, s0 + len(ss))
        if not torch.equal(got[sl][ok], planes[sl][ok]):
            return False, n
        n += int(ok.sum())
    return True, n


def phase_k2(rng, card, clock, lat):
    """K2, K3 and the pair against their plain versions, bit-equal, then
    K2 and K3 timed apart (mean of 3 after a warm-up; every launch writes
    or reads a trace larger than L2) with bounds.  Returns (K2 err, K3
    err, {(B, L): timing dict})."""
    from falcon_tpu_torch.cns.device import DeviceCns
    from falcon_tpu_torch.ops import align_tb_cuda as k
    from falcon_tpu_torch.ops.align_device import band_cells, band_sweep
    from falcon_tpu_torch.ops.align_tb import (pack_moves, pack_trace,
                                               unpack_trace, walk_back)
    cns = DeviceCns(device="cuda")
    shapes = [(cns._batch_for(1024), 1024), (cns._batch_for(16384), 16384),
              (1024, 1024), (256, 16384)]
    err2 = err3 = 0
    times = {}
    for B, L in shapes:
        args = make_pairs(rng, B, L, W_MAIN)
        q, ql, t, tl = args
        # the plain versions, each run (and timed) once
        (p_ends, planes), p_fwd = cuda_ms(
            lambda: band_sweep(*args, W_MAIN, 3, keep_moves=True),
            warm=False)
        (p_moves, p_bases), p_bwd = cuda_ms(
            lambda: walk_back(q, p_ends, planes, W_MAIN), warm=False)
        p_packed = pack_moves(p_moves)
        del p_moves
        # K2 alone: ends, and the decoded trace on the swept cells
        ends, trace = k.tb_forward_cuda(*args, W_MAIN, 3)
        torch.cuda.synchronize()
        e2 = max_err([ends], [p_ends])
        got_planes = unpack_trace(trace, W_MAIN)
        same, n_cells = swept_cells_equal(got_planes, planes, ql, tl, W_MAIN)
        del got_planes, trace
        # K3 alone, on the plain sweep's trace and ends
        p_trace = pack_trace(planes, L)
        del planes
        moves, bases = k.tb_backward_cuda(p_trace, p_ends, q, W_MAIN)
        torch.cuda.synchronize()
        e3 = max_err([moves, bases], [p_packed, p_bases])
        del p_trace, moves, bases
        # the pair through the wrapper
        pair = k.align_tb_batch_cuda(*args, W=W_MAIN)
        torch.cuda.synchronize()
        e23 = max_err(pair, list(p_ends) + [p_packed, p_bases])
        log(phase="k2_k3_parity", W=W_MAIN, L=L, B=B, k2_ends_max_abs_err=e2,
            k2_trace_equal=same, k2_trace_cells=n_cells,
            k3_max_abs_err=e3, pair_max_abs_err=e23)
        if e2 or e3 or e23 or not same:
            raise SystemExit("K2/K3 differ from their plain versions at "
                             "B=%d L=%d" % (B, L))
        err2, err3 = max(err2, e2), max(err3, e3, e23)
        del pair, p_packed, p_bases
        clock.mark()
        (ends, trace), fwd = cuda_ms(
            lambda: k.tb_forward_cuda(*args, W_MAIN, 3), reps=3)
        (mv, _), bwd = cuda_ms(
            lambda: k.tb_backward_cuda(trace, ends, q, W_MAIN), reps=3)
        mhz = clock.peak()
        del trace
        qn, tn = ql.cpu().numpy(), tl.cpu().numpy()
        cells = int(band_cells(qn, tn, W_MAIN).sum())
        steps = np.minimum(qn + tn, 2 * L)
        trace_bytes = int(steps.sum()) * W_MAIN // 4
        b2, by2 = bound_ms(2 * B * L + 8 * B + 12 * B + trace_bytes,
                           cells * OPS_PER_CELL["K2"], mhz)
        # K3's work is its walks, each step made once: the steps this run
        # walked are the moves other than 3 (filler, or behind a diag) in
        # its output.  A step reads one 4-byte trace word and at most one
        # q byte (the i of the end cell counts them); the ends are read
        # and both streams written whole.
        walked = sum(int((((mv >> sh) & 3) != 3).sum()) for sh in (0, 2, 4, 6))
        b3, by3 = bound_ms(4 * walked + int(ends[0].sum()) + 12 * B +
                           2 * L * B * 5 // 4, walked * OPS_PER_WALK_STEP,
                           mhz)
        longest = int((ends[0] + ends[1]).max())   # anti-diagonals, one row
        c3 = chain_ms(longest, lat["shared"], mhz)
        times[(B, L)] = dict(
            K2=dict(ms=fwd, plain_ms=p_fwd, bound_ms=b2, bound_by=by2),
            K3=dict(ms=bwd, plain_ms=p_bwd, bound_ms=b3, bound_by=by3))
        log(phase="k2_k3_time", card=card, B=B, L=L, W=W_MAIN,
            sm_clock_mhz=mhz, k2_ms=fwd, k2_plain_ms=p_fwd, k2_bound_ms=b2,
            k2_bound_by=by2,
            k2_share_of_bound=share_of_bound("K2 %dx%d" % (B, L), fwd, b2),
            band_cells=cells, trace_bytes=trace_bytes,
            trace_alloc_bytes=B * k.trace_row_bytes(L, W_MAIN),
            k3_ms=bwd, k3_plain_ms=p_bwd, k3_bound_ms=b3, k3_bound_by=by3,
            k3_share_of_bound=share_of_bound("K3 %dx%d" % (B, L), bwd, b3),
            k3_chain_floor_ms=c3, walked_steps=walked,
            longest_walk_diagonals=longest)
        del args, q, ql, t, tl, ends, mv
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
    prof = os.environ.get("FTPU_PROFILE")
    if prof:
        # the profiled run's device time by kernel, largest first:
        # {name: [launches, seconds]}
        with open(os.path.join(prof, "device_time.json")) as f:
            log(phase=name + "_device_time",
                by_kernel=dict(list(json.load(f).items())[:12]))
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


def adversarial_counts(rng, G, T, D):
    """A count buffer (numpy uint16, ops.cns_dp's flat layout) made to
    break a consensus scan that skips levels or orders ties wrongly.  Counts
    are 0 (half of them) or 1-3, so equal scores abound.  Columns cycle
    through: only delta 0; every level up to D - 1 (the level in use jumps
    from 0 to D - 1 between neighbours); nothing at all; a random top
    level; one isolated level above an empty delta 0."""
    from falcon_tpu_torch.ops import cns_dp
    l0 = rng.integers(1, 4, (G, T, 5 * cns_dp.NPC0)) * \
        (rng.random((G, T, 5 * cns_dp.NPC0)) < 0.5)
    ld = rng.integers(1, 4, (G, T, D - 1, 5 * cns_dp.NPCD)) * \
        (rng.random((G, T, D - 1, 5 * cns_dp.NPCD)) < 0.5)
    kind = (np.arange(T)[None, :] + rng.integers(0, 5, (G, 1))) % 5
    level = np.arange(1, D)[None, None, :]
    pick = rng.integers(1, D, (G, T))
    top = np.select([kind == 0, kind == 1, kind == 2, kind == 3],
                    [0, D - 1, 0, pick], pick)[:, :, None]
    keep = np.where((kind == 4)[:, :, None], level == top, level <= top)
    ld *= keep[:, :, :, None]
    l0 *= ((kind != 2) & (kind != 4))[:, :, None]
    return np.concatenate([l0.ravel(), ld.ravel(), [0]]).astype(np.uint16)


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


def mean_dmax(msa, G, T, D):
    """Mean over a count buffer's G * T columns of the highest delta level
    that holds any count (0: delta 0 alone): the levels K5's chain runs."""
    from falcon_tpu_torch.ops import cns_dp
    ld = msa[cns_dp.l0_size(G, T):-1].view(torch.int16).view(
        G, T, D - 1, 5 * cns_dp.NPCD)
    total = 0
    for g0 in range(0, G, 32):           # a slice of groups at a time
        used = (ld[g0:g0 + 32] != 0).any(3)
        level = torch.arange(1, D, device=msa.device) * used
        total += int(level.amax(2).sum())
    return total / (G * T)


def phase_k5_adversarial(rng):
    """K5 against its twin on adversarial_counts at D = 3, 14 and 16, all
    six outputs bit-equal.  Returns the max abs err."""
    from falcon_tpu_torch.ops import cns_dp
    from falcon_tpu_torch.ops import cns_dp_cuda as k
    worst = 0.0
    for D, G, T in ((3, 7, 193), (14, 9, 257), (16, 6, 160)):
        host = adversarial_counts(rng, G, T, D)
        msa = torch.from_numpy(host.view(np.int16)).cuda().view(torch.uint16)
        got = k.consensus_scan_cuda(msa, G, T, D)
        ref = cns_dp.consensus_scan(msa, G, T, D)
        torch.cuda.synchronize()
        err, eq = dp_equal(got, ref)
        log(phase="k5_adversarial", D=D, G=G, T=T, max_abs_err=err,
            bit_equal=eq, mean_dmax=mean_dmax(msa, G, T, D),
            empty_columns=int((got[1] == 0).sum()))
        if not eq:
            names = ("bp", "cov", "gb_s", "gb_t", "gb_d", "gb_b")
            raise SystemExit("K5 differs from its twin on adversarial counts"
                             " at D=%d: %s" % (D, [
                                 n for n, a, b in zip(names, got, ref)
                                 if not torch.equal(a, b)]))
        worst = max(worst, err)
    return worst


def phase_dp_kernels(rng, card, clock, lat, buckets, min_cov=2,
                     min_idt=0.70):
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
    errs = {"K4": 0.0, "K5": phase_k5_adversarial(rng), "K6": 0.0}
    times = {}
    for T in buckets:
        G = cns._dp_group_cap(T)
        L = min(T // 2, 16384)
        msa0, rest = dp_batch(rng, G, T, L, D, max_diff)

        def fresh():
            return msa0.view(torch.int16).clone().view(torch.uint16)
        clock.mark()
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
        mhz = clock.peak()
        tags = int(c_got[:-1].sum()) - int(cns_dp.counts_i32(msa0).sum())
        rows = rest[0].shape[1]
        # K4: both streams and the row vectors read, one 32-bit count word
        # read and written per tag; K5: the counts read, pred plane and
        # coverage written; K6: one pred byte read per step, the emitted
        # rows written.  Their arithmetic is far below their bytes.
        b4, by4 = bound_ms(rest[0].numel() + rest[1].numel() + 12 * rows +
                           8 * tags, 0, mhz)
        b5, by5 = bound_ms(G * T * (2 * (5 * cns_dp.NPC0 + (D - 1) * 5 *
                                         cns_dp.NPCD) + D * 5 + 4), 0, mhz)
        steps6 = [x + T for x in n]          # emissions plus column moves
        b6, by6 = bound_ms(sum(steps6) + G * 2 * T + 4 * G, 0, mhz)
        c5 = chain_ms(T, lat["shared"], mhz)
        c6 = chain_ms(max(steps6), lat["global"], mhz)
        log(phase="dp_kernels", card=card, T=T, G=G, D=D, L=L,
            rows=rows, tags=tags, sm_clock_mhz=mhz,
            k4_bound_ms=b4, k4_bound_by=by4, k5_bound_ms=b5, k5_bound_by=by5,
            k5_chain_floor_ms=c5, k5_steps=T,
            k5_clk_per_step=t5 * mhz * 1e3 / T,
            k5_mean_dmax=mean_dmax(got, G, T, D), k6_bound_ms=b6,
            k6_bound_by=by6, k6_chain_floor_ms=c6,
            k6_longest_walk_steps=max(steps6),
            k4_share_of_bound=share_of_bound("K4 T=%d" % T, t4, b4),
            k5_share_of_bound=share_of_bound("K5 T=%d" % T, t5, b5),
            k6_share_of_bound=share_of_bound("K6 T=%d" % T, t6, b6),
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
        times[T] = {
            "K4": dict(ms=t4, plain_ms=p4, bound_ms=b4, bound_by=by4),
            "K5": dict(ms=t5, plain_ms=p5, bound_ms=b5, bound_by=by5),
            "K6": dict(ms=t6, plain_ms=p6, bound_ms=b6, bound_by=by6)}
        del msa0, rest, got, scan, lad, walk, ref
        torch.cuda.empty_cache()
    return errs, times


def run_phases(args, rng, card, clock):
    """Every phase after env, in order; returns the kernels list."""
    phase_build()
    lat = phase_latency(card)
    e1, t1 = phase_k1(rng, card, clock)
    e2, e3, t2 = phase_k2(rng, card, clock, lat)
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
    e_dp, t_dp = phase_dp_kernels(rng, card, clock, lat, buckets)
    t_tb = t2[max(t2, key=lambda bl: (bl[1], bl[0]))]   # largest L bucket
    t_top = t_dp[buckets[-1]]
    rows = [("K1 banded extension", "extend.cu",
             "falcon_tpu/ops/align_pallas.py:50", launches["K1"], e1,
             t1[1024]),
            ("K2 traceback forward", "align_tb.cu",
             "falcon_tpu/ops/align_tb_pallas.py:39", launches["K2"], e2,
             t_tb["K2"]),
            ("K3 traceback walk", "align_tb.cu",
             "falcon_tpu/ops/align_tb_pallas.py:151", launches["K3"], e3,
             t_tb["K3"])]
    rows += [(name, "cns_dp.cu", "falcon_tpu/ops/cns_dp.py:%d" % line,
              launches_dp[kk], e_dp[kk], t_top[kk])
             for kk, name, line in (("K4", "K4 tag accumulation", 203),
                                    ("K5", "K5 consensus scan", 456),
                                    ("K6", "K6 backtrack walk", 562))]
    # no single PyTorch call computes a banded edit DP, a traceback walk,
    # the tag decode-and-scatter, the consensus chain or its walk
    return [dict(name=name, route="cuda",
                 source="falcon_tpu_torch/csrc/" + src, replaces=repl,
                 launches=n, max_abs_err=err, ms=t["ms"],
                 plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                 bound_by=t["bound_by"], library_ms=None)
            for name, src, repl, n, err, t in rows]


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
    clock = ClockSampler()
    try:
        kernels = run_phases(args, rng, card, clock)
    finally:
        clock.close()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "falcon_tpu"))
    log(phase="imports", jax_or_falcon_tpu_modules=loaded)
    if loaded:
        raise SystemExit("the port loaded %s" % loaded)
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
