#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (falcon_tpu_torch) on one GPU.

    python3 chip_smoke.py [--genome-size N] [--block-mb M] [--seed S]
                          [--log FILE]

Phases, in order; any failure ends the run with a non-zero exit code:

  env       card name and power limit (nvidia-smi), torch / CUDA / nvcc
            versions, whether the host C++ library builds
  build     nvcc builds the port's kernels from csrc/ (build time, ptxas
            register and shared-memory counts, the kernels that spill
            registers); a K1 kernel that spills fails the run
  latency   a pointer chase (csrc/latency.cu) measures the latency of one
            dependent read from shared memory and from device memory, in
            SM clocks: what the chain floors below rest on
  k1        K1 (banded extension) against its plain twin on the card,
            bit-equal on (i, j, d) at W = 256 and W = 64, L = 1024, 4096,
            16384, at W = 32, 96, 128, 160, 480 and 512 (the warp form,
            C = W/32 = 1-16 cells a lane) and at W = 544, 768, 992 and
            1024 (the wide form, 17-32), each with the edge rows; then
            bit-equal and timed at the (B, L) the pipeline's extender
            launches at L = 1024 and 8192, at W = 256 and at W = 96 and
            1024 (K1_TIMED_BANDS: 3 and 32 cells a lane)
  sharded_k1  the extender's multi-device path: sharded_specs_extend over
            make_mesh() (over cuda:0 twice on a one-card machine) at
            (B, L) = (16384, 1024) and (4096, 8192), bit-equal to one K1
            launch on the same packed words and specs, both timed; then
            the entry point, DeviceExtender.run_specs over that mesh,
            bit-equal to DeviceExtender.run_specs on cuda:0 alone at the
            same specs; logs the shard sizes and the K1 launches per
            device
  k2        K2 (forward DP, two-bit trace) against band_sweep on the cells
            each row swept, K3 (walk) against walk_back on the twin's
            trace, and the pair against align_tb_batch, all bit-equal, at
            the (B, L) DeviceCns._batch_for launches at L = 1024 and 16384
            and at (1024, 1024) and (256, 16384); K2 and K3 timed apart,
            each with its bound
  tb_bands  K2 + K3 at W = 96, 192, 512 and 1024, the bands the warp
            route lacks, each on the route align_tb_cuda.kernel_for picks:
            bit-equal to align_tb_batch at the (B, L) DeviceCns._batch_for
            launches at L 1024, and at L 16384 for W 1024 (the largest
            trace a row, 256 rows under the trace budget); K2 and K3 timed
            with their bounds and K3's chain floor
  pipeline  the port's Pipeline on a simulated genome (24x coverage, 9 kb
            mean reads, 8% error), host-MSA consensus: timings, occupancy,
            kernel launch counts (K1-K3 must be > 0, K4-K6 0), contigs,
            genome recovery (>= 0.95) and sampled identity (>= 0.995)
  pipeline_dp  the same on the same genome with FTPU_CNS_DP=1, the
            device-DP consensus: every kernel K1-K6 must launch, the same
            bars; its phase walls beside the host-MSA run's
  pipeline_mesh  on a host with several GPUs (pipeline_dp then cut K1's
            batches over all of them), pipeline_dp again on cuda:0 alone,
            every artifact byte-equal; skipped on one GPU
  pipeline_mp  two processes of the Pipeline, children of this script
            (--pipeline-child), on the same inputs with no device named,
            joined by FTPU_COORDINATOR_ADDRESS on 127.0.0.1 (gloo) with
            FTPU_CNS_DP unset: each logs its card (cuda:rank % cards) and
            must report the DP consensus on by default, an extender mesh
            of its card alone, launch K1 and K4-K6 and load no jax /
            falcon_tpu module; on several cards no two may share one;
            every artifact tests/test_multiprocess.py compares must be
            byte-equal between them and to pipeline_dp's; their
            walls and phase splits beside the one-process runs.  Both are
            killed after 420 s
  dp_kernels  K4 (tags), K5 (consensus scan) and K6 (backtrack walk)
            against their plain twins on the card, bit-equal, at the
            smallest and largest T bucket the DP pipeline ran, with G from
            DeviceCns._dp_group_cap, K6 with one group on the 2T-code
            ladder and one whose window boundaries fall on stay steps;
            then each timed (K5 with its clocks per column and the mean
            highest level in use, K6 with its clocks per step, K4 with
            its launch shape); and K5 on adversarial counts
            (adversarial_counts) at D = 3, 14 and 16
  graft     the graft entry (falcon_tpu_torch.graft_entry): entry() on the
            card bit-equal to K1's twin; dryrun_multichip over every GPU
            (two shards of cuda:0 on one card), every kernel K1-K6
            launched in it, each stage bit-equal to the same stages on
            cuda:0 unsplit
  consensus_mesh  the consensus chain at full width over that mesh (T 8192
            G 360 with (B, L) (4096, 1024); T 32768 G 90 with (1024,
            16384)): sharded_tb_align, sharded_cns_accumulate,
            sharded_cns_scan, each stage bit-equal to the chain on cuda:0
            and timed on both, with its shard rows
  supervise  python -m falcon_tpu_torch.pipeline.supervise on the smoke
            inputs with FTPU_CNS_DP=1: a first supervisor's RSS limit
            recycles the driver at its first checkpoint, and once it has
            restarted the driver both are killed; a second supervisor
            resumes the run to exit 0, artifacts byte-equal to
            pipeline_dp's; no jax / falcon_tpu module in any of their
            processes (-X importtime)
  mains     every falcon_tpu_torch.mains tool's --help (exit 0 with usage,
            or as falcon_tpu's own tool ends), the path tools on the
            supervised run's 2-asm-falcon, fc_consensus's stream mode
            byte-equal to cns.runner in process
  tools     falcon_tpu_torch.tools on the card, each through the run()
            its command line calls: check_assembly on pipeline_dp's
            p_ctg.fa against the simulated truth (mean identity >= 0.995),
            verify_quick (VERIFY OK, K1-K3 launched), profile_extender at
            (B, L) (16384, 1024), W 256 (the chain bit-equal to the twin),
            profile_cns_dp at 300 kb (the staged rebuild equal to the
            production DP path) and bench_accumulate at its defaults (K4
            equal to its twin and to index_add_ of the decoded tags); each
            tool's seconds and launches logged

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

An `imports` line reports that no jax and no falcon_tpu module was loaded,
in this process and in the pipeline_mp children (else the run fails).  The
line before the last is one JSON object describing every kernel; the last
line is {"ok": true, "device": {...}}.
Without a CUDA device the script exits non-zero before printing either.
"""
import argparse
import io
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
    # ptxas names a function on one line and writes its stack and spills
    # on the next but one, without the "ptxas info" prefix
    ptxas, spills, func = [], {}, None
    with open(_build.LOG_PATH) as f:
        for ln in f:
            ln = ln.strip()
            if "ptxas info" in ln:
                ptxas.append(ln)
                if "Function properties for" in ln:
                    func = ln.split("Function properties for")[1].strip()
            elif "bytes spill" in ln:
                ptxas.append(ln)
                if "0 bytes spill stores, 0 bytes spill loads" not in ln:
                    spills[func] = ln
    log(phase="build", compile_s=round(secs, 3),
        total_s=round(time.time() - t0, 3), ptxas=ptxas,
        kernels_with_spills=len(spills), spills=spills)
    k1 = {f: ln for f, ln in spills.items() if "ftt_extend" in f}
    if k1:
        raise SystemExit("build: K1 spills registers: %s" % k1)


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


K1_TIMED_BANDS = (96, 1024)     # K1 timed beside W_MAIN: C 3 and 32


def phase_k1(rng, card, clock):
    """Parity at small batches of bands of both forms of K1 (among them
    C = 3, 5, 15, 17, 24, 31 and 32 cells a lane), then parity, times and
    bounds at the (B, L) the pipeline's extender launches (its _batch_for)
    at L 1024 and 8192: at W_MAIN and at K1_TIMED_BANDS.  Returns (max abs
    err, {(W, L): timing dict})."""
    from falcon_tpu_torch.ops.align_cuda import extend_batch_cuda, kernel_for
    from falcon_tpu_torch.ops.align_device import band_cells, extend_batch
    from falcon_tpu_torch.overlap.engine import make_device_aligner
    err = 0
    for W, L, B in ((256, 1024, 96), (64, 1024, 64), (256, 4096, 64),
                    (64, 4096, 32), (256, 16384, 32), (32, 1024, 32),
                    (128, 1024, 32), (512, 1024, 32), (512, 4096, 32),
                    (96, 1024, 32), (160, 1024, 32), (480, 1024, 32),
                    (544, 1024, 32), (768, 2048, 16), (992, 1024, 16),
                    (1024, 1024, 16), (1024, 4096, 8)):
        args = make_pairs(rng, B, L, W)
        got = extend_batch_cuda(*args, W=W)
        ref = extend_batch(*args, W=W)
        torch.cuda.synchronize()
        err = max(err, k1_check(got, ref, W, L, B, kernel=kernel_for(W)))
    ext = make_device_aligner(W=W_MAIN, device="cuda").ext
    times = {}
    # the main path's band, then two no default run takes, at the same
    # extender shapes
    for W in (W_MAIN,) + K1_TIMED_BANDS:
        for L in (1024, 8192):
            B = ext._batch_for(L)
            args = make_pairs(rng, B, L, W)
            clock.mark()
            got, ms = cuda_ms(lambda: extend_batch_cuda(*args, W=W),
                              reps=3)
            mhz = clock.peak()
            ref, plain = cuda_ms(lambda: extend_batch(*args, W=W))
            err = max(err, k1_check(got, ref, W, L, B,
                                    main_path=W == W_MAIN,
                                    kernel=kernel_for(W)))
            ql, tl = args[1].cpu().numpy(), args[3].cpu().numpy()
            cells = int(band_cells(ql, tl, W).sum())
            bnd, by = bound_ms(2 * B * L + 8 * B + 12 * B,
                               cells * OPS_PER_CELL["K1"], mhz)
            times[(W, L)] = dict(B=B, ms=ms, plain_ms=plain, bound_ms=bnd,
                                 bound_by=by)
            log(phase="k1_time", card=card, B=B, L=L, W=W,
                kernel=kernel_for(W), kernel_ms=ms, plain_ms=plain,
                band_cells=cells, sm_clock_mhz=mhz, bound_ms=bnd,
                bound_by=by, share_of_bound=share_of_bound(
                    "K1 W=%d L=%d" % (W, L), ms, bnd),
                lane_steps=int((ql + tl).sum()) * W)
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
    # the batcher's shapes, and tools/tb_compare.py's short one (its long
    # one, (256, 16384), costs ~50 s of the plain versions; tb_compare
    # times it)
    shapes = [(cns._batch_for(1024), 1024), (cns._batch_for(16384), 16384),
              (1024, 1024)]
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


TB_BANDS = (96, 192, 512, 1024)       # the block route's bands checked
BLOCK_ROW_BAND = 512                  # the block route's row of the kernels
                                      # line
TB_BANDS_LONG = (1024, 16384)         # (W, L): the long launch checked


def phase_tb_bands(rng, card, clock, lat):
    """K2 + K3 at bands the warp route lacks, each on the route
    kernel_for picks, against align_tb_batch, bit-equal, at the
    (B, L) DeviceCns._batch_for launches at L 1024 for every band of
    TB_BANDS and at TB_BANDS_LONG (W 1024, whose trace per row is the
    largest, so the trace budget sets B there: 256 rows at L 16384);
    then K2 and K3 timed apart with bounds and K3's chain floor: a
    shared-memory read a walked diagonal, what its walk reads (the
    device read's floor logged beside it).  The plain versions are
    band_sweep and walk_back, each run once.  Returns (max abs err,
    {(W, L): {"K2": timing dict, "K3": timing dict}})."""
    from falcon_tpu_torch.cns.device import DeviceCns
    from falcon_tpu_torch.ops import align_tb_cuda as k
    from falcon_tpu_torch.ops.align_device import band_cells, band_sweep
    from falcon_tpu_torch.ops.align_tb import pack_moves, walk_back
    runs = [(W, 1024) for W in TB_BANDS] + [TB_BANDS_LONG]
    err = 0
    times = {}
    for W, L in runs:
        cns = DeviceCns(device="cuda", W=W)
        B = cns._batch_for(L)
        args = make_pairs(rng, B, L, W)
        q, ql, t, tl = args
        (p_ends, planes), p_fwd = cuda_ms(
            lambda: band_sweep(*args, W, 3, keep_moves=True), warm=False)
        (p_moves, p_bases), p_bwd = cuda_ms(
            lambda: walk_back(q, p_ends, planes, W), warm=False)
        del planes
        ref = list(p_ends) + [pack_moves(p_moves), p_bases]
        del p_moves
        got = k.align_tb_batch_cuda(*args, W=W)
        torch.cuda.synchronize()
        e = max_err(got, ref)
        eq = all(torch.equal(g, r) for g, r in zip(got, ref))
        log(phase="tb_bands_parity", W=W, L=L, B=B, route=k.kernel_for(W),
            cells_a_lane=k.trace_cells(W), max_abs_err=e, bit_equal=eq,
            trace_bytes=B * k.trace_row_bytes(L, W),
            moves_budget=cns.moves_budget)
        if not eq:
            raise SystemExit("K2/K3 (%s route) differ from align_tb_batch at "
                             "W=%d B=%d L=%d" % (k.kernel_for(W), W, B, L))
        err = max(err, e)
        del ref, got, p_ends, p_bases
        clock.mark()
        (ends, trace), fwd = cuda_ms(
            lambda: k.tb_forward_cuda(*args, W, 3), reps=3)
        (mv, _), bwd = cuda_ms(
            lambda: k.tb_backward_cuda(trace, ends, q, W), reps=3)
        mhz = clock.peak()
        del trace
        qn, tn = ql.cpu().numpy(), tl.cpu().numpy()
        cells = int(band_cells(qn, tn, W).sum())
        steps = np.minimum(qn + tn, 2 * L)
        trace_bytes = int(steps.sum()) * W // 4
        b2, by2 = bound_ms(2 * B * L + 8 * B + 12 * B + trace_bytes,
                           cells * OPS_PER_CELL["K2"], mhz)
        # a walked step reads the 4-byte trace word of its cell and at
        # most one q byte
        walked = sum(int((((mv >> sh) & 3) != 3).sum()) for sh in (0, 2, 4, 6))
        b3, by3 = bound_ms(4 * walked + int(ends[0].sum()) + 12 * B +
                           2 * L * B * 5 // 4, walked * OPS_PER_WALK_STEP,
                           mhz)
        longest = int((ends[0] + ends[1]).max())
        c3 = chain_ms(longest, lat["shared"], mhz)
        times[(W, L)] = dict(
            K2=dict(ms=fwd, plain_ms=p_fwd, bound_ms=b2, bound_by=by2),
            K3=dict(ms=bwd, plain_ms=p_bwd, bound_ms=b3, bound_by=by3))
        log(phase="tb_bands_time", card=card, B=B, L=L, W=W,
            route=k.kernel_for(W), cells_a_lane=k.trace_cells(W),
            sm_clock_mhz=mhz, k2_ms=fwd, k2_plain_ms=p_fwd, k2_bound_ms=b2,
            k2_bound_by=by2,
            k2_share_of_bound=share_of_bound("K2 W=%d %dx%d" % (W, B, L),
                                             fwd, b2),
            band_cells=cells, trace_bytes=trace_bytes, k3_ms=bwd,
            k3_plain_ms=p_bwd, k3_bound_ms=b3, k3_bound_by=by3,
            k3_share_of_bound=share_of_bound("K3 W=%d %dx%d" % (W, B, L),
                                             bwd, b3),
            k3_chain_floor_ms=c3,
            k3_chain_floor_device_read_ms=chain_ms(longest, lat["global"],
                                                   mhz),
            walked_steps=walked, longest_walk_diagonals=longest)
        del args, q, ql, t, tl, ends, mv
        torch.cuda.empty_cache()
    return err, times


SHARDED_K1 = ((16384, 1024), (4096, 8192))   # (B, L), W_MAIN


def spec_batch(q, ql, t, tl):
    """make_pairs' planes as the extender's input: the rows' codes in one
    flat array and [6, B] int32 specs of forward slices, the odd rows read
    backward (dir -1).  Returns (flat uint8, sel)."""
    q, ql, t, tl = (x.cpu().numpy() for x in (q, ql, t, tl))
    B, L = q.shape
    ar = np.arange(L)
    fq, ft = q[ar < ql[:, None]], t[ar < tl[:, None]]
    qo = np.concatenate([[0], np.cumsum(ql)[:-1]])
    to = len(fq) + np.concatenate([[0], np.cumsum(tl)[:-1]])
    back = np.arange(B) % 2 == 1
    # a backward spec starts at the slice's last base: its plane is the
    # row reversed, which is still a pair of related reads
    sel = np.stack([np.where(back, qo + ql - 1, qo), ql,
                    np.where(back, -1, 1), np.where(back, to + tl - 1, to),
                    tl, np.where(back, -1, 1)]).astype(np.int32)
    sel[:, (ql == 0) | (tl == 0)] = 0     # empty rows: nothing to read
    return np.concatenate([fq, ft]).astype(np.uint8), sel


def phase_sharded_k1(rng, card):
    """sharded_specs_extend over make_mesh() (two entries on the one card
    of a one-card machine) against one K1 launch on the same packed words
    and specs, bit-equal, at SHARDED_K1; both timed (gather + K1, the
    sharded call with its per-shard copy of the specs).  Logs the shard
    sizes and the K1 launches per device of one sharded call.  Then
    DeviceExtender.run_specs over the same mesh against an extender on
    cuda:0 alone, bit-equal, with the K1 launches of each by device."""
    from falcon_tpu_torch.ops import align_cuda
    from falcon_tpu_torch.ops.align_device import (gather_specs2_packed,
                                                   pack_flat_2bit)
    from falcon_tpu_torch.parallel import mesh as pm
    mesh = pm.make_mesh() if torch.cuda.device_count() > 1 else \
        pm.make_mesh(devices=("cuda:0", "cuda:0"))
    dev = mesh[0]
    for B, L in SHARDED_K1:
        flat, sel = spec_batch(*make_pairs(rng, B, L, W_MAIN))
        words = torch.from_numpy(pack_flat_2bit(flat).astype(np.int64))
        reps = pm.replicate(words, mesh)
        sel_d = torch.from_numpy(sel).to(dev)

        def one():
            qd, td = gather_specs2_packed(reps[dev], *sel_d, L=L, fill_q=4,
                                          fill_t=5)
            return align_cuda.extend_batch_cuda(qd, sel_d[1], td, sel_d[4],
                                                W=W_MAIN)
        ref, one_ms = cuda_ms(one, reps=3)
        before = dict(align_cuda.BY_DEVICE)
        got = pm.sharded_specs_extend(mesh, reps, sel, L, W_MAIN, 3)
        torch.cuda.synchronize()
        per_dev = {d: n - before.get(d, 0)
                   for d, n in align_cuda.BY_DEVICE.items()
                   if n != before.get(d, 0)}
        _, ms = cuda_ms(lambda: pm.sharded_specs_extend(mesh, reps, sel, L,
                                                        W_MAIN, 3), reps=3)
        e = max_err([got], [ref])
        shards = [hi - lo for lo, hi in pm.shard_bounds(B, len(mesh))]
        log(phase="sharded_k1", card=card, B=B, L=L, W=W_MAIN,
            mesh=[str(d) for d in mesh], shard_rows=shards,
            k1_launches_per_device=per_dev, max_abs_err=e,
            bit_equal=bool(torch.equal(got, ref)), sharded_ms=ms,
            one_launch_ms=one_ms)
        if e or not torch.equal(got, ref):
            raise SystemExit("sharded K1 differs from one K1 launch at B=%d "
                             "L=%d" % (B, L))
        if sum(per_dev.values()) != sum(1 for n in shards if n):
            raise SystemExit("sharded K1: launches %s for shards %s"
                             % (per_dev, shards))
        del ref, got, reps, sel_d, words
        torch.cuda.empty_cache()
    # the port's entry point over the same mesh: DeviceExtender.run_specs,
    # the K1 path of every pipeline on a host with several GPUs, against
    # an extender on cuda:0 alone, at the same specs
    from falcon_tpu_torch.ops.align_device import DeviceExtender
    for B, L in SHARDED_K1:
        flat, sel = spec_batch(*make_pairs(rng, B, L, W_MAIN))
        out, per_dev, wall = {}, {}, {}
        for name, devices in (("one", ("cuda:0",)), ("mesh", mesh)):
            ext = DeviceExtender(W=W_MAIN, max_batch=512, device="cuda",
                                 devices=devices)
            before = dict(align_cuda.BY_DEVICE)
            t0 = time.time()
            out[name] = ext.run_specs(flat, *sel)
            torch.cuda.synchronize()
            wall[name] = time.time() - t0
            per_dev[name] = {d: n - before.get(d, 0)
                             for d, n in align_cuda.BY_DEVICE.items()
                             if n != before.get(d, 0)}
        n_one = sum(per_dev["one"].values())
        n_mesh = sum(per_dev["mesh"].values())
        equal = bool(np.array_equal(out["mesh"], out["one"]))
        log(phase="sharded_k1_extender", card=card, B=B, L=L, W=W_MAIN,
            mesh=[str(d) for d in mesh], k1_launches_per_device=per_dev,
            bit_equal=equal, one_device_s=wall["one"],
            mesh_s=wall["mesh"])
        if not equal:
            raise SystemExit("DeviceExtender over %s differs from one "
                             "device at B=%d L=%d" % (list(mesh), B, L))
        # every batch launches once on one device and once a non-empty
        # shard on the mesh; every device of the mesh takes a shard
        if not (n_one <= n_mesh <= len(mesh) * n_one) or \
                len(per_dev["mesh"]) != len(set(mesh)):
            raise SystemExit("DeviceExtender over %s: K1 launches %s "
                             % (list(mesh), per_dev))


def block_counters():
    """The launch counters of the forms no default run takes (K1's wide
    form, K2's and K3's block routes), by kernel: (LAUNCHES dict, key)."""
    from falcon_tpu_torch.ops import align_cuda, align_tb_cuda
    return {"K1 wide": (align_cuda.LAUNCHES, "extend_wide"),
            "K2 block": (align_tb_cuda.LAUNCHES, "tb_fwd_block"),
            "K3 block": (align_tb_cuda.LAUNCHES, "tb_bwd_block")}


def counters():
    """Every kernel's launch counter, by kernel: (LAUNCHES dict, key)."""
    from falcon_tpu_torch.ops import align_cuda, align_tb_cuda, cns_dp_cuda
    return {"K1": (align_cuda.LAUNCHES, "extend"),
            "K2": (align_tb_cuda.LAUNCHES, "tb_fwd"),
            "K3": (align_tb_cuda.LAUNCHES, "tb_bwd"),
            "K4": (cns_dp_cuda.LAUNCHES, "tags"),
            "K5": (cns_dp_cuda.LAUNCHES, "cns_scan"),
            "K6": (cns_dp_cuda.LAUNCHES, "cns_walk")}


# what tests/test_multiprocess.py holds byte-equal between processes
MP_ARTIFACTS = (
    "2-asm-falcon/p_ctg.fa", "2-asm-falcon/a_ctg.fa",
    "2-asm-falcon/sg_edges_list", "2-asm-falcon/ctg_paths",
    "2-asm-falcon/utg_data", "2-asm-falcon/asm.gfa", "2-asm-falcon/sg.gfa",
    "2-asm-falcon/contig.gfa2", "0-rawreads/preads.fasta",
    "1-preads_ovl/preads.ovl")


def artifact_digests(out_dir):
    """{artifact: sha256 hex} of MP_ARTIFACTS under out_dir."""
    import hashlib
    out = {}
    for rel in MP_ARTIFACTS:
        with open(os.path.join(out_dir, rel), "rb") as f:
            out[rel] = hashlib.sha256(f.read()).hexdigest()
    return out


def write_run(args, workdir, name):
    """The simulated genome's reads and fc_run.cfg in workdir (the same
    for every pipeline phase: same size, seed and blocks)."""
    from falcon_tpu_torch.utils import simcheck
    t0 = time.time()
    genome = simcheck.write_sim_run(
        workdir, args.genome_size, coverage=24, mean_len=9000, error=0.08,
        seed=args.seed, block_mb=args.block_mb)
    log(phase=name + "_sim", genome_size=args.genome_size,
        block_mb=args.block_mb, seed=args.seed,
        sim_s=round(time.time() - t0, 3))
    return genome


def phase_pipeline(args, workdir, dp, device="cuda"):
    """The port's Pipeline on the simulated genome, consensus through the
    device-DP path (dp) or the host-MSA path; returns (launches by kernel,
    timings, artifact digests; the launches include those of the forms
    the default band never takes, block_counters).  The DP run must
    launch every kernel, the host-MSA run K1-K3 and none of K4-K6.  With
    the bare device "cuda" the extender cuts K1's batches over every
    visible GPU; a named one ("cuda:0") keeps them on that card."""
    from falcon_tpu_torch.pipeline.driver import Pipeline
    from falcon_tpu_torch.utils import simcheck
    name = ("pipeline_dp" if dp else "pipeline") + \
        ("" if device == "cuda" else "_one_card")
    genome = write_run(args, workdir, name)
    cnt = counters()
    blk = block_counters()
    for d, key in list(cnt.values()) + list(blk.values()):
        d[key] = 0
    env = os.environ.get("FTPU_CNS_DP")
    os.environ["FTPU_CNS_DP"] = "1" if dp else "0"
    t0 = time.time()
    cwd = os.getcwd()
    os.chdir(workdir)
    try:
        pipe = Pipeline("fc_run.cfg", workdir, device=device)
        p_ctg = pipe.run()
        torch.cuda.synchronize()
    finally:
        os.chdir(cwd)
        if env is None:
            del os.environ["FTPU_CNS_DP"]
        else:
            os.environ["FTPU_CNS_DP"] = env
    launches = {k: d[key] for k, (d, key) in cnt.items()}
    block = {k: d[key] for k, (d, key) in blk.items()}
    log(phase=name + "_timings", wall_s=round(time.time() - t0, 3),
        **pipe.timings)
    log(phase=name + "_launches", **launches, **block)
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
    return dict(launches, **block), pipe.timings, artifact_digests(workdir)


def phase_pipeline_mesh(args, card, dp_t, dp_digests):
    """On a host with several GPUs the DP run above cut K1's batches over
    all of them: the same run again on cuda:0 alone, every MP_ARTIFACTS
    file byte-equal.  Skipped, and logged so, on one GPU."""
    n = torch.cuda.device_count()
    if n < 2:
        log(phase="pipeline_mesh", card=card, gpus=n,
            skipped="one GPU: pipeline_dp ran on a one-entry mesh")
        return
    with tempfile.TemporaryDirectory() as d:
        _, one_t, one_digests = phase_pipeline(args, d, dp=True,
                                               device="cuda:0")
    same = {k: one_digests[k] == dp_digests[k] for k in MP_ARTIFACTS}
    log(phase="pipeline_mesh", card=card, gpus=n, artifacts_equal=same,
        total_s={"every_gpu": dp_t["total"], "cuda:0": one_t["total"]},
        overlap_s={"every_gpu": [dp_t["phase0_overlap"],
                                 dp_t["phase1_overlap"]],
                   "cuda:0": [one_t["phase0_overlap"],
                              one_t["phase1_overlap"]]})
    if not all(same.values()):
        raise SystemExit("the DP pipeline over %d GPUs differs from cuda:0 "
                         "alone: %s" % (n, same))


MP_PROCS = 2
MP_TIMEOUT_S = 420


def free_port():
    import socket
    with socket.socket() as sk:
        sk.bind(("127.0.0.1", 0))
        return sk.getsockname()[1]


def phase_pipeline_mp(args, workdir, card, dp_digests):
    """MP_PROCS processes of the port's Pipeline on the same simulated
    inputs, each a child of this script (--pipeline-child), joined through
    FTPU_COORDINATOR_ADDRESS on 127.0.0.1 with FTPU_CNS_DP unset and no
    device named, so that each takes its own card (cuda:rank % cards; all
    cuda:0 on a one-card host).  Each child must report use_dp on, its
    card and its extender's mesh (that card alone), launch K1 and K4-K6,
    load no jax / falcon_tpu module, and write every MP_ARTIFACTS file
    byte-equal to the other's and to the single-process DP run's
    (dp_digests); on a host with more than one card no two children may
    share one.  Both are killed when MP_TIMEOUT_S is up.  Returns the
    children's reports."""
    write_run(args, workdir, "pipeline_mp")
    port = free_port()
    procs, logs = [], []
    t0 = time.time()
    try:
        for rank in range(MP_PROCS):
            env = dict(os.environ)
            for key in ("FTPU_CNS_DP", "FTPU_PROFILE", "FTPU_TORCH_DEVICE"):
                env.pop(key, None)
            env.update(FTPU_COORDINATOR_ADDRESS="127.0.0.1:%d" % port,
                       FTPU_NUM_PROCESSES=str(MP_PROCS),
                       FTPU_PROCESS_ID=str(rank))
            logs.append(open(os.path.join(workdir, "child%d.log" % rank),
                             "w+"))
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__),
                 "--pipeline-child", workdir,
                 os.path.join(workdir, "out%d" % rank)],
                env=env, stdout=logs[-1], stderr=subprocess.STDOUT))
        deadline = t0 + MP_TIMEOUT_S
        rcs = [p.wait(timeout=max(1.0, deadline - time.time()))
               for p in procs]
    except subprocess.TimeoutExpired:
        rcs = None
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    wall = time.time() - t0
    reports, tails = [], []
    for f in logs:
        f.seek(0)
        lines = f.read().splitlines()
        f.close()
        tails.append(lines[-20:])
        rep = [ln for ln in lines if ln.startswith('{"phase": "mp_child"')]
        reports.append(json.loads(rep[-1]) if rep else None)
    if rcs != [0] * MP_PROCS or None in reports:
        raise SystemExit("pipeline_mp: children exited %s after %.1f s; "
                         "last lines %s" % (rcs, wall, tails))
    digests = [artifact_digests(os.path.join(workdir, "out%d" % r))
               for r in range(MP_PROCS)]
    same = {rel: all(d[rel] == dp_digests[rel] for d in digests)
            for rel in MP_ARTIFACTS}
    log(phase="pipeline_mp", card=card, processes=MP_PROCS, wall_s=wall,
        gpus=torch.cuda.device_count(),
        child_devices=[r["device"] for r in reports],
        artifacts_equal_to_pipeline_dp=same, children=reports)
    bad = [r["rank"] for r in reports
           if not r["use_dp"] or r["loaded"] or r["mesh"] != [r["device"]] or
           min(r["launches"][k] for k in ("K1", "K4", "K5", "K6")) < 1]
    if bad or not all(same.values()):
        raise SystemExit("pipeline_mp: children %s failed (use_dp, mesh, "
                         "launches or imports), artifacts equal %s"
                         % (bad, same))
    cards = [r["device"] for r in reports]
    if torch.cuda.device_count() > 1 and len(set(cards)) < MP_PROCS:
        raise SystemExit("pipeline_mp: on %d cards the children share one: "
                         "%s" % (torch.cuda.device_count(), cards))
    return reports


def pipeline_child(workdir, out_dir):
    """One process of phase_pipeline_mp: the port's Pipeline on the inputs
    in workdir, written to out_dir; prints one JSON report line (its INFO
    log goes to stderr)."""
    logging.basicConfig(
        level=logging.INFO,
        format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    from falcon_tpu_torch.cns.device import DeviceCns
    from falcon_tpu_torch.pipeline.driver import Pipeline
    cnt = counters()
    for d, key in cnt.values():
        d[key] = 0
    os.chdir(workdir)
    t0 = time.time()
    pipe = Pipeline("fc_run.cfg", out_dir)   # no device named
    import torch.distributed as dist
    rank = dist.get_rank()
    use_dp = DeviceCns().use_dp
    pipe.run()
    torch.cuda.synchronize()
    wall = time.time() - t0
    launches = {k: d[key] for k, (d, key) in cnt.items()}
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "falcon_tpu"))
    log(phase="mp_child", rank=rank, world=dist.get_world_size(),
        device=str(pipe.device), mesh=[str(d) for d in pipe.mesh or ()],
        use_dp=use_dp,
        dp_path_ran="phase0_cns_dp_batches" in pipe.timings,
        launches=launches, wall_s=wall, loaded=loaded, **{
            key: pipe.timings.get(key)
            for key in ("phase0_masking", "phase0_overlap",
                        "phase0_consensus", "phase1_overlap",
                        "phase2_graph", "total")})
    dist.destroy_process_group()
    return 0


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


def boundary_walk(scan, g, T, D, window):
    """Point group g of a scan's outputs at a walk from (T - 1, 0, 1) that
    jumps straight down the columns at delta 0, but enters each first and
    last column of a K6 window (counted from T - 1) at d = D - 1 and stays
    down to d = 0 there: the window boundaries fall on stay steps.  The
    start is at t = 0."""
    bp, cov, gb_s, gb_t, gb_d, gb_b = (x.clone() for x in scan)
    t = torch.arange(T, device=bp.device)
    edge = ((T - 1 - t) % window == 0) | ((T - 1 - t) % window ==
                                          window - 1)
    pd = torch.where(edge.roll(1), D - 1, 0)        # the level t - 1 is
    d = torch.arange(D, device=bp.device).repeat_interleave(5)   # entered at
    b = torch.arange(5, device=bp.device).repeat(D)
    col = torch.where(d[None] == 0, pd[:, None] * 5 + 1, 128 + b[None])
    bp[:, g] = col.to(torch.uint8)
    bp[0, g, :5] = 254
    gb_s[g], gb_t[g], gb_d[g], gb_b[g] = 1.0, T - 1, 0, 1
    return bp, cov, gb_s, gb_t, gb_d, gb_b


def walk_cases(rng, T, D, window, device="cpu"):
    """K6 inputs that are hard for its window ring, 8 groups: a walk
    through a random pred plane (stays, jumps to any level, gaps, rare
    start codes); one that starts at t = 0; two that end at a start code on
    a window's first and last column; the 2T-code ladder (ladder_walk);
    an empty group (gb_s = -1); boundary_walk; a random walk from a random
    t.  Coverage in [0, 4].  Returns (bp, cov, gb_s, gb_t, gb_d, gb_b) as
    backtrack_walk takes them."""
    G = 8
    d = np.arange(D).repeat(5)[None, None, :]
    pd = np.where(rng.random((T, G, D * 5)) < 0.7, 0,
                  rng.integers(0, D, (T, G, D * 5)))
    jump = pd * 5 + rng.integers(0, 5, (T, G, D * 5))
    stay = 128 + rng.integers(0, 5, (T, G, D * 5))
    r = rng.random((T, G, D * 5))
    bp = np.where(d == 0, np.where(r < 0.002, 254, jump),
                  np.where(r < 0.005, 255, np.where(r < 0.55, stay, jump)))
    bp = bp.astype(np.uint8)
    cov = rng.integers(0, 5, (G, T)).astype(np.int32)
    gb_t = np.full(G, T - 1, np.int32)
    gb_d = rng.integers(0, D, G).astype(np.int32)
    gb_b = rng.integers(0, 5, G).astype(np.int32)
    gb_t[1] = 0
    gb_t[7] = rng.integers(0, T)
    for g, t_s in ((2, T - 1 - window), (3, T - window)):
        # a straight walk at delta 0 onto a start code at t_s
        t_s = max(t_s, 0)
        bp[:, g, :5] = rng.integers(0, 5, (T, 5))
        bp[t_s, g, :5] = 254
        gb_d[g] = 0
    gb_s = np.ones(G, np.float32)
    gb_s[5] = -1.0
    scan = tuple(torch.from_numpy(x) for x in (bp, cov, gb_s, gb_t, gb_d,
                                               gb_b))
    scan = ladder_walk(scan, 4, T, D)
    scan = boundary_walk(scan, 6, T, D, window)
    return tuple(x.to(device) for x in scan)


def walk_steps(bp, cov, gb_s, gb_t, gb_d, gb_b, T, D):
    """The reads of bp each group's walk makes (K6's dependent steps),
    walked on the host in numpy, all groups together: numpy [G]."""
    bp, gb_s, t, d, b = (x.cpu().numpy() for x in (bp, gb_s, gb_t, gb_d,
                                                   gb_b))
    G = bp.shape[1]
    bpf = bp.reshape(-1).astype(np.int64)
    t, d, b = (x.astype(np.int64) for x in (t, d, b))
    ck = b.copy()
    g_ar = np.arange(G)
    n = np.zeros(G, np.int64)
    steps = np.zeros(G, np.int64)
    done = gb_s == -1.0
    while not done.all():
        code = bpf[(np.clip(t, 0, T - 1) * G + g_ar) * (D * 5) + d * 5 + b]
        steps += ~done
        can = ~done & (code < 250)
        n += can & (ck != 4)
        jump = can & (code < 128)
        stay = can & (code >= 128)
        b = np.where(jump, code % 5, np.where(stay, code - 128, b))
        d = np.where(jump, code // 5, np.where(stay, d - 1, d))
        ck = np.where(can, b, ck)
        t = np.where(jump, t - 1, t)
        done |= (code >= 250) | (t < 0) | (n >= 2 * T)
    return steps


def tag_rows(rng, P, T, D, segs, G=5, B=8):
    """K4 inputs made to break a segmented decode (B >= 8 rows): move
    streams of P bytes (END->START, 4 moves a byte) with leading inactive
    columns and runs of insertions shorter than D, and rows whose first bad
    column falls on the first column of segment 1 (of `segs` segments of
    ceil(P / segs) bytes; column 0 for one segment; delta >= D, or tpos < 0
    where the column is too near the start), on the last column of segment
    segs // 2, under 500 active columns, a dead row (gidx -1), a row the bd
    gate drops, a row that runs past T, and plain rows.  Returns (mvp
    [P, B] uint8, basep [4P, B] int8, bd, gidx, s2 [B] int32) as numpy
    arrays."""
    S = 4 * P
    sb = -(-P // segs)
    m = np.full((B, S), 3, np.int64)             # columns START->END
    s2 = rng.integers(1, T // 2, B)
    for row in range(B):
        lead = int(rng.integers(0, 8))
        m[row, lead:] = rng.choice(3, S - lead, p=[0.8, 0.1, 0.1])
    run = np.zeros(B, np.int64)
    for k in range(S):                           # no run of D insertions
        run = np.where(m[:, k] == 2, run + 1, 0)
        m[run >= D, k] = 0
        run[run >= D] = 0
    for row, kb in ((0, 4 * sb if segs > 1 else 0),
                    (1, min(4 * (segs // 2 + 1) * sb, S) - 1)):
        if kb >= D + 8:                          # D insertions after a match
            m[row, kb - D:kb + 1] = [0] + [2] * D
        else:                                    # an insertion opens the row
            m[row, :kb] = 3
            m[row, kb] = 2
            s2[row] = 0
    m[2, :S - 400] = 3                           # 400 active columns
    s2[6] = T - S // 8                           # runs past T
    gidx = rng.integers(0, G, B).astype(np.int32)
    gidx[3] = -1
    bd = rng.integers(0, 50, B).astype(np.int32)
    bd[4] = 10 ** 6
    stream = m[:, ::-1].reshape(B, P, 4)         # END->START
    mvp = (stream[..., 0] | stream[..., 1] << 2 | stream[..., 2] << 4 |
           stream[..., 3] << 6).T.astype(np.uint8)
    basep = rng.integers(0, 5, (S, B)).astype(np.int8)
    return (np.ascontiguousarray(mvp), basep, bd, gidx,
            s2.astype(np.int32))


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
    ladder and group G - 3 onto boundary_walk (its K6 windows' boundaries
    on stay steps); its chain floor is the longest walk's reads of bp
    (walk_steps) at the shared-memory latency, beside the device-memory
    one.  Returns ({kernel: max abs err}, {T: times})."""
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
        lad = boundary_walk(ladder_walk(scan, G - 2, T, D), G - 3, T, D,
                            k.WALK_WINDOW)
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
        steps6 = walk_steps(*lad, T, D)      # each walk's reads of bp
        b6, by6 = bound_ms(int(steps6.sum()) + G * 2 * T + 4 * G, 0, mhz)
        c5 = chain_ms(T, lat["shared"], mhz)
        # K6 reads each step's code from shared memory; the design it
        # replaced read it from device memory
        c6 = chain_ms(int(steps6.max()), lat["shared"], mhz)
        c6_dev = chain_ms(int(steps6.max()), lat["global"], mhz)
        log(phase="dp_kernels", card=card, T=T, G=G, D=D, L=L,
            rows=rows, tags=tags, sm_clock_mhz=mhz,
            k4_bound_ms=b4, k4_bound_by=by4, k5_bound_ms=b5, k5_bound_by=by5,
            k5_chain_floor_ms=c5, k5_steps=T,
            k5_clk_per_step=t5 * mhz * 1e3 / T,
            k5_mean_dmax=mean_dmax(got, G, T, D), k6_bound_ms=b6,
            k6_bound_by=by6, k6_chain_floor_ms=c6,
            k6_device_read_chain_floor_ms=c6_dev,
            k6_longest_walk_steps=int(steps6.max()),
            k6_clk_per_step=t6 * mhz * 1e3 / int(steps6.max()),
            k6_window=k.WALK_WINDOW,
            k4_layout=k.tag_layout(rows, rest[0].shape[0], torch.cuda.
                                   get_device_properties(0).
                                   multi_processor_count),
            k4_share_of_bound=share_of_bound("K4 T=%d" % T, t4, b4),
            k5_share_of_bound=share_of_bound("K5 T=%d" % T, t5, b5),
            k6_share_of_bound=share_of_bound("K6 T=%d" % T, t6, b6),
            k4_max_abs_err=e4, k4_bit_equal=eq4, k5_max_abs_err=e5,
            k5_bit_equal=eq5, k6_max_abs_err=e6, k6_bit_equal=eq6,
            emitted_min=min(n), emitted_max=max(n),
            k4_ms=t4, k4_plain_ms=p4,
            k5_ms=t5, k5_plain_ms=p5, k6_ms=t6, k6_plain_ms=p6)
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


def mesh_of_cards():
    """make_mesh() on a host with several GPUs, else two shards of the one
    card (the mesh a one-card machine can give)."""
    from falcon_tpu_torch.parallel import mesh as pm
    if torch.cuda.device_count() > 1:
        return pm.make_mesh()
    return pm.make_mesh(devices=("cuda:0", "cuda:0"))


def sync_all():
    for k in range(torch.cuda.device_count()):
        torch.cuda.synchronize(k)


def wall_ms(fn):
    """(fn's output, milliseconds from its call to the end of every card's
    work), on the host's clock: a stage over several cards has no one
    stream to put CUDA events on."""
    sync_all()
    t0 = time.perf_counter()
    out = fn()
    sync_all()
    return out, (time.perf_counter() - t0) * 1e3


def zero_counters():
    cnt = counters()
    for d, key in cnt.values():
        d[key] = 0
    return cnt


def read_counters(cnt):
    return {k: d[key] for k, (d, key) in cnt.items()}


def tensors_equal(a, b):
    """Bit-equality of two tensors (uint16 through their int16 views) or
    numpy arrays."""
    if isinstance(a, np.ndarray):
        return bool(np.array_equal(a, b))
    if a.dtype == torch.uint16:
        a, b = a.view(torch.int16), b.view(torch.int16)
    return bool(torch.equal(a, b.to(a.device)))


def phase_graft(card):
    """The graft entry: entry() on the card against K1's plain twin,
    bit-equal; then dryrun_multichip over mesh_of_cards() (its own checks:
    every alignment extends, the k-mer sums, self-slices at distance 0,
    every group's consensus its seed), each stage's outputs bit-equal to
    the same stages on cuda:0 unsplit (graft_entry.run_stages).  The
    counts are set to 0 just before the dryrun and read just after: every
    kernel K1-K6 must have launched in it.  Returns its launches."""
    from falcon_tpu_torch import graft_entry
    from falcon_tpu_torch.ops.align_device import extend_batch
    from falcon_tpu_torch.parallel import mesh as pm
    t0 = time.time()
    fn, args = graft_entry.entry()
    got = fn(*args)
    torch.cuda.synchronize()
    e1 = k1_check(got, extend_batch(*args, W=256), 256, args[0].shape[1],
                  args[0].shape[0], graft_entry=True)
    mesh = mesh_of_cards()
    cnt = zero_counters()
    out, mesh_ms = wall_ms(lambda: graft_entry.dryrun_multichip(
        len(mesh), devices=mesh))
    launches = read_counters(cnt)
    ref, one_ms = wall_ms(lambda: graft_entry.run_stages(
        pm.make_mesh(devices=("cuda:0",)), len(mesh)))
    equal = {key: tensors_equal(out[key], ref[key])
             for key in ("extend", "kmer_total", "aligned_bases", "specs",
                         "msa", "rows", "counts")}
    equal["tb"] = all(tensors_equal(a, b) for a, b in zip(out["tb"],
                                                          ref["tb"]))
    log(phase="graft", card=card, entry_max_abs_err=e1,
        mesh=[str(d) for d in mesh], launches=launches,
        stages_equal_to_one_card=equal, dryrun_ms=mesh_ms,
        one_card_ms=one_ms, seconds=round(time.time() - t0, 3))
    if not all(equal.values()) or min(launches.values()) < 1:
        raise SystemExit("graft: stages equal %s, launches %s"
                         % (equal, launches))
    return launches


# (T, G, B, L): the DP run's smallest and largest T bucket at their groups
# a batch (DeviceCns._dp_group_cap at D 14), each with the alignment batch
# DeviceCns._batch_for launches at L 1024 and 16384
CNS_MESH = ((8192, 360, 4096, 1024), (32768, 90, 1024, 16384))


def phase_consensus_mesh(rng, card, min_cov=2, min_idt=0.70):
    """The consensus chain at full width over mesh_of_cards(), against the
    same chain on cuda:0 through the kernels' wrappers (the one-card chain
    of cns.device._dispatch_dp_batch, already held to the twins):
    sharded_tb_align (K2 + K3, W_MAIN) on B make_pairs rows of length L,
    sharded_cns_accumulate (K4, row b into group b % (G - 1) at a random
    seed offset, plus G random seeds' own tags; group G - 1 empty), then
    sharded_cns_scan (K5 + K6).  Every stage's output bit-equal to the one
    card's.  Each chain runs twice: the first pass loads the kernels on
    every card and grows each card's allocator to the chain's buffers;
    the second is timed stage by stage on the mesh and on the card
    (wall_ms; the first pass's times are logged beside), with the shard
    rows, and the counts are read over the mesh's second pass alone.
    Returns {T: per-stage times}."""
    from falcon_tpu_torch.ops import cns_dp
    from falcon_tpu_torch.ops import cns_dp_cuda as k
    from falcon_tpu_torch.ops.align_tb_cuda import align_tb_batch_cuda
    from falcon_tpu_torch.parallel import mesh as pm
    mesh = mesh_of_cards()
    dev = torch.device("cuda:0")
    D = cns_dp.D_DEFAULT
    max_diff = np.float32(1.0 - min_idt)
    out = {}
    t_phase = time.time()
    for T, G, B, L in CNS_MESH:
        q, ql, t, tl = make_pairs(rng, B, L, W_MAIN)
        gidx = torch.from_numpy(np.arange(B, dtype=np.int32) % (G - 1))
        s2 = torch.from_numpy(rng.integers(0, T - L // 4, B)
                              .astype(np.int32))
        seeds = torch.from_numpy(rng.integers(0, 4, (G, T), dtype=np.int8))
        tlens = rng.integers(T // 2, T + 1, G).astype(np.int32)
        tlens[G - 1] = 0
        tlens = torch.from_numpy(tlens)
        gidx_d, s2_d, seeds_d, tlens_d = (x.to(dev) for x in (gidx, s2,
                                                              seeds, tlens))

        def one_card():
            res, ms = {}, {}
            res["tb"], ms["K2+K3"] = wall_ms(
                lambda: align_tb_batch_cuda(q, ql, t, tl, W=W_MAIN))

            def accumulate():
                msa = cns_dp.alloc_msa(G, T, D, dev)
                cns_dp.add_self_tags(msa, seeds_d, tlens_d, T)
                tb = res["tb"]
                return k.accumulate_tags_planes_cuda(
                    msa, tb[3], tb[4], tb[2], gidx_d, s2_d, max_diff, T, D)
            res["msa"], ms["K4"] = wall_ms(accumulate)

            def scan_walk():
                scan = k.consensus_scan_cuda(res["msa"], G, T, D)
                return k.backtrack_walk_cuda(*scan, min_cov, G, T, D)
            (res["rows"], res["counts"]), ms["K5+K6"] = wall_ms(scan_walk)
            return res, ms

        def over_mesh():
            res, ms = {}, {}
            res["tb"], ms["K2+K3"] = wall_ms(
                lambda: pm.sharded_tb_align(mesh, q, ql, t, tl, W=W_MAIN))
            tb = res["tb"]
            res["msa"], ms["K4"] = wall_ms(
                lambda: pm.sharded_cns_accumulate(
                    mesh, G, T, D, tb[3], tb[4], tb[2], gidx, s2, max_diff,
                    seeds=seeds, tlens=tlens))
            (res["rows"], res["counts"], _), ms["K5+K6"] = wall_ms(
                lambda: pm.sharded_cns_scan(mesh, res["msa"], G, T, D,
                                            min_cov))
            return res, ms
        _, first_one = one_card()
        one, ms_one = one_card()
        _, first_mesh = over_mesh()
        cnt = zero_counters()
        got, ms_mesh = over_mesh()
        launches = read_counters(cnt)
        equal = {"tb": all(tensors_equal(a, b) for a, b in
                           zip(got["tb"], one["tb"]))}
        equal.update((key, tensors_equal(got[key], one[key]))
                      for key in ("msa", "rows", "counts"))
        n = one["counts"].cpu()
        log(phase="consensus_mesh", card=card, T=T, G=G, D=D, B=B, L=L,
            W=W_MAIN, mesh=[str(d) for d in mesh],
            shard_rows=[hi - lo for lo, hi in pm.shard_bounds(B, len(mesh))],
            shard_groups=[hi - lo for lo, hi in
                          pm.shard_bounds(G, len(mesh))],
            mesh_ms=ms_mesh, one_card_ms=ms_one,
            first_pass_mesh_ms=first_mesh, first_pass_one_card_ms=first_one,
            launches=launches, equal_to_one_card=equal,
            emitted_min=int(n[:G - 1].min()), emitted_max=int(n.max()))
        if not all(equal.values()) or \
                min(launches[x] for x in ("K2", "K3", "K4", "K5", "K6")) < 1 \
                or int(n[:G - 1].min()) < 1:
            raise SystemExit("consensus_mesh at T=%d: equal %s, launches %s"
                             % (T, equal, launches))
        out[T] = {"mesh_ms": ms_mesh, "one_card_ms": ms_one}
        del q, ql, t, tl, one, got
        torch.cuda.empty_cache()
    log(phase="consensus_mesh_done", seconds=round(time.time() - t_phase, 3))
    return out


REPO = os.path.dirname(os.path.abspath(__file__))
SUPERVISE_TIMEOUT_S = 420
# the first supervisor's cooperative RSS limit: a driver process on the
# card holds more than this from its start (the phase logs its RSS at the
# recycle), so its first durable checkpoint recycles it; the supervisor's
# hard backstop, 1.5 x the limit + 4 GB, stays above what a driver holds
# between checkpoints
SUPERVISE_RSS_GB = 3.0


def loaded_by_import_log(text):
    """The jax / jaxlib / falcon_tpu modules named in a -X importtime log
    (PYTHONPROFILEIMPORTTIME=1: one line a module a process imports)."""
    mods = set()
    for ln in text.splitlines():
        if ln.startswith("import time:") and ln.count("|") == 2:
            name = ln.rsplit("|", 1)[1].strip()
            if name.split(".")[0] in ("jax", "jaxlib", "falcon_tpu"):
                mods.add(name)
    return sorted(mods)


def child_env():
    """The environment of a child command of the port: the repository
    first on PYTHONPATH (nothing is installed), no device or DP choice of
    this process, and every process's imports logged (-X importtime)."""
    env = dict(os.environ)
    for key in ("FTPU_CNS_DP", "FTPU_PROFILE", "FTPU_TORCH_DEVICE",
                "FTPU_RSS_LIMIT_GB"):
        env.pop(key, None)
    env["PYTHONPATH"] = REPO + (os.pathsep + env["PYTHONPATH"]
                                if env.get("PYTHONPATH") else "")
    env["PYTHONPROFILEIMPORTTIME"] = "1"
    return env


def children_of(pid):
    """The processes whose parent is pid (from /proc)."""
    out = []
    for d in os.listdir("/proc"):
        if not d.isdigit():
            continue
        try:
            with open("/proc/%s/stat" % d) as f:
                stat = f.read()
        except OSError:
            continue
        if int(stat.rsplit(")", 1)[1].split()[1]) == pid:
            out.append(int(d))
    return out


def kill_supervisor(proc):
    """SIGKILL a supervisor and the driver it started (a session of its
    own, so not in the supervisor's group): the supervisor is stopped
    first, so that it starts nothing more, and the phase waits until its
    children are gone."""
    import signal
    os.kill(proc.pid, signal.SIGSTOP)
    kids = children_of(proc.pid)
    for c in kids:
        for kill in (os.killpg, os.kill):   # a child may not have its
            try:                             # session yet
                kill(c, signal.SIGKILL)
            except ProcessLookupError:
                pass
    os.killpg(proc.pid, signal.SIGKILL)
    proc.wait()
    deadline = time.time() + 60
    while any(os.path.exists("/proc/%d" % c) for c in kids) and \
            time.time() < deadline:
        time.sleep(0.1)
    return kids


def supervise_cmd(out_dir, *opts):
    return [sys.executable, "-m", "falcon_tpu_torch.pipeline.supervise",
            "fc_run.cfg", out_dir, "--stall-min", "5", "--max-failures",
            "1"] + list(opts)


def phase_supervise(args, workdir, card, dp_digests):
    """`python -m falcon_tpu_torch.pipeline.supervise` on the smoke run's
    inputs with FTPU_CNS_DP=1, twice on one output directory.  The first
    supervisor's cooperative RSS limit, SUPERVISE_RSS_GB (handed to its
    child as FTPU_RSS_LIMIT_GB), recycles the driver at its first durable
    checkpoint; once it has restarted the driver, the supervisor and that
    driver are killed (SIGKILL, mid-phase).  A second supervisor with the
    default limit then resumes the run from the checkpoints to exit 0,
    every MP_ARTIFACTS file byte-equal to pipeline_dp's (dp_digests).
    Neither supervisor nor any driver may import a jax / falcon_tpu module
    (their -X importtime logs).  Each is killed when SUPERVISE_TIMEOUT_S
    is up.  Returns the run's output directory."""
    write_run(args, workdir, "supervise")
    out_dir = os.path.join(workdir, "out")
    env = child_env()
    env["FTPU_CNS_DP"] = "1"
    t0 = time.time()
    logs = [os.path.join(workdir, "supervise%d.log" % k) for k in (1, 2)]
    with open(logs[0], "w") as f:
        proc = subprocess.Popen(
            supervise_cmd(out_dir, "--rss-limit-gb", str(SUPERVISE_RSS_GB)),
            cwd=workdir, env=env, stdout=f, stderr=subprocess.STDOUT,
            start_new_session=True)
        # wait for the restart that follows the first recycle
        while proc.poll() is None and time.time() - t0 < \
                SUPERVISE_TIMEOUT_S:
            text = open(logs[0]).read()
            if "child recycled cleanly" in text and \
                    "supervise: attempt 2" in text and \
                    children_of(proc.pid):
                break
            time.sleep(0.2)
        first_rc = proc.poll()
        killed = kill_supervisor(proc) if first_rc is None else []
    t1 = time.time()
    with open(logs[1], "w") as f:
        proc = subprocess.Popen(supervise_cmd(out_dir), cwd=workdir,
                                env=env, stdout=f, stderr=subprocess.STDOUT,
                                start_new_session=True)
        try:
            rc = proc.wait(timeout=SUPERVISE_TIMEOUT_S)
        except subprocess.TimeoutExpired:
            rc = None
        finally:
            if proc.poll() is None:
                kill_supervisor(proc)
    t2 = time.time()
    texts = [open(fn).read() for fn in logs]
    lines = [[ln for ln in text.splitlines()
              if not ln.startswith("import time:")] for text in texts]
    # "<where>: rss <GB> >= limit ..." of each recycle, where and RSS kept
    recycled = [ln.split(" >= limit")[0][-48:] for ln in lines[0]
                if "recycling (exit" in ln]
    report = dict(
        first_s=t1 - t0, second_s=t2 - t1, first_exit=first_rc,
        killed_drivers=len(killed), recycled_at=recycled,
        attempts=[sum("supervise: attempt" in ln for ln in x)
                  for x in lines],
        recycles=[sum("child recycled cleanly" in ln for ln in x)
                  for x in lines],
        failures=[sum("supervise: child exited rc=" in ln for ln in x)
                  for x in lines])
    if first_rc is not None or rc != 0 or len(killed) != 1:
        raise SystemExit("supervise: first supervisor ended %s with %d "
                         "children, second exited %s; last lines %s %s"
                         % (first_rc, len(killed), rc, lines[0][-8:],
                            lines[1][-8:]))
    digests = artifact_digests(out_dir)
    same = {rel: digests[rel] == dp_digests[rel] for rel in MP_ARTIFACTS}
    loaded = loaded_by_import_log(texts[0] + texts[1])
    log(phase="supervise", card=card, **report,
        artifacts_equal_to_pipeline_dp=same, jax_or_falcon_tpu_modules=loaded)
    if report["recycles"][0] < 1 or not all(same.values()) or loaded:
        raise SystemExit("supervise: %s recycles, artifacts equal %s, "
                         "loaded %s" % (report["recycles"], same, loaded))
    return out_dir


# how falcon_tpu's own tools end on --help, where that is not usage and
# exit 0: falcon-task prints its usage and returns 2; these four take
# --help for a path and fail to open it
HELP_RC = {"tasks": 2, "actg_coordinate": 1, "contig_annotate": 1,
           "ctg_link_analysis": 1, "run": 1}
ON_ASM_DIR = ("actg_coordinate", "contig_annotate", "ctg_link_analysis")


def stream_group(seed):
    """One stream-mode group for fc_consensus (tests/test_mains.py's): a
    seed read and 11 supports, noisy copies of one 2.6 kb template."""
    from falcon_tpu_torch.utils import sim
    r = np.random.RandomState(seed)
    genome = sim.random_genome(3000, seed=seed + 1)
    tmpl = np.frombuffer(genome.encode(), np.uint8)[200:2800]
    lines = ["%09d %s" % (i, sim.mutate(tmpl, r, 0.01, 0.01, 0.01)
                          .tobytes().decode()) for i in range(12)]
    return "\n".join(lines + ["+ +", "- -"]) + "\n"


def phase_mains(card, asm_dir, workdir):
    """Every tool of falcon_tpu_torch.mains as `python -m ... --help`, all
    started together: exit 0 with a usage text, or as falcon_tpu's own
    tool ends (HELP_RC, a FileNotFoundError for a path tool); the path
    tools ON_ASM_DIR again on the supervise run's 2-asm-falcon, exit 0;
    fc_consensus in stream mode on a simulated group, byte-equal to
    cns.runner.run_consensus in this process.  No command may import a
    jax / falcon_tpu module."""
    from falcon_tpu_torch.cns import runner
    from falcon_tpu_torch.mains import consensus
    t0 = time.time()
    tools = sorted(f[:-3] for f in os.listdir(os.path.join(
        REPO, "falcon_tpu_torch", "mains"))
        if f.endswith(".py") and not f.startswith("__"))
    env = child_env()
    cmds = {tool: [sys.executable, "-m", "falcon_tpu_torch.mains." + tool,
                   "--help"] for tool in tools}
    cmds.update(("%s(asm)" % tool, [sys.executable, "-m",
                                    "falcon_tpu_torch.mains." + tool,
                                    asm_dir]) for tool in ON_ASM_DIR)
    argv = ["--min-cov", "2", "--min-cov-aln", "2", "--min-n-read", "5",
            "--output-multi", "--n-core", "0"]
    cmds["consensus(stream)"] = [sys.executable, "-m",
                                 "falcon_tpu_torch.mains.consensus"] + argv
    text = stream_group(3)
    procs = {name: subprocess.Popen(
        c, cwd=workdir, env=env, stdin=subprocess.PIPE,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for name, c in cmds.items()}
    res = {name: p.communicate(text if name == "consensus(stream)" else "",
                               timeout=120)
           for name, p in procs.items()}
    rcs = {name: p.returncode for name, p in procs.items()}
    bad = []
    for name, (out, err) in res.items():
        tool = name.split("(")[0]
        if name == tool:
            want = HELP_RC.get(tool, 0)
            ok = rcs[name] == want and (
                out.startswith("usage:") if want == 0 else
                tool == "tasks" or "FileNotFoundError" in err)
        else:               # a_ctg rows and contig links may be none
            ok = rcs[name] == 0
        if not ok or loaded_by_import_log(err):
            bad.append(name)
    cfg = runner.ConsensusConfig(min_cov=2, min_cov_aln=2, min_n_read=5,
                                 output_multi=True, n_core=0)
    buf = io.StringIO()
    runner.run_consensus(consensus.stream_groups(io.StringIO(text)), cfg,
                         buf)
    stream = res["consensus(stream)"][0]
    same = stream == buf.getvalue() and stream.startswith(">")
    log(phase="mains", card=card, tools=len(tools), exit_codes=rcs,
        failed=bad, consensus_stream_equal_in_process=same,
        consensus_stream_bytes=len(stream),
        seconds=round(time.time() - t0, 3))
    if bad or not same:
        raise SystemExit("mains: failed %s, consensus stream equal %s"
                         % (bad, same))


def phase_tools(card, dp_dir):
    """Every tool of falcon_tpu_torch.tools on the card, through the run()
    its main calls, on its own: check_assembly scores pipeline_dp's
    p_ctg.fa (in dp_dir, beside the truth genome.txt).  A tool that raises
    or misses its check fails the run."""
    from falcon_tpu_torch.tools import (bench_accumulate, check_assembly,
                                        profile_cns_dp, profile_extender,
                                        verify_quick)
    t0 = time.time()
    k123 = ("extend", "tb_fwd", "tb_bwd")
    runs = (
        ("check_assembly", check_assembly,
         [os.path.join(dp_dir, "2-asm-falcon", "p_ctg.fa"),
          os.path.join(dp_dir, "genome.txt"), "--device", "cuda"],
         lambda r: (r["mean_identity"] or 0) >= 0.995),
        ("verify_quick", verify_quick, ["--device", "cuda"],
         lambda r: min(r["launches"].get(k, 0) for k in k123) > 0),
        ("profile_extender", profile_extender,
         ["16384", "1024", "--W", "256"], lambda r: r["bit_equal"]),
        ("profile_cns_dp", profile_cns_dp, ["--genome-size", "300000"],
         lambda r: r["parity"]),
        ("bench_accumulate", bench_accumulate, [],
         lambda r: r["parity"] and r["index_add_parity"]))
    failed = []
    for name, tool, argv, ok in runs:
        t1 = time.time()
        res = tool.run(tool.parse_args(argv))
        log(**dict(res, phase="tools_" + name, card=card, argv=argv,
                   seconds=round(time.time() - t1, 3)))
        if not ok(res):
            failed.append(name)
    log(phase="tools", card=card, failed=failed,
        seconds=round(time.time() - t0, 3))
    if failed:
        raise SystemExit("tools: %s missed their checks" % failed)


def run_phases(args, rng, card, clock):
    """Every phase after env, in order; returns (the kernels list, the
    jax / falcon_tpu modules each pipeline_mp child loaded)."""
    phase_build()
    lat = phase_latency(card)
    e1, t1 = phase_k1(rng, card, clock)
    phase_sharded_k1(rng, card)
    e2, e3, t2 = phase_k2(rng, card, clock, lat)
    e_bands, t_bands = phase_tb_bands(rng, card, clock, lat)
    with tempfile.TemporaryDirectory() as d:
        launches, host_t, _ = phase_pipeline(args, d, dp=False)
    # kept to the end: the tools phase scores its p_ctg.fa
    dp_dir = tempfile.TemporaryDirectory()
    launches_dp, dp_t, dp_digests = phase_pipeline(args, dp_dir.name,
                                                   dp=True)
    phase_pipeline_mesh(args, card, dp_t, dp_digests)
    with tempfile.TemporaryDirectory() as d:
        children = phase_pipeline_mp(args, d, card, dp_digests)
    phases = ("phase0_masking", "phase0_overlap", "phase0_consensus",
              "phase1_overlap", "phase2_graph", "total")
    log(phase="pipeline_compare", card=card, **{
        key: {"host_msa": host_t.get(key), "device_dp": dp_t.get(key),
              "device_dp_2proc": [c[key] for c in children]}
        for key in phases})
    buckets = sorted(dp_t["phase0_cns_dp_batches"])
    buckets = sorted({buckets[0], buckets[-1]})
    log(phase="dp_buckets", hit=dp_t["phase0_cns_dp_batches"],
        checked=buckets)
    e_dp, t_dp = phase_dp_kernels(rng, card, clock, lat, buckets)
    t_new = time.time()
    phase_graft(card)
    phase_consensus_mesh(rng, card)
    with tempfile.TemporaryDirectory() as d:
        asm = os.path.join(phase_supervise(args, d, card, dp_digests),
                           "2-asm-falcon")
        phase_mains(card, asm, d)
    log(phase="slice_f_phases", seconds=round(time.time() - t_new, 3))
    phase_tools(card, dp_dir.name)
    dp_dir.cleanup()
    t_tb = t2[max(t2, key=lambda bl: (bl[1], bl[0]))]   # largest L bucket
    t_top = t_dp[buckets[-1]]
    t_blk = t_bands[(BLOCK_ROW_BAND, 1024)]
    rows = [("K1 banded extension", "extend.cu",
             "falcon_tpu/ops/align_pallas.py:50", launches["K1"], e1,
             t1[(W_MAIN, 1024)]),
            ("K2 traceback forward", "align_tb.cu",
             "falcon_tpu/ops/align_tb_pallas.py:39", launches["K2"], e2,
             t_tb["K2"]),
            ("K3 traceback walk", "align_tb.cu",
             "falcon_tpu/ops/align_tb_pallas.py:151", launches["K3"], e3,
             t_tb["K3"]),
            # the forms at a band the default run never takes
            ("K1 banded extension, wide kernel W %d" % K1_TIMED_BANDS[-1],
             "extend.cu", "falcon_tpu/ops/align_pallas.py:50",
             launches["K1 wide"], e1, t1[(K1_TIMED_BANDS[-1], 1024)]),
            ("K2 traceback forward, block route W %d" % BLOCK_ROW_BAND,
             "align_tb.cu", "falcon_tpu/ops/align_tb_pallas.py:39",
             launches["K2 block"], e_bands, t_blk["K2"]),
            ("K3 traceback walk, block route W %d" % BLOCK_ROW_BAND,
             "align_tb.cu", "falcon_tpu/ops/align_tb_pallas.py:151",
             launches["K3 block"], e_bands, t_blk["K3"])]
    rows += [(name, "cns_dp.cu", "falcon_tpu/ops/cns_dp.py:%d" % line,
              launches_dp[kk], e_dp[kk], t_top[kk])
             for kk, name, line in (("K4", "K4 tag accumulation", 203),
                                    ("K5", "K5 consensus scan", 456),
                                    ("K6", "K6 backtrack walk", 562))]
    # no single PyTorch call computes a banded edit DP, a traceback walk,
    # the tag decode-and-scatter, the consensus chain or its walk
    kernels = [dict(name=name, route="cuda",
                    source="falcon_tpu_torch/csrc/" + src, replaces=repl,
                    launches=n, max_abs_err=err, ms=t["ms"],
                    plain_ms=t["plain_ms"], bound_ms=t["bound_ms"],
                    bound_by=t["bound_by"], library_ms=None)
               for name, src, repl, n, err, t in rows]
    return kernels, {c["rank"]: c["loaded"] for c in children}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--genome-size", type=int, default=1_000_000)
    ap.add_argument("--block-mb", type=float, default=10)
    ap.add_argument("--seed", type=int, default=1)
    ap.add_argument("--log", default=None,
                    help="write the pipeline's INFO log to this file")
    ap.add_argument("--pipeline-child", nargs=2, default=None,
                    help=argparse.SUPPRESS)       # pipeline_mp's children
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this smoke "
              "run needs a CUDA GPU", file=sys.stderr)
        return 1
    if args.pipeline_child:
        return pipeline_child(*args.pipeline_child)
    if args.log:
        logging.basicConfig(
            filename=args.log, level=logging.INFO,
            format="%(asctime)s %(levelname)s %(name)s: %(message)s")
    rng = np.random.default_rng(args.seed)
    card = phase_env()
    clock = ClockSampler()
    try:
        kernels, child_loaded = run_phases(args, rng, card, clock)
    finally:
        clock.close()
    loaded = sorted(m for m in sys.modules
                    if m.split(".")[0] in ("jax", "jaxlib", "falcon_tpu"))
    log(phase="imports", jax_or_falcon_tpu_modules=loaded,
        pipeline_mp_children=child_loaded)
    if loaded or any(child_loaded.values()):
        raise SystemExit("the port loaded %s (children: %s)"
                         % (loaded, child_loaded))
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
