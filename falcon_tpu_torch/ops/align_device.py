"""Batched banded extension for the overlap engine (port of
falcon_tpu/ops/align_device.py).

Holds the plain PyTorch twin of the extension DP (`extend_batch`, the
semantics of falcon_tpu's extend_batch_device / extend_batch_pallas), the
task gathers (`gather_pad2`, `gather_specs2_packed`: plain torch ops, as
they were XLA ops in the reference), the host packers (`pack_flat_2bit`,
`pack_tasks`) and the batching front end `DeviceExtender`, which runs
every batch through the hand-written K1 kernel (ops.align_cuda) on the
GPU, or through the twin when its device is the CPU; every batch is cut
over the extender's mesh of one or more devices (parallel.mesh).

The DP, shared with ops.align_tb: anti-diagonals s = i + j, a band of W
lanes whose window offset o(s) = max(0, s//2 - W/2) tracks the main
diagonal, edit costs 1, and the "extension" end: the boundary cell
(i == qlen or j == tlen) maximising (i + j) - end_bonus * D, ties going to
the earliest anti-diagonal and then the lowest i.  Distances are clamped
to INF = 2^20 and only cells with D < INF are scored (the Pallas form);
a row with no such cell returns (0, 0, 0).
"""
import logging
import os

import numpy as np
import torch
import torch.nn.functional as F

from ..utils import trace
from ..utils.system import heartbeat_tick

LOG = logging.getLogger(__name__)

INF = 1 << 20
NEG = -(1 << 30)

# Padded task lengths: powers of two from 1024 (falcon_tpu LADDER).
LADDER = tuple(1 << s for s in range(10, 19))   # 1024 .. 262144


def band_off(s, W):
    """Window offset of anti-diagonal s: lane l holds cell i = o(s) + l."""
    return max(0, s // 2 - W // 2)


def band_sweep(q, qlen, t, tlen, W, end_bonus, keep_moves=False):
    """Plain forward sweep of the banded DP over a [B, L] batch.

    q/t: [B, L] int8 codes (q padded with 4, t with 5); qlen/tlen: [B].
    Returns (ends, moves): ends is [3, B] int32 rows (i, j, d); moves is
    None or, with keep_moves, the [S, B, W] int8 move planes of the S
    swept anti-diagonals (0 = diag, 1 = up, 2 = left).

    The batch stops at its last boundary cell, min(max(qlen + tlen), 2L),
    and at step s only rows from the first one still short of its own
    qlen + tlen are computed (rows arrive length-sorted from the
    batchers, so the rows left behind are all finished); the planes of
    finished rows are left unwritten and are never read.  The two
    boundary cells of a row at step s, (qlen, s - qlen) and
    (s - tlen, tlen), are the only cells it can score there."""
    B, L = q.shape
    dev = q.device
    i32 = torch.int32
    qlen = qlen.to(i32)
    tlen = tlen.to(i32)
    # qpad[x] == q[x - 1]; rtpad holds t reversed, so the band's t chars
    # t[j - 1] are an ascending slice (the XLA formulation)
    qpad = F.pad(q.to(torch.int8), (1, W + 2), value=4)
    rtpad = F.pad(t.to(torch.int8).flip(1), (W + 2, W + 2), value=5)
    lanes = torch.arange(W, dtype=i32, device=dev)
    # anti-diagonals s-2, s-1, s rotate through three INF-bordered rows
    buf = torch.full((3, B, W + 4), INF, dtype=i32, device=dev)
    buf[0, :, 2] = 0                      # s = 0: D[0, 0] at lane 0
    best = torch.full((B,), NEG, dtype=i32, device=dev)
    bi = torch.zeros(B, dtype=i32, device=dev)
    bj = torch.zeros(B, dtype=i32, device=dev)
    bd = torch.zeros(B, dtype=i32, device=dev)
    tot = (qlen + tlen).cpu().numpy()
    S = min(int(tot.max()), 2 * L) if B else 0
    # first row still alive at step s (all rows before it are finished),
    # and the shortest sides from each row on
    first = np.searchsorted(np.maximum.accumulate(tot), np.arange(S + 1))
    min_q = np.minimum.accumulate(qlen.cpu().numpy()[::-1])[::-1]
    min_t = np.minimum.accumulate(tlen.cpu().numpy()[::-1])[::-1]
    moves = torch.empty((S, B, W), dtype=torch.int8, device=dev) \
        if keep_moves else None
    for s in range(1, S + 1):
        r = int(first[s])
        o = band_off(s, W)
        d1 = o - band_off(s - 1, W)
        d2 = o - band_off(s - 2, W)
        prev = buf[(s - 1) % 3, r:]
        up = prev[:, 2 + d1:2 + d1 + W]                # D[i, j-1]
        left = prev[:, 1 + d1:1 + d1 + W]              # D[i-1, j]
        qc = qpad[r:, o:o + W]
        tc = rtpad[r:, W + 2 + L - s + o:W + 2 + L - s + o + W]
        v_diag = buf[(s - 2) % 3, r:, 1 + d2:1 + d2 + W] + (qc != tc)
        cand = torch.minimum(torch.minimum(up, left) + 1, v_diag)
        if keep_moves:
            # ties prefer diag, then up, then left
            mv = torch.where(v_diag == cand, 0,
                             torch.where(up + 1 == cand, 1, 2))
        if o == 0:
            # DP row 0 (lane 0: i = 0, D = j = s) walks up; column 0
            # (lane s: j = 0, D = i = s) walks left
            cand[:, 0] = s
            if keep_moves:
                mv[:, 0] = 1
            if s < W:
                cand[:, s] = s
                if keep_moves:
                    mv[:, s] = 2
        if keep_moves:
            moves[s - 1, r:] = mv
        if o + W - 1 < min_q[r] and s - o < min_t[r] and s >= o + W - 1:
            # every lane of every live row is a DP cell short of both
            # ends: nothing to mask, nothing to score
            buf[s % 3, r:, 2:2 + W] = cand
            continue
        ql = qlen[r:, None]
        tl = tlen[r:, None]
        # valid lanes: i <= qlen, j >= 0, j <= tlen
        valid = (lanes <= ql.clamp_max(s) - o) & (lanes >= s - tl - o)
        cur = torch.where(valid, cand, INF)
        buf[s % 3, r:, 2:2 + W] = cur
        ql = ql[:, 0]
        tl = tl[:, 0]
        la = ql - o                       # cell (qlen, s - qlen)
        lb = s - tl - o                   # cell (s - tlen, tlen)
        ok_a = (la >= 0) & (la < W) & (s - ql >= 0) & (s - ql <= tl)
        ok_b = (lb >= 0) & (lb < W) & (s - tl >= 0) & (s - tl <= ql)
        va = cur.gather(1, la.clamp(0, W - 1).long()[:, None])[:, 0]
        vb = cur.gather(1, lb.clamp(0, W - 1).long()[:, None])[:, 0]
        sa = torch.where(ok_a & (va < INF), s - end_bonus * va, NEG)
        sb = torch.where(ok_b & (vb < INF), s - end_bonus * vb, NEG)
        take_b = (sb > sa) | ((sb == sa) & (lb < la))
        m = torch.where(take_b, sb, sa)
        improved = m > best[r:]
        best[r:] = torch.where(improved, m, best[r:])
        i_win = o + torch.where(take_b, lb, la)
        bi[r:] = torch.where(improved, i_win, bi[r:])
        bj[r:] = torch.where(improved, s - i_win, bj[r:])
        bd[r:] = torch.where(improved, torch.where(take_b, vb, va), bd[r:])
    found = best > NEG
    ends = torch.stack([torch.where(found, bi, 0), torch.where(found, bj, 0),
                        torch.where(found, bd, 0)])
    return ends, moves


def extend_batch(q, qlen, t, tlen, W=512, end_bonus=3):
    """Plain twin of K1: [3, B] int32 rows (best_i, best_j, best_d).

    q: [B, L] codes (pad 4), t: [B, L] codes (pad 5), qlen/tlen: [B].
    Same results as falcon_tpu extend_batch_device / extend_batch_pallas.
    """
    return band_sweep(q, qlen, t, tlen, W, end_bonus)[0]


def band_cells(qlen, tlen, W):
    """Per row, the DP cells (i, j) != (0, 0) of [0, qlen] x [0, tlen]
    that a lane of the band holds at step s = i + j (numpy int64).

    With o(s) > 0 the lane i - o(s) is ceil(d/2) + W/2 for the diagonal
    d = i - j, so the band is the diagonals -W-1 <= d <= W-2; with
    o(s) = 0 (s <= W + 1) it is i <= W - 1, the same cells plus (W-1, 0).
    Counted in closed form: H(k) = #{cells with d > k}."""
    a = np.asarray(qlen, np.int64)
    c = np.asarray(tlen, np.int64) + 1          # cells per DP row

    def ramp(n):
        # sum of clip(x, 0, c) over x = 0 .. n (0 for n < 0)
        n = np.maximum(n, -1)
        m = np.minimum(n, c)
        return m * (m + 1) // 2 + np.maximum(n - c, 0) * c

    def above(k):
        # H(k) = sum over i = 0 .. a of clip(i - k, 0, c)
        return ramp(a - k) - ramp(-k - 1)

    return above(-W - 2) - above(W - 2) + (a >= W - 1) - 1


def gather_pad2(cat, q_offs, q_lens, t_offs, t_lens, L, fill_q, fill_t):
    """One flat int8 concat of all rows -> two [B, L] padded planes
    (falcon_tpu _gather_pad2)."""
    ar = torch.arange(L, device=cat.device)
    cap = cat.shape[0] - 1

    def one(offs, lens, fill):
        idx = (offs.long()[:, None] + ar).clamp_max(cap)
        return torch.where(ar < lens[:, None], cat[idx], fill)

    return one(q_offs, q_lens, fill_q), one(t_offs, t_lens, fill_t)


def gather_specs2_packed(packed, q_off, q_len, q_dir, t_off, t_len, t_dir,
                         L, fill_q, fill_t):
    """[B, L] q/t planes from (offset, len, dir) specs over 2-bit packed
    words (falcon_tpu _gather_specs2_packed; the per-element formulation
    of _gather_specs2_packed_ref).  packed: int64 tensor of uint32 words,
    base x in bits 2*(x%16) of word x//16; dir = -1 reads the slice
    reversed (an anchor's backward extension)."""
    ar = torch.arange(L, device=packed.device)
    cap = packed.shape[0] * 16 - 1

    def one(off, ln, dr, fill):
        idx = (off.long()[:, None] + ar * dr.long()[:, None]).clamp(0, cap)
        b = (packed[idx >> 4] >> (2 * (idx & 15))) & 3
        return torch.where(ar < ln[:, None], b.to(torch.int8),
                           trace.to_device(torch.tensor(fill,
                                                        dtype=torch.int8),
                                           packed.device))

    return one(q_off, q_len, q_dir, fill_q), one(t_off, t_len, t_dir,
                                                 fill_t)


def pack_flat_2bit(flat_u8):
    """Host: flat uint8 codes -> 2-bit packed uint32 words (16 bases per
    word, base i in bits 2*(i%16)); non-ACGT codes map to 3, the DAZZ_DB
    convention (falcon_tpu pack_flat_2bit)."""
    n = len(flat_u8)
    d = np.zeros(n + (-n) % 16, np.uint32)
    d[:n] = np.where(flat_u8 < 4, flat_u8, 3)
    shifts = (2 * np.arange(16, dtype=np.uint32))[None, :]
    return (d.reshape(-1, 16) << shifts).sum(axis=1, dtype=np.uint32)


def pack_tasks(tasks, idxs, B, device="cpu"):
    """Host side of gather_pad2 (falcon_tpu _pack_tasks, less its
    padding): the tasks' q/t codes concatenated into one int8 buffer of
    the bytes they use and one zero byte after them, the last that
    gather_pad2's clamp reads (falcon_tpu's buffer is 2*B*L + 1 bytes,
    zeros past the tasks), and one int32 [4, B] block of q offsets, q
    lengths, t offsets and t lengths, zero past the tasks.  Returns the
    two as host tensors to copy to `device`, page-locked when it is CUDA
    (trace.host_buffer)."""
    parts = []
    for idx in idxs:
        qc, tc = tasks[idx]
        parts.append(qc)
        parts.append(tc)
    n = len(parts)
    lens = np.fromiter((len(p) for p in parts), dtype=np.int64, count=n)
    offs = np.zeros(n + 1, np.int64)
    np.cumsum(lens, out=offs[1:])
    used = int(offs[-1])
    cat = trace.host_buffer(used + 1, torch.int8, device)
    codes = cat.numpy().view(np.uint8)
    if n:
        np.concatenate(parts, out=codes[:used])
    codes[used] = 0
    meta = trace.host_buffer((4, B), torch.int32, device)
    m = meta.numpy()
    m[:, n // 2:] = 0
    m[0, :n // 2] = offs[0:n:2]
    m[1, :n // 2] = lens[0::2]
    m[2, :n // 2] = offs[1:n:2]
    m[3, :n // 2] = lens[1::2]
    return cat, meta


class DeviceExtender:
    """Length-bucketed batching front end for the extension kernel.

    run_specs() takes tasks as (offset, len, dir) slices of one flat code
    array that goes to the device once, 2-bit packed, and returns an
    [n, 3] int64 array of per-task (i, j, d).  Every batch runs through K1
    (ops.align_cuda); on a CPU device the wrapper runs its plain twin.

    Every batch is cut over the extender's mesh (parallel.mesh), as
    falcon_tpu shards it when it sees several devices (align_device.py:
    348-359, 417-443, 469-481, 516-536): run_specs() copies the packed
    codes to each device of the mesh once a call (replicate) and runs
    sharded_specs_extend.  The mesh is `devices` when given, else
    parallel.mesh.extender_mesh(device): every visible GPU when CUDA was
    asked for without an index, else the one device.  A mesh of one entry
    is one gather and one K1 launch a batch."""

    def __init__(self, W=512, end_bonus=3, max_batch=128, device=None,
                 devices=None):
        from ..parallel.mesh import extender_mesh
        self.mesh = extender_mesh(device, devices)
        if len(self.mesh) > 1:
            LOG.info("extender: batches sharded over %s",
                     [str(d) for d in self.mesh])
        self.W = W
        self.end_bonus = end_bonus
        self.max_batch = max_batch
        # dispatched-but-uncollected batches; past the cap the oldest are
        # copied back before more are queued
        self.inflight_cap = int(os.environ.get("FTPU_INFLIGHT_BATCHES",
                                               "16"))
        self.cells_issued = 0
        self.cells_useful = 0

    def _drain(self, inflight, results, keep):
        """Copy back all but the newest `keep` in-flight batches; returns
        the seconds spent waiting (its extender.wait span's)."""
        if len(inflight) <= keep:
            return 0.0
        with trace.span("extender.wait", clock=True) as sp:
            while len(inflight) > keep:
                chunk, out = inflight.pop(0)
                results[chunk] = trace.to_host(out).T[:len(chunk)]
        return sp.seconds

    def run_specs(self, flat, q_off, q_len, q_dir, t_off, t_len, t_dir):
        """Every task row is an (offset, len, dir) slice of `flat` (uint8
        codes), which goes to each device of the mesh once, 2-bit
        packed."""
        from ..parallel.mesh import replicate, sharded_specs_extend
        n = len(q_off)
        results = np.zeros((n, 3), np.int64)
        if n == 0:
            return results
        inflight = []
        t_wait = 0.0
        n_batches = 0
        with trace.span("extender.run", clock=True, tasks=n) as sp:
            cap = np.minimum(q_len, t_len) + (self.W // 2 + 8)
            q_len = np.minimum(q_len, cap).astype(np.int32)
            t_len = np.minimum(t_len, cap).astype(np.int32)
            Ls = self._bucket_ladder(np.maximum(np.maximum(q_len, t_len), 1))
            words = replicate(torch.from_numpy(
                pack_flat_2bit(flat).astype(np.int64)), self.mesh)
            specs = np.stack([q_off, q_len, q_dir, t_off, t_len, t_dir]) \
                .astype(np.int32)
            buckets = np.unique(Ls)
            for L in buckets:
                idxs = np.nonzero(Ls == L)[0]
                idxs = idxs[np.argsort((q_len + t_len)[idxs], kind="stable")]
                L = int(L)
                B = self._batch_for(L)
                self._account_cells(q_len[idxs], t_len[idxs])
                for ofs in range(0, len(idxs), B):
                    chunk = idxs[ofs:ofs + B]
                    # each shard's specs go to its device in one copy
                    inflight.append((chunk, sharded_specs_extend(
                        self.mesh, words, specs[:, chunk], L, self.W,
                        self.end_bonus)))
                    n_batches += 1
                    heartbeat_tick()
                    t_wait += self._drain(inflight, results,
                                          self.inflight_cap)
            t_wait += self._drain(inflight, results, 0)
        LOG.info("extender(specs): %d tasks, %d buckets, %d batches; "
                 "dispatch %.1fs wait %.1fs", n, len(buckets), n_batches,
                 sp.seconds - t_wait, t_wait)
        return results

    def _account_cells(self, qlen, tlen):
        """Issued vs useful lane-steps of one bucket, each task counted
        once whatever its shard.  K1 sweeps each row
        for its own qlen + tlen steps with all W lanes, so it issues
        W * (qlen + tlen) lane-steps (batch mates cost a row nothing,
        unlike the TPU kernel's 256-row tiles, falcon_tpu
        align_device._account_cells); the useful ones are the lanes that
        hold a DP cell of the row (band_cells), the rest are masked."""
        qlen = np.asarray(qlen, np.int64)
        tlen = np.asarray(tlen, np.int64)
        self.cells_issued += int((qlen + tlen).sum()) * self.W
        self.cells_useful += int(band_cells(qlen, tlen, self.W).sum())

    def occupancy(self):
        """Useful / issued lane-steps over every batch so far."""
        if not self.cells_issued:
            return None
        return self.cells_useful / self.cells_issued

    def _bucket_ladder(self, m):
        """Per-task padded length: smallest ladder rung >= max side."""
        Ls = np.full(len(m), LADDER[-1], np.int64)
        for rung in reversed(LADDER):
            Ls = np.where(m <= rung, rung, Ls)
        return Ls

    def _batch_for(self, L):
        """Rows per launch: max_batch * 64K cells.  K1 runs one block per
        row with no tile shape to fill, so B needs no rounding; the cap
        bounds the [B, L] gather temporaries (int64 indices)."""
        return min(max(self.max_batch * 65536 // L, 256), 16384)
