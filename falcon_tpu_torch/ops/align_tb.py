"""Banded alignment with traceback, plain (port of falcon_tpu/ops/align_tb.py).

`align_tb_batch` is the plain PyTorch twin of K2 + K3 (ops.align_tb_cuda):
the forward sweep of ops.align_device.band_sweep with its move planes kept,
then a walk from each row's end cell back to (0, 0).  It returns what
falcon_tpu's align_tb_batch_pallas(emit_base=True) returns.  `pack_moves`
(torch) packs the move stream four to a byte; `unpack_moves` and
`moves_to_alignment` are the numpy host side, re-implemented here because
their falcon_tpu home imports JAX.
"""
import numpy as np
import torch
import torch.nn.functional as F

from .align_device import band_off, band_sweep


def pack_moves(moves):
    """[S, B] int8 move codes (0..3) -> [ceil(S/4), B] uint8, four moves
    per byte, earliest stream index in the low bits."""
    S, B = moves.shape
    if S % 4:
        moves = F.pad(moves, (0, 0, 0, (-S) % 4), value=3)
    m = moves.to(torch.uint8).view(-1, 4, B)
    return m[:, 0] | (m[:, 1] << 2) | (m[:, 2] << 4) | (m[:, 3] << 6)


def unpack_moves(packed):
    """Host inverse of pack_moves: [P, B] uint8 -> [4P, B] int8; stream
    padding unpacks as 3 (inactive)."""
    P, B = packed.shape
    m = np.empty((P * 4, B), np.int8)
    m[0::4] = packed & 3
    m[1::4] = (packed >> 2) & 3
    m[2::4] = (packed >> 4) & 3
    m[3::4] = (packed >> 6) & 3
    return m


def moves_to_alignment(q_codes, t_codes, move_stream):
    """One pair's gapped alignment strings from its END->START move
    stream (3 = inactive).  Returns (q_aln, t_aln) ASCII bytes over
    'ACGT-', or (b"", b"")."""
    m = move_stream[move_stream != 3][::-1]          # start -> end
    if len(m) == 0:
        return b"", b""
    A = np.frombuffer(b"ACGT", dtype=np.uint8)
    gap = np.uint8(ord("-"))
    qi = np.cumsum(m != 1) - 1
    tj = np.cumsum(m != 2) - 1
    qa = np.where(m == 1, gap, A[np.minimum(q_codes[np.maximum(qi, 0)], 3)])
    ta = np.where(m == 2, gap, A[np.minimum(t_codes[np.maximum(tj, 0)], 3)])
    return qa.astype(np.uint8).tobytes(), ta.astype(np.uint8).tobytes()


def align_tb_batch(q, qlen, t, tlen, W=256, end_bonus=3):
    """Plain twin of K2 + K3.

    q: [B, L] codes (pad 4), t: [B, L] codes (pad 5), qlen/tlen: [B].
    Returns (best_i, best_j, best_d, moves, bases):
      best_*  [B] int32, as extend_batch;
      moves   [2L/4, B] uint8, the packed END->START move stream
              (0 = diag, 1 = up / gap in q, 2 = left / gap in t,
              3 = inactive step);
      bases   [2L, B] int8, indexed by anti-diagonal s - 1 in START->END
              order: q[i-1] where the move from s consumes q, else 4.
    """
    ends, planes = band_sweep(q, qlen, t, tlen, W, end_bonus,
                              keep_moves=True)
    moves, bases = walk_back(q, ends, planes, W)
    return ends[0], ends[1], ends[2], pack_moves(moves), bases


def walk_back(q, ends, planes, W):
    """Plain twin of K3: walk each row of band_sweep's move planes from
    its end cell (ends [3, B]) back to (0, 0).  Returns the unpacked
    END->START move stream [2L, B] int8 and the START->END base stream
    [2L, B] int8 of align_tb_batch."""
    B, L = q.shape
    dev = q.device
    S = 2 * L
    qpad = F.pad(q.to(torch.int32), (1, 1), value=4)   # qpad[i] = q[i-1]
    moves = torch.full((S, B), 3, dtype=torch.int8, device=dev)
    bases = torch.full((S, B), 4, dtype=torch.int8, device=dev)
    i = ends[0].clone()
    j = ends[1].clone()
    done = (i == 0) & (j == 0)
    for s in range(planes.shape[0], 0, -1):
        act = (i + j == s) & ~done
        lane = i - band_off(s, W)
        inb = (lane >= 0) & (lane < W)
        m = planes[s - 1].gather(1, lane.clamp(0, W - 1).long()[:, None])
        m = torch.where(inb & act, m[:, 0].to(torch.int32), 0)
        qc = qpad.gather(1, i.clamp(0, L + 1).long()[:, None])[:, 0]
        qc = torch.where(inb, qc.clamp_max(4), 0)
        m = torch.where(act, m, 3)
        moves[S - s] = m.to(torch.int8)
        bases[s - 1] = torch.where(act & (m != 1), qc, 4).to(torch.int8)
        i = i - ((m == 0) | (m == 2)).to(torch.int32)
        j = j - ((m == 0) | (m == 1)).to(torch.int32)
        done = done | ((i == 0) & (j == 0))
    return moves, bases
