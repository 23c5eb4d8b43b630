"""K2 + K3 wrapper: the hand-written CUDA alignment with traceback
(csrc/align_tb.cu).

Replaces falcon_tpu/ops/align_tb_pallas.py align_tb_batch_pallas
(emit_base=True).  On a CUDA tensor it launches K2 (forward DP + trace)
then K3 (traceback walk) or raises; on a CPU tensor it runs the plain twin
ops.align_tb.align_tb_batch.  LAUNCHES counts each kernel's launches.
"""
import torch

from . import _build
from .align_tb import align_tb_batch, pack_moves

LAUNCHES = {"tb_fwd": 0, "tb_bwd": 0}


def align_tb_batch_cuda(q, qlen, t, tlen, W=256, end_bonus=3):
    """Same contract as ops.align_tb.align_tb_batch: returns (best_i,
    best_j, best_d, packed moves [2L/4, B] uint8, bases [2L, B] int8).

    The trace K2 writes for K3 is [B, 2L, W] int8 (2*L*B*W bytes); the
    caller bounds it through B (cns.device.DeviceCns._batch_for)."""
    if q.device.type == "cpu":
        _build.check_batch(q, qlen, t, tlen, W)
        return align_tb_batch(q, qlen, t, tlen, W=W, end_bonus=end_bonus)
    ends, trace = tb_forward_cuda(q, qlen, t, tlen, W, end_bonus)
    moves, bases = tb_backward_cuda(trace, ends, W)
    return ends[0], ends[1], ends[2], pack_moves(moves), bases


def tb_forward_cuda(q, qlen, t, tlen, W, end_bonus):
    """K2 alone, CUDA tensors only: returns (ends [3, B] int32, trace
    [B, 2L, W] int8).  The trace layout is internal to K2/K3; its plain
    counterpart is ops.align_device.band_sweep(keep_moves=True)."""
    _build.check_batch(q, qlen, t, tlen, W)
    if q.device.type != "cuda":
        raise ValueError("tb_forward_cuda takes CUDA tensors; got %s"
                         % q.device)
    B, L = q.shape
    ends = torch.empty((3, B), dtype=torch.int32, device=q.device)
    trace = torch.empty((B, 2 * L, W), dtype=torch.int8, device=q.device)
    if B:
        with torch.cuda.device(q.device):
            _build.check(_build.lib().ftt_tb_fwd(
                q.data_ptr(), t.data_ptr(), qlen.data_ptr(),
                tlen.data_ptr(), B, L, W, end_bonus, ends.data_ptr(),
                trace.data_ptr(), _build.stream_of(q)), "K2")
        LAUNCHES["tb_fwd"] += 1
    return ends, trace


def tb_backward_cuda(trace, ends, W):
    """K3 alone, on K2's outputs: returns the END->START move stream and
    the START->END base stream, both [2L, B] int8 (plain counterpart:
    ops.align_tb.walk_back)."""
    B, S, Wt = trace.shape
    if trace.device.type != "cuda" or trace.dtype != torch.int8 or \
            Wt != W or not trace.is_contiguous():
        raise ValueError("trace must be a contiguous CUDA int8 [B, 2L, W]")
    if ends.dtype != torch.int32 or tuple(ends.shape) != (3, B) or \
            ends.device != trace.device or not ends.is_contiguous():
        raise ValueError("ends must be contiguous int32 [3, B] beside trace")
    moves = torch.empty((S, B), dtype=torch.int8, device=trace.device)
    bases = torch.empty((S, B), dtype=torch.int8, device=trace.device)
    if B:
        with torch.cuda.device(trace.device):
            _build.check(_build.lib().ftt_tb_bwd(
                trace.data_ptr(), ends.data_ptr(), B, S // 2, W,
                moves.data_ptr(), bases.data_ptr(),
                _build.stream_of(trace)), "K3")
        LAUNCHES["tb_bwd"] += 1
    return moves, bases
