"""K2 + K3 wrapper: the hand-written CUDA alignment with traceback
(csrc/align_tb.cu, csrc/tb_sweep.cuh).

Replaces falcon_tpu/ops/align_tb_pallas.py align_tb_batch_pallas
(emit_base=True).  On a CUDA tensor it launches K2 (forward DP + two-bit
trace) then K3 (traceback walk, packed moves and bases) or raises; on a CPU
tensor it runs the plain twin ops.align_tb.align_tb_batch.  LAUNCHES counts
each kernel's launches.
"""
import torch

from . import _build
from .align_tb import align_tb_batch

LAUNCHES = {"tb_fwd": 0, "tb_bwd": 0}

WIDTHS = (32, 64, 128, 256)    # bands the kernels are instantiated for


def trace_row_bytes(L, W):
    """Bytes of K2's trace per batch row: 2L steps of W cells, two bits a
    cell."""
    return 2 * L * W // 4


def align_tb_batch_cuda(q, qlen, t, tlen, W=256, end_bonus=3):
    """Same contract as ops.align_tb.align_tb_batch: returns (best_i,
    best_j, best_d, packed moves [2L/4, B] uint8, bases [2L, B] int8).

    The trace K2 writes for K3 is trace_row_bytes(L, W) per row; the caller
    bounds it through B (cns.device.DeviceCns._batch_for).  On a CUDA
    tensor W must be one of WIDTHS and L a multiple of 16."""
    if q.device.type == "cpu":
        _build.check_batch(q, qlen, t, tlen, W)
        return align_tb_batch(q, qlen, t, tlen, W=W, end_bonus=end_bonus)
    ends, trace = tb_forward_cuda(q, qlen, t, tlen, W, end_bonus)
    moves, bases = tb_backward_cuda(trace, ends, q, W)
    return ends[0], ends[1], ends[2], moves, bases


def _check_shape(L, W):
    if W not in WIDTHS:
        raise ValueError("K2/K3 take W in %s; got %d" % (WIDTHS, W))
    if L % 16:
        raise ValueError("K2/K3 take L a multiple of 16; got %d" % L)


def tb_forward_cuda(q, qlen, t, tlen, W, end_bonus):
    """K2 alone, CUDA tensors only: returns (ends [3, B] int32, trace
    [B, 2L * W/512, 32] int32).  The trace layout is internal to K2/K3
    (ops.align_tb.pack_trace builds it from the plain sweep's planes,
    unpack_trace reads it back); a row's steps past qlen + tlen are left
    unwritten."""
    _build.check_batch(q, qlen, t, tlen, W)
    if q.device.type != "cuda":
        raise ValueError("tb_forward_cuda takes CUDA tensors; got %s"
                         % q.device)
    B, L = q.shape
    _check_shape(L, W)
    ends = torch.empty((3, B), dtype=torch.int32, device=q.device)
    trace = torch.empty((B, 2 * L * W // 512, 32), dtype=torch.int32,
                        device=q.device)
    if B:
        with torch.cuda.device(q.device):
            _build.check(_build.lib().ftt_tb_fwd(
                q.data_ptr(), t.data_ptr(), qlen.data_ptr(),
                tlen.data_ptr(), B, L, W, end_bonus, ends.data_ptr(),
                trace.data_ptr(), _build.stream_of(q)), "K2")
        LAUNCHES["tb_fwd"] += 1
    return ends, trace


def tb_backward_cuda(trace, ends, q, W):
    """K3 alone, on K2's outputs and K2's q: returns the packed END->START
    move stream [2L/4, B] uint8 and the START->END base stream [2L, B] int8
    (plain counterpart: ops.align_tb.walk_back, its moves through
    pack_moves)."""
    B = trace.shape[0]
    L = q.shape[-1]
    _check_shape(L, W)
    if trace.device.type != "cuda" or trace.dtype != torch.int32 or \
            tuple(trace.shape) != (B, 2 * L * W // 512, 32) or \
            not trace.is_contiguous():
        raise ValueError("trace must be a contiguous CUDA int32 "
                         "[B, 2L * W/512, 32]")
    S = 2 * L
    if ends.dtype != torch.int32 or tuple(ends.shape) != (3, B) or \
            ends.device != trace.device or not ends.is_contiguous():
        raise ValueError("ends must be contiguous int32 [3, B] beside trace")
    if q.dtype != torch.int8 or tuple(q.shape) != (B, L) or \
            q.device != trace.device or not q.is_contiguous():
        raise ValueError("q must be contiguous int8 [B, L] beside trace")
    moves = torch.empty((S // 4, B), dtype=torch.uint8, device=trace.device)
    bases = torch.empty((S, B), dtype=torch.int8, device=trace.device)
    if B:
        with torch.cuda.device(trace.device):
            _build.check(_build.lib().ftt_tb_bwd(
                trace.data_ptr(), q.data_ptr(), ends.data_ptr(), B, L, W,
                moves.data_ptr(), bases.data_ptr(),
                _build.stream_of(trace)), "K3")
        LAUNCHES["tb_bwd"] += 1
    return moves, bases
