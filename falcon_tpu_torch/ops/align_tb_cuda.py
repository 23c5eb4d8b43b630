"""K2 + K3 wrapper: the hand-written CUDA alignment with traceback
(csrc/align_tb.cu, csrc/tb_sweep.cuh, csrc/band_dp.cuh).

Replaces falcon_tpu/ops/align_tb_pallas.py align_tb_batch_pallas
(emit_base=True).  On a CUDA tensor it launches K2 (forward DP + two-bit
trace) then K3 (traceback walk, packed moves and bases) or raises; on a CPU
tensor it runs the plain twin ops.align_tb.align_tb_batch.  LAUNCHES counts
each kernel's launches, whichever route ran it.

K2 and K3 each come as two kernels with one result, chosen by the band
alone (kernel_for): the warp-resident sweep and the windowed warp walk at
the bands they are instantiated for (WARP_WIDTHS), the block-per-row sweep
and a thread-per-row walk at every other band check_batch admits.  The two
routes lay their traces out differently (trace_shape) and each K3 reads its
own K2's; both spend two bits a cell (trace_row_bytes).
"""
import logging

import torch

from . import _build
from .align_tb import align_tb_batch

LAUNCHES = {"tb_fwd": 0, "tb_bwd": 0}

WARP_WIDTHS = (32, 64, 128, 256)    # bands of the warp route

log = logging.getLogger(__name__)
_logged = set()


def kernel_for(W):
    """Which route runs K2 + K3 at band W on a CUDA tensor: "warp"
    (csrc/tb_sweep.cuh and the windowed warp walk; W/32 cells a lane) or
    "block" (csrc/band_dp.cuh, a block of W threads per row, and a thread
    per row for the walk).  The band decides, never a failure of the other
    route."""
    if W % 32 or not 32 <= W <= 1024:
        raise ValueError("W must be a multiple of 32 in [32, 1024]; got %d"
                         % W)
    return "warp" if W in WARP_WIDTHS else "block"


def trace_row_bytes(L, W):
    """Bytes of K2's trace per batch row, on either route: 2L steps of W
    cells, two bits a cell."""
    return 2 * L * W // 4


def trace_shape(B, L, W):
    """Shape of K2's int32 trace on W's route: the warp route's
    [B, 2L * W/512, 32] (a lane's word packs 16/(W/32) steps), the block
    route's [B, 2L, W/16] (two bit planes of W bits a step)."""
    if kernel_for(W) == "warp":
        return (B, 2 * L * W // 512, 32)
    return (B, 2 * L, W // 16)


def align_tb_batch_cuda(q, qlen, t, tlen, W=256, end_bonus=3):
    """Same contract as ops.align_tb.align_tb_batch: returns (best_i,
    best_j, best_d, packed moves [ceil(2L/4), B] uint8, bases [2L, B]
    int8).

    The trace K2 writes for K3 is trace_row_bytes(L, W) per row; the caller
    bounds it through B (cns.device.DeviceCns._batch_for).  On a CUDA
    tensor the warp route wants L a multiple of 16; the block route takes
    any L."""
    if q.device.type == "cpu":
        _build.check_batch(q, qlen, t, tlen, W)
        return align_tb_batch(q, qlen, t, tlen, W=W, end_bonus=end_bonus)
    ends, trace = tb_forward_cuda(q, qlen, t, tlen, W, end_bonus)
    moves, bases = tb_backward_cuda(trace, ends, q, W)
    return ends[0], ends[1], ends[2], moves, bases


def _route(L, W):
    """kernel_for(W), logged once per band, after the route's check on L."""
    route = kernel_for(W)
    if route == "warp" and L % 16:
        raise ValueError("K2/K3's warp route takes L a multiple of 16; "
                         "got %d" % L)
    if W not in _logged:
        _logged.add(W)
        log.info("K2/K3 at W=%d: the %s route", W, route)
    return route


def tb_forward_cuda(q, qlen, t, tlen, W, end_bonus):
    """K2 alone, CUDA tensors only: returns (ends [3, B] int32, trace
    trace_shape(B, L, W) int32).  The trace layout is internal to K2/K3;
    the warp route's is ops.align_tb.pack_trace's.  A row's steps past
    qlen + tlen are left unwritten."""
    _build.check_batch(q, qlen, t, tlen, W)
    if q.device.type != "cuda":
        raise ValueError("tb_forward_cuda takes CUDA tensors; got %s"
                         % q.device)
    B, L = q.shape
    route = _route(L, W)
    ends = torch.empty((3, B), dtype=torch.int32, device=q.device)
    trace = torch.empty(trace_shape(B, L, W), dtype=torch.int32,
                        device=q.device)
    if B:
        lib = _build.lib()
        fn = lib.ftt_tb_fwd if route == "warp" else lib.ftt_tb_fwd_block
        with torch.cuda.device(q.device):
            _build.check(fn(
                q.data_ptr(), t.data_ptr(), qlen.data_ptr(),
                tlen.data_ptr(), B, L, W, end_bonus, ends.data_ptr(),
                trace.data_ptr(), _build.stream_of(q)),
                "K2 (%s, W=%d)" % (route, W))
        LAUNCHES["tb_fwd"] += 1
    return ends, trace


def tb_backward_cuda(trace, ends, q, W):
    """K3 alone, on K2's outputs and K2's q: returns the packed END->START
    move stream [ceil(2L/4), B] uint8 and the START->END base stream
    [2L, B] int8 (plain counterpart: ops.align_tb.walk_back, its moves
    through pack_moves)."""
    B = trace.shape[0]
    L = q.shape[-1]
    route = _route(L, W)
    if trace.device.type != "cuda" or trace.dtype != torch.int32 or \
            tuple(trace.shape) != trace_shape(B, L, W) or \
            not trace.is_contiguous():
        raise ValueError("trace must be a contiguous CUDA int32 %s"
                         % (trace_shape(B, L, W),))
    S = 2 * L
    if ends.dtype != torch.int32 or tuple(ends.shape) != (3, B) or \
            ends.device != trace.device or not ends.is_contiguous():
        raise ValueError("ends must be contiguous int32 [3, B] beside trace")
    if q.dtype != torch.int8 or tuple(q.shape) != (B, L) or \
            q.device != trace.device or not q.is_contiguous():
        raise ValueError("q must be contiguous int8 [B, L] beside trace")
    moves = torch.empty(((S + 3) // 4, B), dtype=torch.uint8,
                        device=trace.device)
    bases = torch.empty((S, B), dtype=torch.int8, device=trace.device)
    if B:
        lib = _build.lib()
        fn = lib.ftt_tb_bwd if route == "warp" else lib.ftt_tb_bwd_block
        with torch.cuda.device(trace.device):
            _build.check(fn(
                trace.data_ptr(), q.data_ptr(), ends.data_ptr(), B, L, W,
                moves.data_ptr(), bases.data_ptr(),
                _build.stream_of(trace)), "K3 (%s, W=%d)" % (route, W))
        LAUNCHES["tb_bwd"] += 1
    return moves, bases
