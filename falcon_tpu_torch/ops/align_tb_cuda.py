"""K2 + K3 wrapper: the hand-written CUDA alignment with traceback
(csrc/align_tb.cu, csrc/tb_sweep.cuh).

Replaces falcon_tpu/ops/align_tb_pallas.py align_tb_batch_pallas
(emit_base=True).  On a CUDA tensor it launches K2 (forward DP + two-bit
trace) then K3 (traceback walk, packed moves and bases) or raises; on a CPU
tensor it runs the plain twin ops.align_tb.align_tb_batch.  LAUNCHES counts
each kernel's launches, whichever route ran it.

K2 and K3 each come as two kernels with one result, chosen by the band
alone (kernel_for): the warp-resident sweep and the windowed warp walk at
the bands they are instantiated for (WARP_WIDTHS), and at every other band
check_batch admits the block route: the same sweep cut into segments of a
few warps a row, and the windowed walk staging only the lanes it can
reach.  Both lay the trace out as lane-packed words of C cells
(trace_cells, trace_shape) and spend two bits a cell (trace_row_bytes).
LAUNCHES counts each kernel's launches: tb_fwd / tb_bwd the warp route's,
tb_fwd_block / tb_bwd_block the block route's.
"""
import logging

import torch

from . import _build
from .align_tb import align_tb_batch

LAUNCHES = {"tb_fwd": 0, "tb_bwd": 0, "tb_fwd_block": 0,
            "tb_bwd_block": 0}

WARP_WIDTHS = (32, 64, 128, 256)    # bands of the warp route

log = logging.getLogger(__name__)
_logged = set()


def kernel_for(W):
    """Which route runs K2 + K3 at band W on a CUDA tensor: "warp"
    (csrc/tb_sweep.cuh and the windowed warp walk; W/32 cells a lane) or
    "block" (the same sweep over W / (32 trace_cells(W)) warps a row, and
    the windowed walk on its trace).  The band decides, never a failure of
    the other route."""
    if W % 32 or not 32 <= W <= 1024:
        raise ValueError("W must be a multiple of 32 in [32, 1024]; got %d"
                         % W)
    return "warp" if W in WARP_WIDTHS else "block"


def trace_cells(W):
    """Band cells a lane sweeps, and a trace word's lane field holds, at
    band W: W/32 on the warp route.  On the block route the band is one
    warp's when 32 lanes of at most 16 cells hold it (the fewest cells a
    lane that do: W 96 is 24 lanes of 4, the top 8 lanes padding), else
    ceil(W/256) warps of 8 cells a lane trading edge cells; W/C a multiple
    of 4 either way (K3 stages a trace group in 16-byte pieces).  Measured
    on the card: one warp beats segments wherever it fits (W 512: 32 lanes
    of 16 against 2 warps of 8), and 4 warps of 8 beat 2 of 16 at W 1024
    (16 cells a lane in a segment take 117 registers)."""
    if kernel_for(W) == "warp":
        return W // 32
    for C in (1, 2, 4, 8, 16):
        if 32 * C >= W and W // C % 4 == 0:
            return C
    return 8


def trace_row_bytes(L, W):
    """Bytes of K2's trace per batch row, on either route: 2L steps of W
    cells, two bits a cell (exact when 2L is a multiple of 16/trace_cells,
    as at every ladder length; otherwise the last word's steps past 2L
    add under W*4 bytes)."""
    return 2 * L * W // 4


def trace_shape(B, L, W):
    """Shape of K2's int32 trace at band W: [B, ceil(2L/G), W/C] with
    C = trace_cells(W) and G = 16/C steps a word (ops.align_tb.pack_trace's
    layout): [B, 2L * W/512, 32] on the warp route."""
    C = trace_cells(W)
    return (B, -(-2 * L * C // 16), W // C)


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
    trace_shape(B, L, W) int32, ops.align_tb.pack_trace's layout with
    C = trace_cells(W)).  A row's steps past qlen + tlen are left
    unwritten, and on the block route so are a segment's words once none
    of its cells lies in [0, qlen] x [0, tlen] for the rest of the row."""
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
        ptrs = (q.data_ptr(), t.data_ptr(), qlen.data_ptr(),
                tlen.data_ptr(), B, L, W)
        with torch.cuda.device(q.device):
            if route == "warp":
                code = lib.ftt_tb_fwd(*ptrs, end_bonus, ends.data_ptr(),
                                      trace.data_ptr(), _build.stream_of(q))
            else:
                code = lib.ftt_tb_fwd_block(
                    *ptrs, trace_cells(W), end_bonus, ends.data_ptr(),
                    trace.data_ptr(), _build.stream_of(q))
            _build.check(code, "K2 (%s, W=%d)" % (route, W))
        LAUNCHES["tb_fwd" if route == "warp" else "tb_fwd_block"] += 1
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
        ptrs = (trace.data_ptr(), q.data_ptr(), ends.data_ptr(), B, L, W)
        outs = (moves.data_ptr(), bases.data_ptr(), _build.stream_of(trace))
        with torch.cuda.device(trace.device):
            if route == "warp":
                code = lib.ftt_tb_bwd(*ptrs, *outs)
            else:
                code = lib.ftt_tb_bwd_block(*ptrs, trace_cells(W), *outs)
            _build.check(code, "K3 (%s, W=%d)" % (route, W))
        LAUNCHES["tb_bwd" if route == "warp" else "tb_bwd_block"] += 1
    return moves, bases
