"""K1 wrapper: the hand-written CUDA banded extension (csrc/extend.cu).

Replaces falcon_tpu/ops/align_pallas.py extend_batch_pallas.  On a CUDA
tensor it launches K1 or raises; on a CPU tensor it runs the plain twin
ops.align_device.extend_batch.  LAUNCHES["extend"] counts kernel launches,
BY_DEVICE the same launches by device ("cuda:0", ...).

K1 is two kernels with one result, chosen by the band alone (kernel_for):
the warp-resident sweep at the bands it is instantiated for (WARP_WIDTHS),
the block-per-row sweep at every other band check_batch admits.
"""
import collections
import logging

import torch

from . import _build
from .align_device import extend_batch

LAUNCHES = {"extend": 0}
BY_DEVICE = collections.Counter()

WARP_WIDTHS = (32, 64, 128, 256, 512)   # bands of the warp-resident sweep

log = logging.getLogger(__name__)
_logged = set()


def kernel_for(W):
    """Which of K1's kernels sweeps band W on a CUDA tensor: "warp"
    (csrc/tb_sweep.cuh without its trace, a warp per row) or "block"
    (csrc/band_dp.cuh, a block of W threads per row).  The band decides,
    never a failure of the other kernel."""
    if W % 32 or not 32 <= W <= 1024:
        raise ValueError("W must be a multiple of 32 in [32, 1024]; got %d"
                         % W)
    return "warp" if W in WARP_WIDTHS else "block"


def extend_batch_cuda(q, qlen, t, tlen, W=256, end_bonus=3):
    """q: [B, L] int8 (pad 4), t: [B, L] int8 (pad 5), qlen/tlen: [B]
    int32.  Returns [3, B] int32 rows (best_i, best_j, best_d)."""
    _build.check_batch(q, qlen, t, tlen, W)
    if q.device.type == "cpu":
        return extend_batch(q, qlen, t, tlen, W=W, end_bonus=end_bonus)
    if q.device.type != "cuda":
        raise ValueError("unsupported device %s" % q.device)
    B, L = q.shape
    ends = torch.empty((3, B), dtype=torch.int32, device=q.device)
    if B == 0:
        return ends
    lib = _build.lib()
    kernel = kernel_for(W)
    if W not in _logged:
        _logged.add(W)
        log.info("K1 at W=%d: the %s kernel", W, kernel)
    with torch.cuda.device(q.device):
        if kernel == "warp":
            # the rows are handed out through a counter in device memory
            next_row = torch.zeros(1, dtype=torch.int32, device=q.device)
            code = lib.ftt_extend_warp(
                q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
                B, L, W, end_bonus, ends.data_ptr(), next_row.data_ptr(),
                _build.stream_of(q))
        else:
            code = lib.ftt_extend_block(
                q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
                B, L, W, end_bonus, ends.data_ptr(), _build.stream_of(q))
        _build.check(code, "K1 (%s, W=%d)" % (kernel, W))
    LAUNCHES["extend"] += 1
    BY_DEVICE[str(q.device)] += 1
    return ends
