"""K1 wrapper: the hand-written CUDA banded extension (csrc/extend.cu).

Replaces falcon_tpu/ops/align_pallas.py extend_batch_pallas.  On a CUDA
tensor it launches K1 or raises; on a CPU tensor it runs the plain twin
ops.align_device.extend_batch.  LAUNCHES counts each form's launches
("extend" the warp kernel's, "extend_wide" the wide one's), BY_DEVICE all
of them by device ("cuda:0", ...).

K1 is one warp-resident sweep at every band check_batch admits, a warp a
row and C = W/32 cells a lane; kernel_for names its two forms.
"""
import collections
import logging

import torch

from . import _build
from .align_device import extend_batch

LAUNCHES = {"extend": 0, "extend_wide": 0}
BY_DEVICE = collections.Counter()

log = logging.getLogger(__name__)
_logged = set()


def kernel_for(W):
    """Which form of K1 sweeps band W on a CUDA tensor, by W alone: "warp"
    up to W = 512 (csrc/tb_sweep.cuh without its trace, 1-16 cells a lane)
    or "wide" beyond (the same sweep at 17-32 cells a lane, q and t read as
    32-bit words).

    Each was chosen on an H100 over the form it replaced and the one it was
    timed against (tools/tb_compare.py; ms at the extender's (16384, 1024)
    / (4096, 8192), PERF.md §6): at W 96, 32 lanes of 3 cells
    against K2's 24 lanes of 4; beyond 512, one warp against segments of 8
    cells a lane trading edge cells (W 1024: 37.7 / 37.1 against 35.4 /
    52.4; W 544: 15.8 / 14.7 against 24.1 / 38.6)."""
    if W % 32 or not 32 <= W <= 1024:
        raise ValueError("W must be a multiple of 32 in [32, 1024]; got %d"
                         % W)
    return "warp" if W <= 512 else "wide"


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
        # the rows are handed out through a counter in device memory
        next_row = torch.zeros(1, dtype=torch.int32, device=q.device)
        code = lib.ftt_extend_warp(
            q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            B, L, W, end_bonus, ends.data_ptr(), next_row.data_ptr(),
            _build.stream_of(q))
        _build.check(code, "K1 (%s, W=%d)" % (kernel, W))
    LAUNCHES["extend" if kernel == "warp" else "extend_wide"] += 1
    BY_DEVICE[str(q.device)] += 1
    return ends
