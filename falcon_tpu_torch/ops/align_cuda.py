"""K1 wrapper: the hand-written CUDA banded extension (csrc/extend.cu).

Replaces falcon_tpu/ops/align_pallas.py extend_batch_pallas.  On a CUDA
tensor it launches K1 or raises; on a CPU tensor it runs the plain twin
ops.align_device.extend_batch.  LAUNCHES["extend"] counts kernel launches.
"""
import torch

from . import _build
from .align_device import extend_batch

LAUNCHES = {"extend": 0}


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
    with torch.cuda.device(q.device):
        _build.check(lib.ftt_extend(
            q.data_ptr(), t.data_ptr(), qlen.data_ptr(), tlen.data_ptr(),
            B, L, W, end_bonus, ends.data_ptr(), _build.stream_of(q)), "K1")
    LAUNCHES["extend"] += 1
    return ends
