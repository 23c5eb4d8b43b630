"""The yardstick's peaks and the work of each kernel, counted from the
tasks the cell gave it (their lengths and the band), never from launch
shapes or padding, so a later kernel reads the same work whatever
implements it.

Frozen copies: the peaks and the least int32 operations per DP cell are
chip_smoke.py's (PEAK_BYTES_S, INT32_LANES, OPS_PER_CELL); band_cells is
falcon_tpu_torch/ops/align_device.py's closed form.  The clock is the
card's published boost clock, 1980 MHz (the clock chip_smoke.py measured
in every timed phase), not a sampled one.
"""
import numpy as np

PEAK_BYTES_S = 3.35e12                 # H100 SXM HBM3, published
INT32_LANES = 64 * 132                 # int32 lanes per clock (132 SMs)
CLOCK_HZ = 1980e6                      # published boost clock
PEAK_INT32_OPS_S = INT32_LANES * CLOCK_HZ
# The least int32 operations the recurrence needs per DP cell,
# D[i, j] = min(min(up, left) + 1, diag + (q != t)): the compare, the add
# of its result, two mins and the +1 (K1); those and the move's two bits
# (K2).
OPS_PER_CELL = {"K1": 5, "K2": 7}


def band_cells(qlen, tlen, W):
    """Per row, the DP cells (i, j) != (0, 0) of [0, qlen] x [0, tlen]
    inside the band of W lanes: the diagonals -W-1 <= i - j <= W-2, and
    (W-1, 0) (numpy int64, closed form)."""
    a = np.asarray(qlen, np.int64)
    c = np.asarray(tlen, np.int64) + 1

    def ramp(n):
        n = np.maximum(n, -1)
        m = np.minimum(n, c)
        return m * (m + 1) // 2 + np.maximum(n - c, 0) * c

    def above(k):
        return ramp(a - k) - ramp(-k - 1)

    return above(-W - 2) - above(W - 2) + (a >= W - 1) - 1


def k1_work(qlen, tlen, W):
    """(int32 operations, bytes) of the extension tasks: 5 operations a
    band cell; each task's bases read once at two bits a base and its
    (i, j, d) written once."""
    qlen = np.asarray(qlen, np.int64)
    tlen = np.asarray(tlen, np.int64)
    ops = int(band_cells(qlen, tlen, W).sum()) * OPS_PER_CELL["K1"]
    nbytes = int((qlen + tlen).sum()) // 4 + 12 * len(qlen)
    return ops, nbytes


def k2_work(qlen, tlen, W):
    """(int32 operations, bytes) of the consensus alignment sweep: 7
    operations a band cell; the bases read once, a byte each, the ends
    written, and the trace of two bits a lane a step written once (the
    rule of chip_smoke.py's K2 bound, over the tasks' own lengths)."""
    qlen = np.asarray(qlen, np.int64)
    tlen = np.asarray(tlen, np.int64)
    ops = int(band_cells(qlen, tlen, W).sum()) * OPS_PER_CELL["K2"]
    steps = qlen + tlen
    nbytes = int(steps.sum()) + 20 * len(qlen) + int(steps.sum()) * W // 4
    return ops, nbytes


def bound_s(ops, nbytes):
    """The least seconds the card could take: the larger of the two."""
    return max(ops / PEAK_INT32_OPS_S, nbytes / PEAK_BYTES_S)


def roofline_pct(ops, nbytes, kernel_s):
    """Share of the roofline in percent, or None with no kernel time."""
    if not kernel_s or kernel_s <= 0 or not ops:
        return None
    return 100.0 * bound_s(ops, nbytes) / kernel_s
