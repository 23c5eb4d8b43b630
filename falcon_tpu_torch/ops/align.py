"""Banded O(ND) greedy difference alignment -- exact host implementation.

Re-implements, bit-for-bit, the semantics of the reference's banded Myers
O(ND) aligner (reference: src/c/DW_banded.c:115-330 `align`): greedy
furthest-reaching point per diagonal k, with a band that is re-trimmed every
d to diagonals whose progress is within `band_tolerance` of the best, and a
traceback that reconstructs gapped alignment strings.

The inner loop over diagonals k (min_k..max_k step 2) is data-parallel --
within one d iteration only diagonals of equal parity are written while the
reads V[k-1]/V[k+1] come from the previous iteration -- so it is vectorized
over the band here (numpy) and over band x batch in the Pallas device kernel
(falcon_tpu_torch/ops/align_device.py).  The C code breaks out of the k loop at
the first diagonal that reaches an end of either sequence; we compute the
whole band and truncate at the first such lane, which leaves identical
V/U/d_path state.

This host version is the semantic oracle (validated against the compiled
reference C in tests/test_align_oracle.py) and performs host-side traceback
for device-scored pairs.
"""
import numpy as np

_GAP = ord("-")
_CHUNK = 16


class Alignment:
    __slots__ = ("aln_q_s", "aln_q_e", "aln_t_s", "aln_t_e", "dist",
                 "aln_str_size", "q_aln_str", "t_aln_str")

    def __init__(self):
        self.aln_q_s = 0
        self.aln_q_e = 0
        self.aln_t_s = 0
        self.aln_t_e = 0
        self.dist = 0
        self.aln_str_size = 0
        self.q_aln_str = b""
        self.t_aln_str = b""


def _as_u8(s):
    if isinstance(s, np.ndarray):
        return s.astype(np.uint8, copy=False)
    if isinstance(s, bytes):
        return np.frombuffer(s, dtype=np.uint8)
    return np.frombuffer(s.encode(), dtype=np.uint8)


def _lcp_extend(q, t, x, y, q_len, t_len):
    """Vectorized greedy match extension along diagonals.

    For every lane, advance (x, y) while x<q_len, y<t_len and q[x]==t[y]
    (the while loop at reference src/c/DW_banded.c:203-206)."""
    x = x.astype(np.int64)
    y = y.astype(np.int64)
    if len(x) == 0:
        return x, y
    # pad with distinct sentinels so out-of-range chunks never match
    qp = np.concatenate([q, np.full(_CHUNK, 254, dtype=np.uint8)])
    tp = np.concatenate([t, np.full(_CHUNK, 255, dtype=np.uint8)])
    alive = np.ones(len(x), dtype=bool)
    ar = np.arange(_CHUNK)
    while True:
        idx = np.nonzero(alive)[0]
        if len(idx) == 0:
            break
        xs = x[idx]
        ys = y[idx]
        n = np.minimum(np.minimum(q_len - xs, t_len - ys), _CHUNK)
        qa = qp[xs[:, None] + ar]
        ta = tp[ys[:, None] + ar]
        eq = (qa == ta) & (ar[None, :] < n[:, None])
        stop = ~eq
        any_stop = stop.any(axis=1)
        first_stop = np.argmax(stop, axis=1)
        run = np.where(any_stop, first_stop, _CHUNK)
        x[idx] = xs + run
        y[idx] = ys + run
        alive[idx] = run == _CHUNK
    return x, y


def align(query, target, band_tolerance, get_aln_str=True):
    """Exact reimplementation of reference `align` (src/c/DW_banded.c:115).

    query/target: str | bytes | uint8 array (raw base letters).
    Returns Alignment; on failure to align within max_d, all fields zero.
    """
    q = _as_u8(query)
    t = _as_u8(target)
    q_len, t_len = len(q), len(t)
    rtn = Alignment()

    max_d = int(0.3 * (q_len + t_len))
    band_size = band_tolerance * 2
    if max_d <= 0:
        return rtn
    k_offset = max_d
    V = np.zeros(2 * max_d + 1, dtype=np.int64)
    U = np.zeros(2 * max_d + 1, dtype=np.int64)
    dpath = {}

    best_m = -1
    min_k = 0
    max_k = 0
    aligned = False
    fin = None

    for d in range(max_d):
        if max_k - min_k > band_size:
            break
        ks = np.arange(min_k, max_k + 1, 2, dtype=np.int64)
        Vm = V[ks - 1 + k_offset]
        Vp = V[ks + 1 + k_offset]
        cond = (ks == min_k) | ((ks != max_k) & (Vm < Vp))
        x1 = np.where(cond, Vp, Vm + 1)
        pre_k = np.where(cond, ks + 1, ks - 1)
        y1 = x1 - ks
        x2, y2 = _lcp_extend(q, t, x1, y1, q_len, t_len)

        done = (x2 >= q_len) | (y2 >= t_len)
        if done.any():
            j = int(np.argmax(done))
            sl = slice(0, j + 1)
            ks_, x1_, y1_, x2_, y2_, pre_k_ = (
                ks[sl], x1[sl], y1[sl], x2[sl], y2[sl], pre_k[sl])
            aligned = True
        else:
            ks_, x1_, y1_, x2_, y2_, pre_k_ = ks, x1, y1, x2, y2, pre_k

        if get_aln_str:
            for i in range(len(ks_)):
                dpath[(d, int(ks_[i]))] = (int(x1_[i]), int(y1_[i]),
                                           int(x2_[i]), int(y2_[i]),
                                           int(pre_k_[i]))
        V[ks_ + k_offset] = x2_
        U[ks_ + k_offset] = x2_ + y2_
        if len(ks_):
            best_m = max(best_m, int((x2_ + y2_).max()))

        if aligned:
            fin = (d, int(ks_[-1]), int(x2_[-1]), int(y2_[-1]))

        # band trimming over the OLD [min_k, max_k] (DW_banded.c:227-243)
        k2 = np.arange(min_k, max_k + 1, 2, dtype=np.int64)
        sel = U[k2 + k_offset] >= best_m - band_tolerance
        if sel.any():
            new_min_k = int(k2[sel].min())
            new_max_k = int(k2[sel].max())
        else:
            new_min_k, new_max_k = max_k, min_k
        min_k = new_min_k - 1
        max_k = new_max_k + 1

        if aligned:
            break

    if not aligned:
        return rtn

    d, k, x, y = fin
    rtn.aln_q_e = x
    rtn.aln_t_e = y
    rtn.dist = d
    rtn.aln_str_size = (x + y + d) // 2
    if not get_aln_str:
        return rtn

    # traceback (DW_banded.c:263-320)
    path = []
    cd, ck = d, k
    while cd >= 0 and len(path) < q_len + t_len + 1:
        x1, y1, x2, y2, pre_k = dpath[(cd, ck)]
        path.append((x2, y2))
        path.append((x1, y1))
        ck = pre_k
        cd -= 1
    idx = len(path) - 1
    cx, cy = path[idx]
    rtn.aln_q_s = cx
    rtn.aln_t_s = cy
    qa = bytearray()
    ta = bytearray()
    aln_pos = 0
    while idx > 0:
        idx -= 1
        nx, ny = path[idx]
        if cx == nx and cy == ny:
            continue
        if nx == cx and ny != cy:  # advance in y
            qa.extend(b"-" * (ny - cy))
            ta.extend(t[cy:ny].tobytes())
            aln_pos += ny - cy
        elif nx != cx and ny == cy:  # advance in x
            qa.extend(q[cx:nx].tobytes())
            ta.extend(b"-" * (nx - cx))
            aln_pos += nx - cx
        else:  # diagonal
            qa.extend(q[cx:nx].tobytes())
            ta.extend(t[cy:ny].tobytes())
            aln_pos += ny - cy
        cx, cy = nx, ny
    rtn.q_aln_str = bytes(qa)
    rtn.t_aln_str = bytes(ta)
    rtn.aln_str_size = aln_pos
    return rtn
