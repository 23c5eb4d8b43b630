"""falcon_tpu_torch.ops.align_tb (plain twin of K2 + K3) against
falcon_tpu's align_tb_batch and align_tb_batch_pallas on the CPU: bit-equal
on (i, j, d, packed moves, bases); plus the two-bit trace between K2 and K3
(pack_trace / unpack_trace) and the batcher's budget for it."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from falcon_tpu.ops import align_tb as jtb
from falcon_tpu.ops.align_tb_pallas import align_tb_batch_pallas
from falcon_tpu_torch.cns import device as tdev
from falcon_tpu_torch.ops import align_tb as ttb
from falcon_tpu_torch.ops.align_device import LADDER, band_off, band_sweep
from falcon_tpu_torch.ops import align_tb_cuda
from falcon_tpu_torch.ops.align_tb_cuda import (align_tb_batch_cuda,
                                                kernel_for, trace_cells,
                                                trace_row_bytes, trace_shape)

from tests.test_torch_align_device import _edge_rows, _pairs


def _port(q, qlen, t, tlen, W):
    return [x.numpy() for x in align_tb_batch_cuda(
        torch.from_numpy(q), torch.from_numpy(qlen), torch.from_numpy(t),
        torch.from_numpy(tlen), W=W)]


@pytest.mark.parametrize("W,L,edge", [(64, 128, False), (64, 128, True),
                                      (32, 256, False), (96, 256, True),
                                      (512, 640, True)])
def test_align_tb_batch_matches_jax(W, L, edge):
    """W 96 and 512 are bands of the kernels' block route."""
    q, qlen, t, tlen = _pairs(8, L, err=0.15, seed=7)
    if edge:
        _edge_rows(q, qlen, t, tlen, seed=9)
    args = (jnp.asarray(q), jnp.asarray(qlen), jnp.asarray(t),
            jnp.asarray(tlen))
    xla = [np.asarray(x) for x in jtb.align_tb_batch(*args, W=W)]
    pal = [np.asarray(x) for x in align_tb_batch_pallas(
        *args, W=W, block_b=8, interpret=True, emit_base=True)]
    got = _port(q, qlen, t, tlen, W)
    for name, g, x in zip("i j d moves".split(), got, xla):
        np.testing.assert_array_equal(g, x, err_msg="xla " + name)
    # the Pallas kernel never scores a one-side-empty row (see
    # test_torch_align_device.test_extend_batch_edge_rows)
    rows = [b for b in range(8) if not (edge and b in (1, 2))]
    for name, g, p in zip("i j d moves bases".split(), got, pal):
        np.testing.assert_array_equal(g[..., rows], p[..., rows],
                                      err_msg="pallas " + name)


def test_moves_roundtrip():
    """unpack_moves / moves_to_alignment: the columns rebuild the end
    cell and the distance (tests/test_cns_device.py::
    test_align_tb_roundtrip), and match falcon_tpu's host functions."""
    rng = np.random.RandomState(11)
    q, qlen, t, tlen = _pairs(4, 512, err=0.2, seed=12)
    bi, bj, bd, mvp, _ = _port(q, qlen, t, tlen, 128)
    mv = ttb.unpack_moves(mvp)
    np.testing.assert_array_equal(mv, jtb.unpack_moves(mvp))
    np.testing.assert_array_equal(
        ttb.pack_moves(torch.from_numpy(mv)).numpy(), mvp)
    for b in range(4):
        qc = q[b, :qlen[b]].astype(np.uint8)
        tc = t[b, :tlen[b]].astype(np.uint8)
        qa, ta = ttb.moves_to_alignment(qc, tc, mv[:, b])
        assert (qa, ta) == jtb.moves_to_alignment(qc, tc, mv[:, b])
        assert len(qa) == len(ta) > 0
        nq = sum(1 for c in qa if c != ord("-"))
        nt = sum(1 for c in ta if c != ord("-"))
        assert (nq, nt) == (bi[b], bj[b])
        assert sum(1 for a, c in zip(qa, ta) if a != c) == bd[b]
    odd = rng.randint(0, 4, (7, 3)).astype(np.int8)
    np.testing.assert_array_equal(
        ttb.pack_moves(torch.from_numpy(odd)).numpy(),
        np.asarray(jtb.pack_moves(jnp.asarray(odd))))


@pytest.mark.parametrize("W,L", [(32, 96), (64, 128), (256, 320)])
def test_trace_roundtrip(W, L, monkeypatch):
    """band_sweep's planes -> two bits a cell -> planes again, on rows of
    full length, rows shorter than the batch's L and the edge rows; the
    conversion in chunks of about 50 steps, so the chunk seams are crossed.
    The layout is the kernels': with C = W/32 and G = 16/C, word (s-1)//G
    of lane n holds the move of cell n*C + c at step s in field
    ((s-1) % G)*C + c, two bits a field."""
    monkeypatch.setattr(ttb, "TRACE_CHUNK", 50)
    q, qlen, t, tlen = _pairs(8, L, err=0.15, seed=3)
    _edge_rows(q, qlen, t, tlen, seed=4)
    qlen[5], tlen[5] = min(qlen[5], 40), min(tlen[5], 37)   # a short row
    q[5, qlen[5]:] = 4
    t[5, tlen[5]:] = 5
    args = [torch.from_numpy(a) for a in (q, qlen, t, tlen)]
    ends, planes = band_sweep(*args, W, 3, keep_moves=True)
    S = planes.shape[0]
    assert S <= 2 * L
    # band_sweep leaves the planes of finished rows unwritten
    planes = planes.clamp(0, 2)
    trace = ttb.pack_trace(planes, L)
    assert trace.dtype == torch.int32
    C = W // 32
    G = 16 // C
    assert tuple(trace.shape) == (8, 2 * L // G, 32)
    assert trace.numel() * 4 == 8 * trace_row_bytes(L, W)
    back = ttb.unpack_trace(trace, W)
    assert tuple(back.shape) == (2 * L, 8, W)
    assert torch.equal(back[:S], planes)
    assert int(back[S:].abs().sum()) == 0
    rng = np.random.RandomState(5)
    for _ in range(50):
        s, b, l = rng.randint(S), rng.randint(8), rng.randint(W)
        n, c = divmod(l, C)
        field = (s % G) * C + c               # s here is step - 1
        word = int(trace[b, s // G, n]) & 0xffffffff
        assert (word >> (2 * field)) & 3 == int(planes[s, b, l])
    # the walk over the round-tripped planes is the walk over the planes
    mv, bases = ttb.walk_back(args[0], ends, back[:S], W)
    ref_mv, ref_bases = ttb.walk_back(args[0], ends, planes, W)
    assert torch.equal(mv, ref_mv) and torch.equal(bases, ref_bases)


@pytest.mark.parametrize("W,L", [(96, 251), (512, 320), (1024, 520)])
def test_block_trace_roundtrip(W, L, monkeypatch):
    """The block route's layout: band_sweep's planes -> words of C =
    trace_cells(W) cells over ceil(2L/G) groups (2L need not be a multiple
    of G = 16/C: at W 96, C 4, L 251) -> planes again, on full-length,
    short and edge rows, in chunks of about 50 steps.  Word x of group
    (s-1)//G holds the move of cell x*C + c at step s in field
    ((s-1) % G)*C + c."""
    monkeypatch.setattr(ttb, "TRACE_CHUNK", 50)
    q, qlen, t, tlen = _pairs(8, L, err=0.15, seed=13)
    _edge_rows(q, qlen, t, tlen, seed=14)
    qlen[5], tlen[5] = min(qlen[5], 40), min(tlen[5], 37)   # a short row
    q[5, qlen[5]:] = 4
    t[5, tlen[5]:] = 5
    args = [torch.from_numpy(a) for a in (q, qlen, t, tlen)]
    ends, planes = band_sweep(*args, W, 3, keep_moves=True)
    planes = planes.clamp(0, 2)
    S = planes.shape[0]
    C = trace_cells(W)
    G = 16 // C
    assert kernel_for(W) == "block" and W % (4 * C) == 0
    trace = ttb.pack_trace(planes, L, C)
    assert tuple(trace.shape) == trace_shape(8, L, W) == \
        (8, -(-2 * L // G), W // C)
    back = ttb.unpack_trace(trace, W, C)
    assert torch.equal(back[:S], planes)
    assert int(back[S:].abs().sum()) == 0
    rng = np.random.RandomState(15)
    for _ in range(50):
        s, b, l = rng.randint(S), rng.randint(8), rng.randint(W)
        word = int(trace[b, s // G, l // C]) & 0xffffffff
        assert (word >> (2 * ((s % G) * C + l % C))) & 3 == \
            int(planes[s, b, l])
    mv, bases = ttb.walk_back(args[0], ends, back[:S], W)
    ref_mv, ref_bases = ttb.walk_back(args[0], ends, planes, W)
    assert torch.equal(mv, ref_mv) and torch.equal(bases, ref_bases)


def _noisy_pairs(B, L, seed):
    """Read-vs-read pairs as chip_smoke.make_pairs makes them (t random,
    q = t at 8-15% error, equal substitutions, insertions and deletions,
    lengths in [L/2, L]), as numpy arrays."""
    rng = np.random.default_rng(seed)
    q = np.full((B, L), 4, np.int8)
    t = np.full((B, L), 5, np.int8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        n = int(rng.integers(L // 2, L + 1))
        tt = rng.integers(0, 4, n, dtype=np.int8)
        e = rng.uniform(0.08, 0.15) / 3
        r = rng.random(n)
        qq = tt.copy()
        sub = r < e
        qq[sub] = (qq[sub] + rng.integers(1, 4, int(sub.sum()))) % 4
        ins = np.nonzero((r >= e) & (r < 2 * e))[0]
        qq = np.insert(qq, ins, rng.integers(0, 4, len(ins), dtype=np.int8))
        qq = qq[rng.random(len(qq)) >= e][:L]
        q[b, :len(qq)] = qq
        t[b, :n] = tt
        ql[b], tl[b] = len(qq), n
    return q, ql, t, tl


WALK_WINDOW = 32    # K3: anti-diagonals a window (csrc FTT_TB_WIN)
WALK_REACH = 64     # K3, block route: lanes staged each side (FTT_TB_REACH)


def walk_stage(n, l_ref, L, W):
    """A model of what K3's block route (csrc/align_tb.cu
    ftt_tb_bwd_block_kernel, `stage`) copies into shared memory for window
    n (anti-diagonals 2L - 32n - 31 .. 2L - 32n) when the walk stands on
    band lane l_ref: (trace groups, words of each group), as ranges; the
    kernel skips the ones outside the row's trace."""
    C = trace_cells(W)
    G = 16 // C
    g0 = (2 * L - WALK_WINDOW * (n + 1)) // G
    x0 = max((l_ref - WALK_REACH) // C, 0) & ~3
    span = 4 * (2 * WALK_REACH // (4 * C) + 1)
    return range(g0, g0 + WALK_WINDOW // G + 1), range(x0, x0 + span)


@pytest.mark.parametrize("W,L", [(96, 512), (512, 1024), (1024, 1024)])
def test_block_walk_reads_only_what_it_stages(W, L):
    """The invariant K3's block route rests on: walking window n, every
    in-band cell the walk reads lies in what walk_stage copied for window n
    (the groups of its steps, and the words of the lanes within
    WALK_REACH of the walk's lane when the copy was issued: at the start,
    for the first window; at the start of window n-1, for the others).
    On band_sweep + walk_back paths at 8-15% error, the edge rows (one
    drifts off the band) among them."""
    B = 12
    q, ql, t, tl = _noisy_pairs(B, L, seed=W)
    _edge_rows(q, ql, t, tl, seed=W + 1)
    args = [torch.from_numpy(a) for a in (q, ql, t, tl)]
    ends, planes = band_sweep(*args, W, 3, keep_moves=True)
    moves, _ = ttb.walk_back(args[0], ends, planes.clamp(0, 2), W)
    moves = moves.numpy()
    S = 2 * L
    win = WALK_WINDOW
    C = trace_cells(W)
    G = 16 // C
    reads = drift = 0
    for b in range(B):
        i, j = int(ends[0, b]), int(ends[1, b])
        if i + j == 0:
            continue
        n = (S - i - j) // win
        staged = walk_stage(n, i - band_off(i + j, W), L, W)
        while i + j > 0:
            # the next window's copy is issued before this one is walked
            nxt = walk_stage(n + 1, i - band_off(i + j, W), L, W)
            l_start = i - band_off(i + j, W)
            while i + j > S - win * (n + 1):
                s = i + j
                m = int(moves[S - s, b])
                lane = i - band_off(s, W)
                if 0 <= lane < W:
                    assert (s - 1) // G in staged[0], (b, s)
                    assert lane // C in staged[1], (b, s, lane, staged[1])
                    reads += 1
                    drift = max(drift, abs(lane - l_start))
                i -= m in (0, 2)
                j -= m in (0, 1)
            n += 1
            staged = nxt
    assert reads > B * L // 2
    assert drift > 4          # the lanes do move within a window


@pytest.mark.parametrize("kind", ["cpu", "cuda"])
def test_batch_for_fits_the_trace_budget(kind, monkeypatch):
    """Rows x trace bytes per row stays inside moves_budget for every
    ladder length: two bits a cell for the kernels, the twin's byte a cell
    on the CPU; and the row and cell caps hold."""
    monkeypatch.setattr(tdev, "resolve_device",
                        lambda d=None: torch.device(kind, 0)
                        if kind == "cuda" else torch.device("cpu"))
    cns = tdev.DeviceCns(use_dp=False)
    assert cns.device.type == kind
    rows = {}
    for L in LADDER:
        B = rows[L] = cns._batch_for(L)
        per_row = trace_row_bytes(L, cns.W) if kind == "cuda" \
            else 2 * L * cns.W
        assert cns._trace_row_bytes(L) == per_row
        assert 1 <= B <= cns.max_rows
        assert B * per_row <= cns.moves_budget
        assert B * L <= cns.max_cells
        # the batch is as large as the three bounds allow
        assert (B + 1) * per_row > cns.moves_budget or \
            (B + 1) * L > cns.max_cells or B == cns.max_rows
    if kind == "cuda":
        # four times the rows of a byte-a-cell trace under the same budget
        assert rows[16384] == 4 * (cns.moves_budget // (2 * 16384 * cns.W))
        assert rows[1024] == 4096
    else:
        assert rows[1024] == 1024 and rows[16384] == 64


@pytest.mark.parametrize("W", [96, 192, 512])
def test_device_cns_takes_every_band_the_kernels_take(W, monkeypatch):
    """On a CUDA device DeviceCns takes a band of the kernels' block route,
    given as an argument or by FTPU_CNS_W, as it takes the warp route's and
    as the twin takes it on the CPU; it refuses, when it is built, a band
    no route takes (not a multiple of 32, or above 1024)."""
    monkeypatch.setattr(tdev, "resolve_device",
                        lambda d=None: torch.device("cuda", 0))
    assert tdev.DeviceCns(W=W, use_dp=False).W == W
    for bad in (80, 1056):
        with pytest.raises(ValueError, match="FTPU_CNS_W"):
            tdev.DeviceCns(W=bad, use_dp=False)
        monkeypatch.setenv("FTPU_CNS_W", str(bad))
        with pytest.raises(ValueError, match="FTPU_CNS_W"):
            tdev.DeviceCns(use_dp=False)
    monkeypatch.setenv("FTPU_CNS_W", str(W))
    cns = tdev.DeviceCns(use_dp=False)
    assert cns.W == W
    # the launch at the largest ladder length stays inside the trace budget
    L = LADDER[-1]
    assert cns._batch_for(L) * trace_row_bytes(L, W) <= cns.moves_budget
    monkeypatch.setattr(tdev, "resolve_device",
                        lambda d=None: torch.device("cpu"))
    assert tdev.DeviceCns(use_dp=False).W == W


def test_kernel_for_routes_every_band():
    """K2/K3's route by band: the warp route at 32, 64, 128 and 256, the
    block route at every other multiple of 32 up to 1024, a ValueError
    elsewhere; both routes' traces hold two bits a cell."""
    routes = {W: kernel_for(W) for W in range(32, 1025, 32)}
    assert sorted(W for W, r in routes.items() if r == "warp") == \
        [32, 64, 128, 256]
    assert set(routes.values()) == {"warp", "block"}
    assert routes[96] == routes[512] == routes[1024] == "block"
    for W in (0, 16, 80, 1000, 1056, 2048):
        with pytest.raises(ValueError):
            kernel_for(W)
    for W in routes:
        shape = trace_shape(5, 1024, W)
        assert shape[0] == 5
        assert 4 * int(np.prod(shape)) == 5 * trace_row_bytes(1024, W)
        C = trace_cells(W)
        assert shape == (5, 2048 * C // 16, W // C)
        # whole 16-byte pieces a group; the warp route's 32 lanes of W/32
        assert W % (4 * C) == 0 and (routes[W] == "block" or C == W // 32)
        # one warp whenever 32 lanes of at most 16 cells hold the band
        assert (32 * C >= W) == (W <= 512 and W // 32 not in (9, 11, 13, 15))
    assert trace_shape(5, 1024, 256) == (5, 1024, 32)
    assert trace_shape(5, 1024, 96) == (5, 512, 24)     # 24 lanes of C 4
    assert trace_shape(5, 1024, 512) == (5, 2048, 32)   # one warp of C 16
    assert trace_shape(5, 1024, 288) == (5, 1024, 36)   # 2 warps of C 8
    assert trace_shape(5, 1024, 992) == (5, 1024, 124)  # 4 warps of C 8
    assert trace_shape(5, 1024, 1024) == (5, 1024, 128)  # 4 warps of C 8
    assert trace_shape(5, 251, 96) == (5, 126, 24)      # ceil(502 / 4)
    assert align_tb_cuda.WARP_WIDTHS == (32, 64, 128, 256)
