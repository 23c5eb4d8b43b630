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
from falcon_tpu_torch.ops.align_device import DeviceExtender, band_sweep
from falcon_tpu_torch.ops import align_tb_cuda
from falcon_tpu_torch.ops.align_tb_cuda import (align_tb_batch_cuda,
                                                kernel_for, trace_row_bytes,
                                                trace_shape)

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
    for L in DeviceExtender.LADDER:
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
    L = DeviceExtender.LADDER[-1]
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
    assert trace_shape(5, 1024, 256) == (5, 1024, 32)
    assert trace_shape(5, 1024, 96) == (5, 2048, 6)
    assert align_tb_cuda.WARP_WIDTHS == (32, 64, 128, 256)
