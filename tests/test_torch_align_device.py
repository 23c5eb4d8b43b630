"""falcon_tpu_torch.ops.align_device (plain extension twin, gathers,
packers, DeviceExtender) against falcon_tpu on the CPU.

Every output is an integer, so every comparison is exact.  JAX runs as its
own tests run it: the XLA scan, and the Pallas kernel in interpret mode.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from falcon_tpu.ops import align_device as jad
from falcon_tpu.ops.align_pallas import extend_batch_pallas
from falcon_tpu_torch.ops import align_device as tad
from falcon_tpu_torch.ops.align_cuda import extend_batch_cuda


def _pairs(B, L, err, seed):
    """tests/test_align_pallas_interpret.py::_pairs."""
    rng = np.random.RandomState(seed)
    q = np.full((B, L), 4, np.int8)
    t = np.full((B, L), 5, np.int8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b in range(B):
        n = rng.randint(L // 3, int(L * 0.95))
        tt = rng.randint(0, 4, n).astype(np.int8)
        keep = rng.rand(n) >= err / 2
        qq = tt[keep].copy()
        sub = rng.rand(len(qq)) < err / 2
        qq[sub] = (qq[sub] + rng.randint(1, 4, sub.sum())) % 4
        m = min(len(qq), L)
        q[b, :m] = qq[:m]
        t[b, :n] = tt
        qlen[b] = m
        tlen[b] = n
    return q, qlen, t, tlen


def _edge_rows(q, qlen, t, tlen, seed):
    """Both-empty, one-side-empty and drifting rows in place of rows 0-4."""
    rng = np.random.RandomState(seed)
    L = q.shape[1]
    for b in (0, 1, 2):
        q[b] = 4
        t[b] = 5
    qlen[0] = tlen[0] = 0                       # both empty
    qlen[1], tlen[1] = 0, L // 2                # empty q: (0, 1, 1)
    t[1, :L // 2] = rng.randint(0, 4, L // 2)
    qlen[2], tlen[2] = L // 2, 0                # empty t: (1, 0, 1)
    q[2, :L // 2] = rng.randint(0, 4, L // 2)
    # row 3: q gains a long insertion, so the path drifts off the band
    base = rng.randint(0, 4, L // 2).astype(np.int8)
    ins = rng.randint(0, 4, L // 4).astype(np.int8)
    qq = np.concatenate([base[:L // 8], ins, base[L // 8:]])[:L]
    q[3] = 4
    q[3, :len(qq)] = qq
    qlen[3] = len(qq)
    t[3] = 5
    t[3, :len(base)] = base
    tlen[3] = len(base)
    # row 4: full-length identical pair
    q[4] = t[4] = rng.randint(0, 4, L)
    qlen[4] = tlen[4] = L


def _jax_ref(q, qlen, t, tlen, W):
    ref = jad.extend_batch_device(
        jnp.asarray(q.astype(np.int32)), jnp.asarray(qlen),
        jnp.asarray(t.astype(np.int32)), jnp.asarray(tlen), W=W)
    pal = extend_batch_pallas(jnp.asarray(q), jnp.asarray(qlen),
                              jnp.asarray(t), jnp.asarray(tlen), W=W,
                              block_b=q.shape[0], interpret=True)
    return (np.stack([np.asarray(a) for a in ref]),
            np.stack([np.asarray(a) for a in pal]))


def _port(q, qlen, t, tlen, W):
    return extend_batch_cuda(torch.from_numpy(q), torch.from_numpy(qlen),
                             torch.from_numpy(t), torch.from_numpy(tlen),
                             W=W).numpy()


@pytest.mark.parametrize("W,L", [(64, 128), (64, 256), (64, 512)])
def test_extend_batch_matches_jax(W, L):
    q, qlen, t, tlen = _pairs(8, L, err=0.15, seed=3)
    xla, pal = _jax_ref(q, qlen, t, tlen, W)
    got = _port(q, qlen, t, tlen, W)
    np.testing.assert_array_equal(got, xla)
    np.testing.assert_array_equal(got, pal)


def test_extend_batch_edge_rows():
    W, L = 64, 256
    q, qlen, t, tlen = _pairs(8, L, err=0.1, seed=5)
    _edge_rows(q, qlen, t, tlen, seed=6)
    xla, pal = _jax_ref(q, qlen, t, tlen, W)
    got = _port(q, qlen, t, tlen, W)
    np.testing.assert_array_equal(got, xla)
    assert tuple(got[:, 0]) == (0, 0, 0)
    assert tuple(got[:, 1]) == (0, 1, 1)
    assert tuple(got[:, 2]) == (1, 0, 1)
    assert tuple(got[:, 4]) == (L, L, 0)
    # The Pallas kernel scores no cell of a one-side-empty row: its tile
    # guard counts a zero length as L, so the i == 0 / j == 0 boundary
    # cells are never tracked.  The port follows extend_batch_device.
    one_side = [1, 2]
    np.testing.assert_array_equal(pal[:, one_side], 0)
    np.testing.assert_array_equal(np.delete(got, one_side, axis=1),
                                  np.delete(pal, one_side, axis=1))


def test_extend_batch_edge_rows_w512():
    """The same rows at the widest band of K1's warp kernel, against
    extend_batch_device (the Pallas kernel in interpret mode takes half a
    minute at this band, and the case above holds its one-side-empty
    quirk)."""
    W, L = 512, 1024
    q, qlen, t, tlen = _pairs(8, L, err=0.1, seed=5)
    _edge_rows(q, qlen, t, tlen, seed=6)
    xla = np.stack([np.asarray(a) for a in jad.extend_batch_device(
        jnp.asarray(q.astype(np.int32)), jnp.asarray(qlen),
        jnp.asarray(t.astype(np.int32)), jnp.asarray(tlen), W=W)])
    got = _port(q, qlen, t, tlen, W)
    np.testing.assert_array_equal(got, xla)
    assert tuple(got[:, 0]) == (0, 0, 0)
    assert tuple(got[:, 1]) == (0, 1, 1)
    assert tuple(got[:, 2]) == (1, 0, 1)
    assert tuple(got[:, 4]) == (L, L, 0)


@pytest.mark.parametrize("W,L", [(96, 256), (160, 320), (544, 1024),
                                 (1024, 1024)])
def test_extend_batch_edge_rows_other_bands(W, L):
    """The edge rows at W 96 and 160 (3 and 5 cells a lane, K1's warp
    form) and 544 and 1024 (17 and 32, its wide form), against
    extend_batch_device."""
    q, qlen, t, tlen = _pairs(8, L, err=0.12, seed=W)
    _edge_rows(q, qlen, t, tlen, seed=W + 1)
    xla = np.stack([np.asarray(a) for a in jad.extend_batch_device(
        jnp.asarray(q.astype(np.int32)), jnp.asarray(qlen),
        jnp.asarray(t.astype(np.int32)), jnp.asarray(tlen), W=W)])
    got = _port(q, qlen, t, tlen, W)
    np.testing.assert_array_equal(got, xla)
    assert tuple(got[:, 0]) == (0, 0, 0)
    assert tuple(got[:, 1]) == (0, 1, 1)
    assert tuple(got[:, 2]) == (1, 0, 1)
    assert tuple(got[:, 4]) == (L, L, 0)


def test_kernel_for_covers_every_band():
    """Every band the wrapper admits has exactly one form, chosen by W
    alone: the warp form at every W up to 512, the wide form beyond;
    anything else is refused on the CPU as on the card."""
    from falcon_tpu_torch.ops import align_cuda
    got = {W: align_cuda.kernel_for(W) for W in range(32, 1025, 32)}
    assert sorted(W for W, k in got.items() if k == "warp") == \
        list(range(32, 513, 32))
    assert sorted(W for W, k in got.items() if k == "wide") == \
        list(range(544, 1025, 32))
    assert len(got) == 32
    for W in (0, 16, 48, 1056, -32):
        with pytest.raises(ValueError):
            align_cuda.kernel_for(W)
    q, qlen, t, tlen = [torch.from_numpy(a) for a in
                        _pairs(2, 128, err=0.1, seed=1)]
    for W in (48, 1056):
        with pytest.raises(ValueError):
            align_cuda.extend_batch_cuda(q, qlen, t, tlen, W=W)


def _specs(rng, nflat, n, L):
    off = rng.randint(-40, nflat + 40, n)
    ln = rng.randint(0, L + 1, n)
    dr = rng.choice([-1, 1], n)
    return off.astype(np.int32), ln.astype(np.int32), dr.astype(np.int32)


def test_gather_specs2_packed_matches_jax():
    rng = np.random.RandomState(2)
    flat = rng.randint(0, 5, 3000).astype(np.uint8)   # code 4 packs as 3
    L = 256
    specs = _specs(rng, len(flat), 40, L) + _specs(rng, len(flat), 40, L)
    specs[0][:4] = [-7, 5, 0, 2999]                   # negative / edge
    specs[2][:4] = [1, -1, -1, 1]
    words = jad.pack_flat_2bit(flat)
    np.testing.assert_array_equal(tad.pack_flat_2bit(flat), words)
    ref = jad._gather_specs2_packed_ref(
        jnp.asarray(words), *[jnp.asarray(s) for s in specs], L=L,
        fill_q=4, fill_t=5)
    got = tad.gather_specs2_packed(
        torch.from_numpy(words.astype(np.int64)),
        *[torch.from_numpy(s) for s in specs], L=L, fill_q=4, fill_t=5)
    for g, r in zip(got, ref):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))


def test_pack_tasks_and_gather_pad2_match_jax():
    """The port's buffer is falcon_tpu's up to its used bytes and the one
    zero byte after them (falcon_tpu's is zero from there to 2*B*L + 1);
    the offsets, the lengths and the gathered planes are falcon_tpu's."""
    rng = np.random.RandomState(4)
    tasks = [(rng.randint(0, 5, rng.randint(0, 200)).astype(np.uint8),
              rng.randint(0, 5, rng.randint(0, 200)).astype(np.uint8))
             for _ in range(12)]
    idxs = list(range(0, 12, 2))
    B, L = 8, 256
    ref = jad._pack_tasks(tasks, idxs, B, L)
    cat, meta = tad.pack_tasks(tasks, idxs, B)
    n = sum(len(q) + len(t) for q, t in (tasks[i] for i in idxs))
    assert cat.dtype == torch.int8 and cat.shape == (n + 1,)
    assert meta.dtype == torch.int32 and meta.shape == (4, B)
    np.testing.assert_array_equal(cat.numpy(), ref[0][:n + 1])
    assert not ref[0][n:].any()
    for g, r in zip(meta.numpy(), ref[1:]):
        np.testing.assert_array_equal(g, r)
    rq, rt = jad._gather_pad2(*[jnp.asarray(a) for a in ref], L=L,
                              fill_q=4, fill_t=5)
    gq, gt = tad.gather_pad2(cat, *meta, L, 4, 5)
    np.testing.assert_array_equal(gq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))


def _spec_tasks(seed, n=24):
    """Forward/backward extension specs over one flat array, the shape
    make_device_aligner builds: (offset, len, dir) pairs from anchors."""
    rng = np.random.RandomState(seed)
    reads = []
    genome = rng.randint(0, 4, 6000).astype(np.uint8)
    for _ in range(2 * n):
        s = rng.randint(0, 3000)
        r = genome[s:s + rng.randint(800, 3000)].copy()
        sub = rng.rand(len(r)) < 0.08
        r[sub] = (r[sub] + rng.randint(1, 4, sub.sum())) % 4
        reads.append((s, r))
    offs = np.cumsum([0] + [len(r) for _, r in reads])
    flat = np.concatenate([r for _, r in reads])
    q_off, q_len, q_dir, t_off, t_len, t_dir = ([] for _ in range(6))
    for k in range(n):
        (sa, a), (sb, b) = reads[2 * k], reads[2 * k + 1]
        qa = rng.randint(0, len(a))
        ta = int(np.clip(qa + sa - sb, 0, len(b) - 1))
        for fwd in (True, False):
            q_off.append(offs[2 * k] + (qa if fwd else qa - 1))
            q_len.append(len(a) - qa if fwd else qa)
            q_dir.append(1 if fwd else -1)
            t_off.append(offs[2 * k + 1] + (ta if fwd else ta - 1))
            t_len.append(len(b) - ta if fwd else ta)
            t_dir.append(1 if fwd else -1)
    return flat, [np.asarray(x, np.int64) for x in
                  (q_off, q_len, q_dir, t_off, t_len, t_dir)]


def _band_cells_brute(qlen, tlen, W):
    """Lanes of the sweep's steps s = 1 .. qlen + tlen that hold a DP
    cell: band_sweep's valid-lane mask, counted step by step."""
    s = np.arange(1, qlen + tlen + 1)
    o = np.maximum(0, s // 2 - W // 2)
    hi = np.minimum(np.minimum(qlen, s) - o, W - 1)
    lo = np.maximum(s - tlen - o, 0)
    return int(np.maximum(hi - lo + 1, 0).sum())


@pytest.mark.parametrize("W", [32, 64, 256])
def test_band_cells_matches_lane_sweep(W):
    rng = np.random.RandomState(W)
    ql = np.r_[np.arange(W + 4), rng.randint(0, 12 * W, 300)]
    tl = np.r_[np.arange(W + 4)[::-1], rng.randint(0, 12 * W, 300)]
    ql[:5], tl[:5] = [0, 0, 7, W - 1, W - 2], [0, 9, 0, 0, 3 * W]
    want = [_band_cells_brute(a, b, W) for a, b in zip(ql, tl)]
    np.testing.assert_array_equal(tad.band_cells(ql, tl, W), want)


@pytest.mark.parametrize("cap", [None, "1"])
def test_device_extender_run_specs_matches_jax(monkeypatch, cap):
    """run_specs vs falcon_tpu's XLA DeviceExtender; cap "1" forces a
    drain after every batch (FTPU_INFLIGHT_BATCHES is read per
    extender here, at import in falcon_tpu)."""
    if cap:
        monkeypatch.setenv("FTPU_INFLIGHT_BATCHES", cap)
    flat, specs = _spec_tasks(7)
    W = 64
    ref = jad.DeviceExtender(W=W, use_pallas=False).run_specs(flat, *specs)
    ext = tad.DeviceExtender(W=W, device="cpu", max_batch=1)
    got = ext.run_specs(flat, *specs)
    np.testing.assert_array_equal(got, np.asarray(ref, np.int64))
    side = np.minimum(specs[1], specs[4]) + W // 2 + 8
    ql, tl = np.minimum(specs[1], side), np.minimum(specs[4], side)
    useful = sum(_band_cells_brute(a, b, W) for a, b in zip(ql, tl))
    assert ext.occupancy() == useful / (W * int((ql + tl).sum()))
    assert 0 < ext.occupancy() < 1
    if cap:
        assert ext.inflight_cap == 1


def test_wrapper_rejects_bad_inputs():
    q = torch.zeros((2, 64), dtype=torch.int8)
    n = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(ValueError):
        extend_batch_cuda(q.to(torch.int32), n, q, n, W=64)
    with pytest.raises(ValueError):
        extend_batch_cuda(q, n, q, n, W=48)
    with pytest.raises(ValueError):
        extend_batch_cuda(q, n[:1], q, n, W=64)
