"""The port's device-DP consensus against falcon_tpu's, on the CPU: the plain
twins of K4, K5 and K6 (falcon_tpu_torch.ops.cns_dp, reached through their
wrappers with CPU tensors) against falcon_tpu.ops.cns_dp (XLA), then the
port's DeviceCns(use_dp=True) and run_consensus_device against falcon_tpu's
(use_pallas=False).

Tolerance: exact everywhere.  Counts are integers, and every DP score is a
multiple of 0.5 far below 2^23, so the float32 sums are exact in both
packages and the argmax ties resolve alike.  Inputs and shapes are those of
tests/test_cns_dp.py."""
import io

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from falcon_tpu.cns import device as jdev
from falcon_tpu.cns import runner
from falcon_tpu.ops import align_tb as jtb
from falcon_tpu.ops import cns_dp as jdp
from falcon_tpu_torch.cns import device as tdev
from falcon_tpu_torch.ops import cns_dp as tdp
from falcon_tpu_torch.ops import cns_dp_cuda as k
from falcon_tpu_torch.ops.align_tb_cuda import align_tb_batch_cuda

from tests.test_cns_dp import CFG, make_group, noisy
from tests.test_torch_cns_device import _groups

D = 14
NAMES = ("bp", "cov", "gb_s", "gb_t", "gb_d", "gb_b")


def _rows(err, seed, G, B, L, lead=False, dead=None, s2max=5, empty=False):
    """Support-vs-seed rows as tests/test_cns_dp.py builds them: q a noisy
    copy of t (with 5 extra leading bases on every third row when lead),
    gidx = b % G (b % (G-1) when empty: the last group gets nothing; -1 on
    the dead row), s2 in [0, s2max)."""
    rng = np.random.RandomState(seed)
    qs = np.full((B, L), 4, np.int8)
    ts = np.full((B, L), 5, np.int8)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    gidx = np.zeros(B, np.int32)
    s2 = np.zeros(B, np.int32)
    for b in range(B):
        t_arr = rng.randint(0, 4, rng.randint(600, 1000)).astype(np.uint8)
        q_arr = noisy(t_arr, err, rng) if err else t_arr.copy()
        if lead and b % 3 == 1:
            q_arr = np.concatenate(
                [rng.randint(0, 4, 5).astype(np.uint8), q_arr])
        q_arr = q_arr[:L]
        qs[b, :len(q_arr)] = q_arr
        ts[b, :len(t_arr)] = t_arr
        qlen[b] = len(q_arr)
        tlen[b] = len(t_arr)
        gidx[b] = -1 if b == dead else b % (G - 1 if empty else G)
        s2[b] = rng.randint(0, s2max)
    return qs, qlen, ts, tlen, gidx, s2


def _msas(rows, G, T, W=64, max_diff=0.5):
    """(JAX counts from the q-gather accumulate_tags on XLA moves, the
    port's counts from its twin on its own move and base streams)."""
    qs, qlen, ts, tlen, gidx, s2 = rows
    _, _, bd, mvp = jtb.align_tb_batch(jnp.asarray(qs), jnp.asarray(qlen),
                                       jnp.asarray(ts), jnp.asarray(tlen),
                                       W=W)
    ref = jdp.accumulate_tags(jdp.alloc_msa(G, T, D), mvp, jnp.asarray(qs),
                              bd, jnp.asarray(gidx), jnp.asarray(s2),
                              np.float32(max_diff), T, D)
    _, _, tbd, tmvp, tbases = align_tb_batch_cuda(
        *(torch.from_numpy(a) for a in (qs, qlen, ts, tlen)), W=W)
    got = k.accumulate_tags_planes_cuda(
        tdp.alloc_msa(G, T, D, "cpu"), tmvp, tbases, tbd,
        torch.from_numpy(gidx), torch.from_numpy(s2), max_diff, T, D)
    return ref, got


@pytest.mark.parametrize("err,seed", [(0.0, 31), (0.12, 32), (0.3, 33)])
def test_accumulate_tags_matches_jax(err, seed):
    """Counts equal as integers everywhere but the dump slot, on real move
    streams with deletions, leading insertions, keep-gate rejects and a
    dead row (test_planes_parity's inputs)."""
    G, T = 4, 1024
    ref, got = _msas(_rows(err, seed, G, 8, 1024, lead=True, dead=2, s2max=4),
                     G, T)
    ref = np.asarray(ref)[:-1]
    assert ref.sum() > 0, "degenerate case: no tags at all"
    np.testing.assert_array_equal(got.numpy()[:-1], ref)
    assert int(got[-1]) == 0          # the port drops dead tags


def test_add_self_tags_matches_jax():
    rng = np.random.RandomState(5)
    G, T = 3, 64
    seeds = rng.randint(0, 5, (G, T)).astype(np.int8)
    tlens = np.array([64, 17, 0], np.int32)
    ref = jdp.add_self_tags(jdp.alloc_msa(G, T, D), jnp.asarray(seeds),
                            jnp.asarray(tlens), T)
    got = tdp.add_self_tags(tdp.alloc_msa(G, T, D, "cpu"),
                            torch.from_numpy(seeds), torch.from_numpy(tlens),
                            T)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


def _scan_eq(ref_msa, got_msa, G, T):
    ref = jdp.consensus_scan(ref_msa, G, T, D)
    got = k.consensus_scan_cuda(got_msa, G, T, D)
    for a, b, name in zip(ref, got, NAMES):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
    return ref, got


@pytest.mark.parametrize("err,seed", [(0.0, 41), (0.12, 42), (0.3, 43)])
def test_consensus_scan_matches_jax(err, seed):
    """All six outputs equal on real move streams
    (test_consensus_scan_prefix_parity's inputs)."""
    G, T = 8, 1024
    ref, got = _msas(_rows(err, seed, G, 12, 2048), G, T)
    _scan_eq(ref, got, G, T)


def test_consensus_scan_random_counts_match_jax():
    """Adversarial random counts: empty columns, start-only links, isolated
    insertion levels with dead predecessors
    (test_consensus_scan_prefix_parity_random_msa's counts)."""
    rng = np.random.RandomState(7)
    G, T = 5, 64
    msa = np.zeros(jdp.msa_size(G, T, D), np.uint16)
    n = msa.shape[0] - 1
    hot = rng.choice(n, size=n // 7, replace=False)
    msa[hot] = rng.randint(1, 200, size=hot.shape[0]).astype(np.uint16)
    _scan_eq(jnp.asarray(msa), torch.from_numpy(msa), G, T)


@pytest.mark.parametrize("depth,G,T,seed", [(3, 4, 96, 11), (14, 3, 80, 12),
                                             (16, 3, 64, 13)])
def test_consensus_scan_adversarial_counts_match_jax(depth, G, T, seed):
    """The counts the card's K5 is held to its twin on
    (chip_smoke.adversarial_counts: dense small counts on every level, many
    equal scores, empty columns, the level in use jumping between 0 and
    D - 1), through the twin and falcon_tpu: all six outputs bit-equal, at
    the smallest, the default and the largest delta capacity."""
    from chip_smoke import adversarial_counts
    msa = adversarial_counts(np.random.default_rng(seed), G, T, depth)
    assert msa.shape == (jdp.msa_size(G, T, depth),)
    ref = jdp.consensus_scan(jnp.asarray(msa), G, T, depth)
    got = k.consensus_scan_cuda(torch.from_numpy(msa), G, T, depth)
    for a, b, name in zip(ref, got, NAMES):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a), name)
    cov = got[1].numpy()
    assert (cov == 0).any() and (cov > 0).any()


@pytest.mark.parametrize("err,seed", [(0.0, 51), (0.12, 52), (0.3, 53)])
def test_backtrack_walk_matches_jax(err, seed):
    """The walk's rows decode to falcon_tpu's backtrack + compact_emit +
    assemble_compacted strings, code for code, including an empty group
    (test_backtrack_walk_parity's inputs)."""
    G, T, min_cov = 8, 1024, 2
    ref_msa, got_msa = _msas(_rows(err, seed, G, 12, 2048, empty=True), G, T)
    ref, got = _scan_eq(ref_msa, got_msa, G, T)
    emit = jdp.backtrack(*ref, np.int32(min_cov), G, T, D)
    comp, counts = map(np.asarray, jdp.compact_emit(emit, cap=T + T // 4))
    rows, n = k.backtrack_walk_cuda(*got, min_cov, G, T, D)
    rows, n = rows.numpy(), n.numpy()
    np.testing.assert_array_equal(n, counts)
    for g in range(G):
        np.testing.assert_array_equal(rows[g, :n[g]], comp[g, :counts[g]])
        assert not rows[g, n[g]:].any()
        assert tdp.assemble_compacted(rows[g], n[g]) == \
            jdp.assemble_compacted(comp[g], int(counts[g]))
    assert (n == 0).sum() == 1         # only the deliberately empty group


def test_backtrack_walk_stops_at_2T():
    """A pred plane whose path visits every delta level of every column
    emits 2T codes and stops there (the plane backtrack's n_emit bound)."""
    G, T = 2, 32
    bp = torch.empty((T, G, D * 5), dtype=torch.uint8)
    d = torch.arange(D).repeat_interleave(5)
    b = torch.arange(5).repeat(D)
    bp[:] = torch.where(d == 0, (D - 1) * 5 + b, 128 + b).to(torch.uint8)
    bp[0, :, :5] = 254                 # t = 0, d = 0: the path's start
    cov = torch.full((G, T), 3, dtype=torch.int32)
    gb_s = torch.tensor([5.0, -1.0])
    gb = [torch.tensor(v, dtype=torch.int32) for v in
          ([T - 1, 0], [D - 1, 0], [2, 0])]
    rows, n = k.backtrack_walk_cuda(bp, cov, gb_s, *gb, 2, G, T, D)
    assert n.tolist() == [2 * T, 0]
    assert (rows[0] == 2).all() and not rows[1].any()
    # falcon_tpu: the count overflows compact_emit's cap, so its output is
    # the plane's (the overflow fallback)
    emit = jdp.backtrack(*(jnp.asarray(x.numpy()) for x in (bp, cov, gb_s,
                                                            *gb)),
                         np.int32(2), G, T, D)
    assert tdp.assemble_compacted(rows[0], n[0]) == \
        jdp.assemble_consensus(emit, 0) == "G" * (2 * T)


def test_dp_consensus_chunk_matches_jax():
    """DeviceCns.consensus_chunk on test_dp_multi_group_batching's four
    groups (seed lengths 1500, 2600, 900 and 5100: T buckets 1024 to
    8192), string for string."""
    rng = np.random.RandomState(7)
    cfg = runner.ConsensusConfig(**CFG)
    chunk = []
    for i, n in enumerate((1500, 2600, 900, 5100)):
        truth = rng.randint(0, 4, n).astype(np.uint8)
        g = jdev.gate_group_ranged(
            "%09d" % i, make_group(truth, 8, 0.08, rng, seed_id="%09d" % i),
            cfg)
        chunk.append(("%09d" % i, g[0], g[1]))
    ref = jdev.DeviceCns(use_dp=True, use_pallas=False).consensus_chunk(
        chunk, cfg)
    dev = tdev.DeviceCns(device="cpu", use_dp=True)
    got = dev.consensus_chunk(chunk, cfg)
    assert got == ref
    assert sorted(dev.dp_batches) == [1024, 2048, 4096, 8192]


def test_run_consensus_device_dp_matches_jax():
    """Byte-equal preads and equal progress marks, through two chunks."""
    cfg = runner.ConsensusConfig(output_multi=False, **CFG)
    ref_out, ref_marks = io.StringIO(), []
    n_ref = jdev.run_consensus_device(
        iter(_groups()), cfg, ref_out,
        dev=jdev.DeviceCns(use_dp=True, use_pallas=False, chunk_tasks=16),
        progress_cb=ref_marks.append)
    got_out, got_marks = io.StringIO(), []
    n_got = tdev.run_consensus_device(
        iter(_groups()), cfg, got_out,
        dev=tdev.DeviceCns(device="cpu", use_dp=True, chunk_tasks=16),
        progress_cb=got_marks.append)
    assert n_ref == 3
    assert (n_got, got_out.getvalue(), got_marks) == \
        (n_ref, ref_out.getvalue(), ref_marks)


@pytest.mark.parametrize("env,dp", [("1", True), ("0", False), (None, False)])
def test_cns_dp_env_selects_path(monkeypatch, env, dp):
    """FTPU_CNS_DP=1 selects the DP path in both packages, anything else or
    nothing the host-MSA path; the DP path's chunks default to 32768
    tasks."""
    monkeypatch.delenv("FTPU_CNS_CHUNK_TASKS", raising=False)
    if env is None:
        monkeypatch.delenv("FTPU_CNS_DP", raising=False)
    else:
        monkeypatch.setenv("FTPU_CNS_DP", env)
    ref = jdev.DeviceCns(use_pallas=False)
    got = tdev.DeviceCns(device="cpu")
    assert got.use_dp == ref.use_dp == dp
    assert got.chunk_tasks == ref.chunk_tasks == (32768 if dp else 8192)
    assert got.dp_delta_cap == ref.dp_delta_cap == D


def test_wrappers_check_inputs():
    G, T = 2, 16
    msa = tdp.alloc_msa(G, T, D, "cpu")
    with pytest.raises(ValueError, match="D must be"):
        k.consensus_scan_cuda(msa, G, T, 2)
    with pytest.raises(ValueError, match="msa must be"):
        k.consensus_scan_cuda(msa.view(torch.int16), G, T, D)
    mvp = torch.zeros((4, 3), dtype=torch.uint8)
    i32 = torch.zeros(3, dtype=torch.int32)
    with pytest.raises(ValueError, match="basep must be"):
        k.accumulate_tags_planes_cuda(msa, mvp, torch.zeros((15, 3),
                                                           dtype=torch.int8),
                                      i32, i32, i32, 0.3, T, D)
    bp, cov, gb_s, *gb = k.consensus_scan_cuda(msa, G, T, D)
    with pytest.raises(ValueError, match="cov must be contiguous"):
        k.backtrack_walk_cuda(bp, cov.T.contiguous().T, gb_s, *gb, 2, G, T,
                              D)
