"""The port's graft entry (falcon_tpu_torch.graft_entry) and its consensus
split over a mesh (parallel.mesh: sum_over_mesh, sharded_tb_align,
sharded_cns_accumulate, sharded_cns_scan) against falcon_tpu on the CPU.

The port's meshes here are tuples of CPU devices, whose shards run the
kernels' plain twins; every stage of dryrun_multichip is held against the
falcon_tpu function run unsharded on the same inputs (XLA on the CPU).
Tolerance: exact everywhere.  (i, j, d), moves and counts are integers,
and every consensus score is a multiple of 0.5 far below 2^23, so the
float32 sums are exact in both packages."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__ as jgraft
from falcon_tpu.ops import align_device as jad
from falcon_tpu.ops import align_tb as jtb
from falcon_tpu.ops import cns_dp as jdp
from falcon_tpu_torch import graft_entry as tgraft
from falcon_tpu_torch.ops import cns_dp as tdp
from falcon_tpu_torch.ops import cns_dp_cuda as k
from falcon_tpu_torch.ops.align_tb import align_tb_batch
from falcon_tpu_torch.parallel import mesh as tmesh


def test_entry_matches_jax():
    """The port's entry on the CPU (K1's twin) against falcon_tpu's
    entry jitted (XLA), on the same example batch."""
    for a, b in zip(tgraft._example_batch(), jgraft._example_batch()):
        np.testing.assert_array_equal(a, b)
    fn, args = tgraft.entry(device="cpu")
    assert all(a.device.type == "cpu" for a in args)
    got = fn(*args).numpy()
    jfn, jargs = jgraft.entry()
    ref = np.stack([np.asarray(x) for x in jax.jit(jfn)(*jargs)])
    np.testing.assert_array_equal(got, ref)
    assert got.shape == (3, 8) and (got[0] > 0).all()


def _scan_cat(scans):
    """The shards' consensus_scan outputs joined as one device's: bp
    [T, G, D*5] on its group axis, the rest on their first."""
    return tuple(torch.cat([s[i] for s in scans], 1 if i == 0 else 0)
                 for i in range(6))


@pytest.mark.parametrize("n", [1, 3, 4])
def test_dryrun_multichip_matches_jax(n):
    """Every stage of the port's dryrun over n CPU devices against the
    falcon_tpu function on the same inputs, unsharded: extend_batch_device
    (W 128) and the two sums, DeviceExtender.run_specs (W 64),
    align_tb_batch (W 64), accumulate_tags + add_self_tags, then
    consensus_scan, backtrack + compact_emit."""
    out = tgraft.dryrun_multichip(n, devices=("cpu",) * n)
    B = 2 * n
    q, qlen, t, tlen = jgraft._example_batch(B=B, L=256)
    jq, jql, jt, jtl = map(jnp.asarray, (q, qlen, t, tlen))
    # 1. K1 and the psums
    bi, bj, bd = map(np.asarray, jad.extend_batch_device(jq, jql, jt, jtl,
                                                         W=128))
    np.testing.assert_array_equal(out["extend"].numpy(), np.stack([bi, bj,
                                                                   bd]))
    kmer = np.asarray(jnp.sum(jnp.ones((B, tgraft.KMER_BINS), jnp.int32),
                              axis=0))
    np.testing.assert_array_equal(out["kmer_total"].numpy(), kmer)
    assert out["aligned_bases"].dtype == torch.int32
    assert int(out["aligned_bases"]) == int(jnp.sum(bi + bj))
    # 2. the spec path over the mesh
    flat, sp_off, sp_len = tgraft.spec_inputs(n)
    ones = np.ones(len(sp_off), np.int64)
    ref = jad.DeviceExtender(W=64, use_pallas=False).run_specs(
        flat, sp_off, sp_len, ones, sp_off, sp_len, ones)
    np.testing.assert_array_equal(out["specs"], np.asarray(ref))
    # 3. K2 + K3: falcon_tpu's four outputs; the base stream (which its
    # XLA form does not emit) against the port's unsharded twin
    ti, tj, td, mv = jtb.align_tb_batch(jq.astype(jnp.int8), jql,
                                        jt.astype(jnp.int8), jtl, W=64)
    for got, ref in zip(out["tb"], (ti, tj, td, mv)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    one = align_tb_batch(*(torch.from_numpy(a).to(torch.int8)
                           if a.ndim == 2 else torch.from_numpy(a)
                           for a in (q, qlen, t, tlen)), W=64)
    assert torch.equal(out["tb"][4], one[4])
    # 4. K4 summed over the mesh, then the seeds' own tags
    c = out["cns"]
    G, T, D = c["G"], c["T"], c["D"]
    assert G == 2 * n
    msa = jdp.accumulate_tags(jdp.alloc_msa(G, T, D), jnp.asarray(c["mvp"]),
                              jnp.asarray(c["q"]), jnp.asarray(c["bd"]),
                              jnp.asarray(c["gidx"]), jnp.asarray(c["s2"]),
                              c["max_diff"], T, D)
    msa = jdp.add_self_tags(msa, jnp.asarray(c["seeds"]),
                            jnp.asarray(c["tlens"]), T)
    got = out["msa"].numpy()
    np.testing.assert_array_equal(got[:-1], np.asarray(msa)[:-1])
    assert got[:-1].max() == 3 and got[-1] == 0   # the port drops dead tags
    # 5. K5 + K6 over the groups
    scan = jdp.consensus_scan(msa, G, T, D)
    assert len(out["scans"]) == n
    for a, b in zip(_scan_cat(out["scans"]), scan):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    emit = jdp.backtrack(*scan, np.int32(1), G, T, D)
    comp, counts = map(np.asarray, jdp.compact_emit(emit, cap=T + T // 4))
    rows, cnt = out["rows"].numpy(), out["counts"].numpy()
    np.testing.assert_array_equal(cnt, counts)
    for g in range(G):
        np.testing.assert_array_equal(rows[g, :cnt[g]], comp[g, :counts[g]])
        assert cnt[g] == T - 10


def test_dryrun_multichip_needs_its_devices():
    with pytest.raises(ValueError, match="need 3 devices"):
        tgraft.dryrun_multichip(3, devices=("cpu",) * 2)


def test_sum_over_mesh_wraps_uint16_counts_as_psum():
    """Three parts of uint16 counts near 2^16 (every lane's sum wraps in
    some lane pairs) summed over a mesh of three CPU devices equal
    falcon_tpu's psum of the same counts over three devices (jax.pmap),
    count by count modulo 2^16; adding the 32-bit words would carry into
    the neighbouring count and differ.  An int32 part sums in int32."""
    rng = np.random.default_rng(0)
    parts = rng.integers(0, 1 << 16, (3, 1024)).astype(np.uint16)
    parts[:, :8] = [[65535, 1, 40000, 7, 65535, 65535, 0, 32768]] * 3
    mesh = tmesh.make_mesh(devices=("cpu",) * 3)
    got = tmesh.sum_over_mesh(
        [torch.from_numpy(p.view(np.int16)).view(torch.uint16)
         for p in parts], mesh)
    assert got.dtype == torch.uint16 and got.device == mesh[0]
    got = got.view(torch.int16).numpy().view(np.uint16)
    ref = np.asarray(jax.pmap(lambda x: jax.lax.psum(x, "i"),
                              axis_name="i",
                              devices=jax.devices()[:3])(jnp.asarray(parts)))
    np.testing.assert_array_equal(got, ref[0])
    np.testing.assert_array_equal(got, parts.sum(0, dtype=np.uint16))
    words = parts.view(np.uint32).sum(0, dtype=np.uint32).view(np.uint16)
    assert (words != got).any()
    # the parts stay as they were
    assert (parts[:, 0] == 65535).all()
    ints = [torch.full((5,), 1 << 28, dtype=torch.int32)] * 3
    s = tmesh.sum_over_mesh(ints, mesh)
    assert s.dtype == torch.int32
    assert s.tolist() == [3 << 28] * 5


@pytest.mark.parametrize("n", [2, 3])
def test_sharded_cns_scan_odd_groups_equals_one_device(n):
    """G = 5 groups over 2 (3 + 2) and 3 (2 + 2 + 1) CPU devices, each
    group's counts its own seed's (graft_entry.cns_inputs) with random
    counts added everywhere: the rows, counts and joined scans equal the
    one-device chain's (K5 then K6 on the whole buffer), and every group
    emits its seed."""
    c = tgraft.cns_inputs(5, T=600)
    G, T, D, min_cov = c["G"], c["T"], c["D"], 1
    one = (torch.device("cpu"),)
    msa = tmesh.sharded_cns_accumulate(
        one, G, T, D, c["mvp"], c["basep"], c["bd"], c["gidx"], c["s2"],
        c["max_diff"], seeds=c["seeds"], tlens=c["tlens"])
    noise = np.random.RandomState(n).randint(0, 2, msa.numel()) * \
        (np.random.RandomState(n + 9).rand(msa.numel()) < 0.01)
    noise[-1] = 0
    m16 = msa.view(torch.int16)
    m16 += torch.from_numpy(noise.astype(np.int16))
    scan = k.consensus_scan_cuda(msa, G, T, D)
    rows, counts = k.backtrack_walk_cuda(*scan, min_cov, G, T, D)
    mesh = tmesh.make_mesh(devices=("cpu",) * n)
    got_rows, got_counts, scans = tmesh.sharded_cns_scan(mesh, msa, G, T, D,
                                                         min_cov)
    assert [s[0].shape[1] for s in scans] == \
        [hi - lo for lo, hi in tmesh.shard_bounds(G, n)]
    for a, b in zip(_scan_cat(scans), scan):
        assert torch.equal(a, b)
    assert torch.equal(got_rows, rows) and torch.equal(got_counts, counts)
    for g in range(G):
        want = "".join("ACGT"[x] for x in c["seeds"][g, 1:c["tlens"][g]])
        assert tdp.assemble_compacted(got_rows[g].numpy(),
                                      int(got_counts[g])).upper() == want


def test_sharded_chain_uneven_matches_one_device():
    """Seven alignment rows over three CPU devices (3 + 2 + 2): the
    sharded K2 + K3 equal the unsharded twin, and K4 on their streams
    summed over the mesh equals K4 on all of them into one buffer."""
    rng = np.random.RandomState(3)
    B, L, G, T, D = 7, 640, 3, 1024, 14
    q = np.full((B, L), 4, np.int8)
    t = np.full((B, L), 5, np.int8)
    ql = np.zeros(B, np.int32)
    tl = np.zeros(B, np.int32)
    for b in range(B):
        tt = rng.randint(0, 4, rng.randint(520, L))
        qq = tt.copy()
        sub = rng.rand(len(tt)) < 0.05
        qq[sub] = (qq[sub] + 1) % 4
        q[b, :len(qq)], t[b, :len(tt)] = qq, tt
        ql[b], tl[b] = len(qq), len(tt)
    mesh = tmesh.make_mesh(devices=("cpu",) * 3)
    got = tmesh.sharded_tb_align(mesh, q, ql, t, tl, W=64)
    ref = align_tb_batch(*map(torch.from_numpy, (q, ql, t, tl)), W=64)
    for a, b in zip(got, ref):
        assert torch.equal(a, b)
    gidx = (np.arange(B) % G).astype(np.int32)
    s2 = rng.randint(0, 300, B).astype(np.int32)
    msa = tmesh.sharded_cns_accumulate(mesh, G, T, D, got[3], got[4],
                                       got[2], gidx, s2, 0.3)
    one = k.accumulate_tags_planes_cuda(
        tdp.alloc_msa(G, T, D, "cpu"), ref[3], ref[4], ref[2],
        torch.from_numpy(gidx), torch.from_numpy(s2), 0.3, T, D)
    assert int(tdp.counts_i32(one).sum()) > 0
    assert torch.equal(msa.view(torch.int16), one.view(torch.int16))
