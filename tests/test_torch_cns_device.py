"""The port's run_consensus_device against falcon_tpu's host-MSA device
path (DeviceCns(use_dp=False), XLA alignment on the CPU): byte-equal
preads, on the inputs of tests/test_cns_device.py plus a few more
groups, at every size of the port's MSA pool, the pool handed in as an
argument; and the pool's sizing rule."""
import io

import numpy as np
import pytest
import torch

from falcon_tpu.cns import device as jdev
from falcon_tpu.cns import runner
from falcon_tpu_torch.cns import device as tdev
from falcon_tpu_torch.cns.device import msa_pool

from tests.test_cns_device import A, noisy


def _groups(n_short=0):
    """test_device_consensus_quality_vs_host's group, two more with
    ranged and partial supports, one the gates drop, and n_short short
    ones (12 put more groups in a chunk of 40 tasks than 7 workers)."""
    out = []
    shapes = ((4000, 14, 0.12, 5), (2500, 8, 0.10, 6), (1800, 6, 0.15, 7),
              (900, 2, 0.10, 8)) + tuple(
        (900 + 150 * (k % 5), 4, 0.10, 20 + k) for k in range(n_short))
    for gi, (n, nsup, err, seed) in enumerate(shapes):
        rng = np.random.RandomState(seed)
        truth = rng.randint(0, 4, n).astype(np.uint8)
        seed_seq = A[truth].tobytes().decode()
        sid = "%09d" % (100 * gi)
        items = [(sid, seed_seq, None)]
        for k in range(nsup):
            if gi == 1 and k % 2:
                # support covering the seed's second half only
                part = truth[n // 2:]
                sup = A[noisy(part, err, rng)].tobytes().decode()
                rng_ = (0, len(sup), n // 2, n)
            else:
                sup = A[noisy(truth, err, rng)].tobytes().decode()
                rng_ = (0, len(sup), 0, n)
            items.append(("%09d" % (100 * gi + k + 1), sup, rng_))
        out.append((sid, items))
    return out


CHUNK_TASKS = 40


def _cfg(n_core=None):
    return runner.ConsensusConfig(min_cov=2, min_idt=0.70, min_n_read=4,
                                  min_cov_aln=4, output_multi=False,
                                  n_core=n_core)


@pytest.fixture(scope="module")
def jax_preads():
    """falcon_tpu's host-MSA device path: (count, preads, progress
    marks)."""
    out, marks = io.StringIO(), []
    n = jdev.run_consensus_device(
        iter(_groups(12)), _cfg(), out,
        dev=jdev.DeviceCns(use_dp=False, use_pallas=False,
                           chunk_tasks=CHUNK_TASKS),
        progress_cb=marks.append)
    return n, out.getvalue(), marks


@pytest.mark.parametrize("n_core", [None, 0, 1, 7])
def test_run_consensus_device_matches_jax(jax_preads, n_core):
    """The same preads and progress marks whatever runs the MSA: the
    sizing rule's default (None), the finisher itself (0), or a pool of
    1 or 7 threads fed longest group first."""
    n_ref, ref_out, ref_marks = jax_preads
    got_out, got_marks = io.StringIO(), []
    n_got = tdev.run_consensus_device(
        iter(_groups(12)), _cfg(n_core), got_out,
        dev=tdev.DeviceCns(device="cpu", chunk_tasks=CHUNK_TASKS),
        progress_cb=got_marks.append)
    assert n_ref == 15
    assert max(np.diff([0] + ref_marks)) > 7     # a chunk over 7 groups
    assert n_got == n_ref
    assert got_out.getvalue() == ref_out
    assert got_marks == ref_marks


def test_the_pool_is_an_argument(jax_preads, monkeypatch):
    """finish_chunk on the calling thread (no pool: msa_pool(0) gives None)
    and on a pool of 3 appended to its state gives falcon_tpu's consensus
    of one chunk, also when consensus_chunk calls it with the state alone
    (as the benchmark's hooks replace it); and a
    run_consensus_device call on a pool of 3 changes no attribute of its
    DeviceCns but dp_batches, neither while it runs (read at every
    progress mark, on the finisher, the pool open) nor after."""
    cfg = _cfg()
    chunk = [(sid, *g) for sid, items in _groups()
             if (g := tdev.gate_group_ranged(sid, items, cfg)) is not None]
    ref = jdev.DeviceCns(use_dp=False, use_pallas=False).consensus_chunk(
        chunk, cfg)
    assert len(ref) == 3 and all(cns for _, cns in ref)
    dev = tdev.DeviceCns(device="cpu")
    with msa_pool(0) as pool:
        assert pool is None
    assert dev.finish_chunk(dev.dispatch_chunk(chunk, cfg)) == ref
    with msa_pool(3) as pool:
        assert pool.workers == 3
        assert dev.finish_chunk(dev.dispatch_chunk(chunk, cfg) + (pool,)) \
            == ref
    # the host-MSA path calls finish_chunk(state) with the state alone, as
    # a hook that replaces it by name may take it
    calls = []
    orig = tdev.DeviceCns.finish_chunk

    def finish(self, state):
        calls.append(state[-1].workers)
        return orig(self, state)

    monkeypatch.setattr(tdev.DeviceCns, "finish_chunk", finish)
    assert dev.consensus_chunk(chunk, _cfg(3)) == ref and calls == [3]
    monkeypatch.undo()

    def state():
        return {k: v for k, v in vars(dev).items() if k != "dp_batches"}

    dev = tdev.DeviceCns(device="cpu", chunk_tasks=CHUNK_TASKS)
    before, seen, out = state(), [], io.StringIO()
    tdev.run_consensus_device(iter(_groups(12)), _cfg(3), out, dev=dev,
                              progress_cb=lambda k: seen.append(state()))
    assert out.getvalue() == jax_preads[1]
    assert len(seen) == len(jax_preads[2]) > 1
    assert all(s == before for s in seen) and state() == before


@pytest.mark.parametrize("n_core, nproc, cores, procs, want", [
    (5, 3, 8, None, 5),       # --n-core wins
    (0, 3, 8, None, 0),       # --n-core 0: the finisher runs the MSA
    (None, 3, 8, None, 3),    # then the job's cns nproc
    (None, 0, 8, None, 7),    # then the affinity mask less the main thread
    (None, None, 32, "4", 7),  # shared among the run's processes
    (None, None, 8, "1", 7),
    (None, None, 4, "2", 2),   # never under 2
    (None, None, 1, None, 2),
])
def test_msa_workers(monkeypatch, n_core, nproc, cores, procs, want):
    monkeypatch.setattr(tdev.os, "sched_getaffinity",
                        lambda pid: set(range(cores)), raising=False)
    if procs is None:
        monkeypatch.delenv("FTPU_NUM_PROCESSES", raising=False)
    else:
        monkeypatch.setenv("FTPU_NUM_PROCESSES", procs)
    assert tdev.msa_workers(_cfg(n_core), nproc) == want


def test_align_tasks_match_jax():
    """Per-task (dist, n_cols, q_aln, t_aln) of one chunk."""
    rng = np.random.RandomState(3)
    tasks = []
    for n in (300, 700, 1500, 2100):
        t = rng.randint(0, 4, n).astype(np.uint8)
        tasks.append((noisy(t, 0.12, rng), t))
    ref = jdev.DeviceCns(use_dp=False, use_pallas=False).align_tasks(tasks)
    got = tdev.DeviceCns(device="cpu").align_tasks(tasks)
    assert got == ref


@pytest.fixture(scope="module")
def rebuild_case():
    """Short tasks in two ladder buckets, dispatched on the CPU twin with
    13 rows a batch: batches of 13 and 1 rows at L 1024 and of 5 at L
    2048.  Returns (tasks, device, in-flight batches, the no-pool
    result, falcon_tpu's result, the planes the no-pool collect handed
    the native walk)."""
    rng = np.random.RandomState(5)
    tasks = []
    for n in [300 + 50 * k for k in range(14)] + [1300 + 150 * k
                                                  for k in range(5)]:
        t = rng.randint(0, 4, n).astype(np.uint8)
        tasks.append((noisy(t, 0.12, rng), t))
    dev = tdev.DeviceCns(device="cpu")
    dev.max_rows = 13
    inflight = dev.dispatch_tasks(tasks)
    assert sorted(len(chunk) for chunk, _ in inflight) == [1, 5, 13]
    with pytest.MonkeyPatch.context() as mp:
        planes = _record_planes(mp)
        serial = dev.collect_tasks(tasks, inflight)
    ref = jdev.DeviceCns(use_dp=False, use_pallas=False).align_tasks(tasks)
    return tasks, dev, inflight, serial, ref, planes


def _record_planes(mp):
    """Wrap the rebuild's walk (cns.device.walk_lanes) to note the shape
    of every plane it gets and whether it is C-contiguous."""
    seen = []
    walk = tdev.walk_lanes

    def recorded(plane, *args):
        seen.append((plane.shape, plane.flags.c_contiguous))
        return walk(plane, *args)

    mp.setattr(tdev, "walk_lanes", recorded)
    return seen


# a batch's plane as the walk should get it: [rows, P], P = 2L / 4 bytes
LANE_MAJOR = {(13, 512), (1, 512), (5, 1024)}


@pytest.mark.parametrize("workers", [1, 3, 7, 32])
def test_collect_tasks_on_a_pool_matches_serial(monkeypatch, rebuild_case,
                                                workers):
    """The rebuild cut into min(workers, rows) slices a batch on a pool
    (32: more threads than rows, a slice a task, under a short switch
    interval) gives the no-pool result, element for element, and
    falcon_tpu's; every plane reaches the walk lane-major and contiguous,
    as the copy back made it (no host transpose)."""
    import sys
    tasks, dev, inflight, serial, ref, planes = rebuild_case
    assert tdev.native.available()
    assert sorted(planes) == sorted((sh, True) for sh in LANE_MAJOR)
    assert serial == ref
    seen = _record_planes(monkeypatch)
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        with msa_pool(workers) as pool:
            got = dev.collect_tasks(tasks, inflight, pool)
    finally:
        sys.setswitchinterval(interval)
    assert len(seen) == sum(min(workers, len(c)) for c, _ in inflight)
    assert {sh for sh, _ in seen} == LANE_MAJOR and all(c for _, c in seen)
    assert got == serial == ref


@pytest.mark.parametrize("lens,pad", [
    ([(700, 650)], 0),                            # a batch of one row
    ([(700, 650)], 5),                            # and rows past it
    ([(1024, 1024), (1024, 3), (0, 1024)], 0),    # the rung's full length
    ([(1024, 1024)] * 4, 2),
    ([(10 + 97 * k, 1024 - 61 * k) for k in range(11)], 0),   # ragged
])
def test_trimmed_pack_gathers_the_padded_planes(lens, pad):
    """pack_tasks' buffer of the used bytes and one, with gather_pad2's
    scalar fills, gives the [B, L] q and t planes that falcon_tpu gathers
    from its 2*B*L + 1-byte buffer with fill tensors (L 1024), and the same
    offsets and lengths; at its offsets the walk reads each task's own
    codes."""
    from falcon_tpu.ops import align_device as jad
    from falcon_tpu_torch.ops.align_device import gather_pad2, pack_tasks
    import jax.numpy as jnp
    rng = np.random.RandomState(len(lens) + pad)
    tasks = [(rng.randint(0, 5, q).astype(np.uint8),
              rng.randint(0, 5, t).astype(np.uint8)) for q, t in lens]
    idxs = list(range(len(tasks)))[::-1]
    B, L = len(tasks) + pad, 1024
    ref = jad._pack_tasks(tasks, idxs, B, L)
    cat, meta = pack_tasks(tasks, idxs, B)
    assert len(ref[0]) == 2 * B * L + 1
    assert cat.numel() == sum(q + t for q, t in lens) + 1
    for g, r in zip(meta.numpy(), ref[1:]):
        np.testing.assert_array_equal(g, r)
    rq, rt = jad._gather_pad2(*[jnp.asarray(a) for a in ref], L=L,
                              fill_q=4, fill_t=5)
    gq, gt = gather_pad2(cat, *meta, L, 4, 5)
    assert gq.dtype == gt.dtype == torch.int8
    np.testing.assert_array_equal(gq.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(gt.numpy(), np.asarray(rt))
    codes = cat.numpy().view(np.uint8)
    qo, ql, to, tl = meta.numpy()
    for k, i in enumerate(idxs):
        np.testing.assert_array_equal(codes[qo[k]:qo[k] + ql[k]], tasks[i][0])
        np.testing.assert_array_equal(codes[to[k]:to[k] + tl[k]], tasks[i][1])


def test_walk_lanes_matches_moves_to_alns():
    """walk_lanes on a lane-major plane and the batch's host pack equals
    the copied binding's moves_to_alns on the same plane [P, B] and the
    tasks' own codes, slice by slice (random move codes, whole inactive
    bytes among them; codes 0-4 of uneven lengths); a slice past the
    batch is refused."""
    from falcon_tpu_torch.ops.align_device import pack_tasks
    rng = np.random.RandomState(9)
    B, P = 12, 300
    plane = rng.randint(0, 256, (B, P)).astype(np.uint8)
    plane[:, :40] = 0xFF
    tasks = [(rng.randint(0, 5, 4 * P + k).astype(np.uint8),
              rng.randint(0, 5, 4 * P + 3 * k).astype(np.uint8))
             for k in range(B)]
    host = pack_tasks(tasks, list(range(B)), B)
    for lo, hi in [(0, 3), (3, 12), (5, 6), (0, 12), (11, 12)]:
        want = tdev.native.moves_to_alns(
            plane.T, np.arange(lo, hi, dtype=np.int32),
            [q for q, _ in tasks[lo:hi]], [t for _, t in tasks[lo:hi]])
        assert tdev.walk_lanes(plane, host, lo, hi) == want
    with pytest.raises(ValueError):
        tdev.walk_lanes(plane, host, 5, 13)
