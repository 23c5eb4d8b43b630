"""The port's CUDA kernels against their plain twins, on the card.

These tests need a CUDA GPU and nvcc; they skip elsewhere.  They import no
JAX, so on a machine without it run them with the repo's conftest (which
configures JAX) left out:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from chip_smoke import (adversarial_counts, dp_batch, ladder_walk,
                        make_pairs, spec_batch, swept_cells_equal, tag_rows,
                        walk_cases)
from falcon_tpu_torch import graft_entry
from falcon_tpu_torch.cns.device import DeviceCns
from falcon_tpu_torch.ops import align_cuda, align_tb_cuda, cns_dp
from falcon_tpu_torch.ops import cns_dp_cuda as dpk
from falcon_tpu_torch.ops.align_device import (DeviceExtender, band_sweep,
                                               extend_batch)
from falcon_tpu_torch.ops.align_tb import (align_tb_batch, pack_moves,
                                           pack_trace, unpack_trace,
                                           walk_back)
from falcon_tpu_torch.parallel import mesh as pm
from falcon_tpu_torch.tools import bench_accumulate, profile_cns_dp
from falcon_tpu_torch.utils import trace

pytestmark = pytest.mark.gpu


@pytest.fixture
def rng():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return np.random.default_rng(5)


# C = W/32 cells a lane: the warp form at C 1-16 (3, 5 and 15 among them),
# the wide form at C 17-32 (17, 24, 31, 32); W 96 and 1024 also at an L
# that is no multiple of 16 and with more rows than one wave of warps
@pytest.mark.parametrize("W,L,B", [(64, 512, 24), (256, 2048, 16),
                                   (32, 256, 40), (128, 1024, 70),
                                   (512, 1024, 24), (512, 4096, 12),
                                   (96, 512, 24), (1024, 2048, 8),
                                   (256, 1000, 700), (160, 1024, 24),
                                   (480, 1024, 16), (544, 1024, 16),
                                   (768, 2048, 8), (992, 1024, 8),
                                   (96, 1000, 6000), (1024, 1000, 2500)])
def test_k1_matches_twin(rng, W, L, B):
    """Both forms of K1 against the twin, the edge rows included (one side
    empty, an identical full-length pair)."""
    args = make_pairs(rng, B, L, W)
    key = "extend" if align_cuda.kernel_for(W) == "warp" else "extend_wide"
    n = align_cuda.LAUNCHES[key]
    got = align_cuda.extend_batch_cuda(*args, W=W)
    torch.cuda.synchronize()
    assert align_cuda.LAUNCHES[key] == n + 1
    assert torch.equal(got, extend_batch(*args, W=W))


@pytest.mark.parametrize("B,L", [(300, 1024), (7, 2048)])
def test_device_extender_over_two_shards_matches_one_device(rng, B, L):
    """DeviceExtender.run_specs and run over (cuda:0, cuda:0), the mesh a
    one-card machine can give, against cuda:0 alone and the CPU twin."""
    flat, sel = spec_batch(*make_pairs(rng, B, L, 256))
    exts = [DeviceExtender(W=256, device="cuda", devices=d)
            for d in (("cuda:0",), ("cuda:0", "cuda:0"), ("cpu",))]
    n = align_cuda.LAUNCHES["extend"]
    one, two, cpu = (e.run_specs(flat, *sel) for e in exts)
    assert align_cuda.LAUNCHES["extend"] > n
    np.testing.assert_array_equal(two, one)
    np.testing.assert_array_equal(one, cpu)
    tasks = [(flat[q0:q0 + qn], flat[t0:t0 + tn])
             for q0, qn, d, t0, tn, _ in sel.T if d == 1]
    one, two = (e.run(tasks) for e in exts[:2])
    np.testing.assert_array_equal(two, one)


TB_SHAPES = [(32, 256, 40), (64, 512, 24), (128, 1024, 70),
             (256, 2048, 16), (256, 1024, 130)]
# bands of the block route (align_tb_cuda.trace_cells): one warp with
# padding lanes (96: 24 lanes of 4 cells, 160 and 192: 20 and 24 of 8, 320:
# 20 of 16), one full warp of 16 (512), and segments trading edge cells
# (1024: 4 x 8; 992: 4 x 8, the last 28 lanes; 544 and 288: 3 and 2 x 8,
# the last 4 lanes); L 250 and 251 are no multiple of 16, and 251 leaves a
# last packed byte half filled; W 1024 at L 4096 crosses many ring chunks;
# a batch of one row
TB_BLOCK_SHAPES = [(96, 512, 24), (192, 1024, 20), (512, 1024, 12),
                   (1024, 2048, 8), (160, 250, 30), (160, 251, 30),
                   (992, 1024, 8), (544, 512, 12), (288, 512, 12),
                   (320, 512, 12), (1024, 4096, 6), (512, 1024, 1)]


def tb_key(kernel, W):
    """The LAUNCHES key of K2 ("tb_fwd") or K3 ("tb_bwd") on W's route."""
    return kernel if align_tb_cuda.kernel_for(W) == "warp" \
        else kernel + "_block"


@pytest.mark.parametrize("W,L,B", TB_SHAPES + TB_BLOCK_SHAPES)
def test_k2_k3_match_twin(rng, W, L, B):
    args = make_pairs(rng, B, L, W, edge=B > 5)
    got = align_tb_cuda.align_tb_batch_cuda(*args, W=W)
    torch.cuda.synchronize()
    for name, g, r in zip("i j d moves bases".split(), got,
                          align_tb_batch(*args, W=W)):
        assert torch.equal(g, r), name


@pytest.mark.parametrize("W,L,B", TB_SHAPES + TB_BLOCK_SHAPES)
def test_k2_matches_band_sweep(rng, W, L, B):
    """K2's ends, and its two-bit trace on every cell a row swept."""
    args = make_pairs(rng, B, L, W, edge=B > 5)
    n = align_tb_cuda.LAUNCHES[tb_key("tb_fwd", W)]
    ends, trace = align_tb_cuda.tb_forward_cuda(*args, W, 3)
    torch.cuda.synchronize()
    assert align_tb_cuda.LAUNCHES[tb_key("tb_fwd", W)] == n + 1
    p_ends, planes = band_sweep(*args, W, 3, keep_moves=True)
    assert torch.equal(ends, p_ends)
    got = unpack_trace(trace, W, align_tb_cuda.trace_cells(W))
    same, cells = swept_cells_equal(got, planes, args[1], args[3], W)
    assert same and cells > 0


@pytest.mark.parametrize("W,L,B", TB_SHAPES + TB_BLOCK_SHAPES)
def test_k3_matches_walk_back(rng, W, L, B):
    """K3 on the plain sweep's trace and ends, in its route's layout."""
    args = make_pairs(rng, B, L, W, edge=B > 5)
    p_ends, planes = band_sweep(*args, W, 3, keep_moves=True)
    planes = planes.clamp(0, 2)        # rows' unswept steps: never read
    n = align_tb_cuda.LAUNCHES[tb_key("tb_bwd", W)]
    moves, bases = align_tb_cuda.tb_backward_cuda(
        pack_trace(planes, L, align_tb_cuda.trace_cells(W)), p_ends,
        args[0], W)
    torch.cuda.synchronize()
    assert align_tb_cuda.LAUNCHES[tb_key("tb_bwd", W)] == n + 1
    p_moves, p_bases = walk_back(args[0], p_ends, planes, W)
    assert torch.equal(moves, pack_moves(p_moves))
    assert torch.equal(bases, p_bases)


def test_k2_k3_reject_what_they_do_not_take(rng):
    q, ql, t, tl = make_pairs(rng, 8, 256, 64)
    with pytest.raises(ValueError):           # a band no route takes
        align_tb_cuda.align_tb_batch_cuda(q, ql, t, tl, W=80)
    with pytest.raises(ValueError):           # warp route: L % 16 != 0
        align_tb_cuda.align_tb_batch_cuda(
            q[:, :250].contiguous(), ql.clamp_max(250),
            t[:, :250].contiguous(), tl.clamp_max(250), W=64)
    ends, trace = align_tb_cuda.tb_forward_cuda(q, ql, t, tl, 64, 3)
    with pytest.raises(ValueError):           # q on the CPU beside the trace
        align_tb_cuda.tb_backward_cuda(trace, ends, q.cpu(), 64)
    with pytest.raises(ValueError):           # the other route's trace
        align_tb_cuda.tb_backward_cuda(trace, ends, q, 96)
    with pytest.raises(ValueError):           # refused before any launch
        DeviceCns(W=1056, device="cuda")
    assert DeviceCns(W=96, device="cuda").W == 96


def test_k1_rejects_cpu_only_inputs(rng):
    q, ql, t, tl = make_pairs(rng, 8, 256, 64)
    with pytest.raises(ValueError):
        align_cuda.extend_batch_cuda(q, ql.cpu(), t, tl, W=64)


D = cns_dp.D_DEFAULT
MAX_DIFF = np.float32(0.3)
DP_SHAPES = [(8, 2048, 1024), (16, 4096, 2048)]     # (G, T, L of the rows)


def _tags(rng, G, T, L):
    """(counts of a fresh batch, K4's other arguments, K4's counts)."""
    msa, rest = dp_batch(rng, G, T, L, D, MAX_DIFF)
    got = msa.view(torch.int16).clone().view(torch.uint16)
    n = dpk.LAUNCHES["tags"]
    dpk.accumulate_tags_planes_cuda(got, *rest)
    torch.cuda.synchronize()
    assert dpk.LAUNCHES["tags"] == n + 1
    return msa, rest, got


@pytest.mark.parametrize("G,T,L", DP_SHAPES)
def test_k4_matches_twin(rng, G, T, L):
    """Every count but the dump slot, which the twin and K4 both leave
    0."""
    msa, rest, got = _tags(rng, G, T, L)
    n_self = int(cns_dp.counts_i32(msa).sum())
    ref = cns_dp.accumulate_tags_planes(msa, *rest)
    got, ref = cns_dp.counts_i32(got), cns_dp.counts_i32(ref)
    assert torch.equal(got, ref)
    assert int(got[-1]) == 0 and int(got.sum()) > n_self


@pytest.mark.parametrize("G,T,L", DP_SHAPES)
def test_k5_matches_twin(rng, G, T, L):
    _, _, msa = _tags(rng, G, T, L)
    n = dpk.LAUNCHES["cns_scan"]
    got = dpk.consensus_scan_cuda(msa, G, T, D)
    torch.cuda.synchronize()
    assert dpk.LAUNCHES["cns_scan"] == n + 1
    for name, g, r in zip("bp cov gb_s gb_t gb_d gb_b".split(), got,
                          cns_dp.consensus_scan(msa, G, T, D)):
        assert torch.equal(g, r), name


@pytest.mark.parametrize("depth,G,T", [(3, 7, 193), (14, 9, 257),
                                       (16, 6, 160), (14, 1, 1), (14, 2, 2),
                                       (5, 3, 33)])
def test_k5_matches_twin_on_adversarial_counts(rng, depth, G, T):
    """Dense small counts on every level, many equal scores, empty columns,
    the level in use jumping between 0 and D - 1 (adversarial_counts); T
    below, at and off the prefetch distance and the 32-column coverage
    line."""
    host = adversarial_counts(rng, G, T, depth)
    msa = torch.from_numpy(host.view(np.int16)).cuda().view(torch.uint16)
    got = dpk.consensus_scan_cuda(msa, G, T, depth)
    torch.cuda.synchronize()
    for name, g, r in zip("bp cov gb_s gb_t gb_d gb_b".split(), got,
                          cns_dp.consensus_scan(msa, G, T, depth)):
        assert torch.equal(g, r), name


def test_k2_results_unchanged_beside_k1(rng):
    """K2 and K1 share tb_sweep.cuh: on the same rows K2's end cells equal
    K1's and its trace the plain sweep's, at every band both take."""
    for W, L, B in TB_SHAPES:
        args = make_pairs(rng, B, L, W)
        ends, trace = align_tb_cuda.tb_forward_cuda(*args, W, 3)
        k1 = align_cuda.extend_batch_cuda(*args, W=W)
        torch.cuda.synchronize()
        p_ends, planes = band_sweep(*args, W, 3, keep_moves=True)
        assert torch.equal(ends, k1) and torch.equal(ends, p_ends), W
        same, n = swept_cells_equal(unpack_trace(trace, W), planes, args[1],
                                    args[3], W)
        assert same and n > 0, W


@pytest.mark.parametrize("G,T,L", DP_SHAPES)
def test_k6_matches_twin(rng, G, T, L):
    """On a real scan with group G - 2 on a 2T-code ladder and group G - 1
    empty."""
    _, _, msa = _tags(rng, G, T, L)
    scan = ladder_walk(dpk.consensus_scan_cuda(msa, G, T, D), G - 2, T, D)
    n = dpk.LAUNCHES["cns_walk"]
    rows, counts = dpk.backtrack_walk_cuda(*scan, 2, G, T, D)
    torch.cuda.synchronize()
    assert dpk.LAUNCHES["cns_walk"] == n + 1
    ref_rows, ref_counts = cns_dp.backtrack_walk(*scan, 2, G, T, D)
    assert torch.equal(counts, ref_counts) and torch.equal(rows, ref_rows)
    assert counts[G - 1] == 0 and counts[G - 2] == 2 * T


def test_dp_wrappers_reject_cpu_tensors(rng):
    """A CPU tensor beside CUDA ones is refused, never copied over; an
    all-CPU call runs the twin and launches nothing."""
    G, T = 8, 1024
    msa, rest, got = _tags(rng, G, T, 512)
    with pytest.raises(ValueError):
        dpk.accumulate_tags_planes_cuda(got, rest[0], rest[1], rest[2],
                                        rest[3].cpu(), *rest[4:])
    scan = dpk.consensus_scan_cuda(got, G, T, D)
    with pytest.raises(ValueError):
        dpk.backtrack_walk_cuda(scan[0], scan[1].cpu(), *scan[2:], 2, G, T,
                                D)
    n = dict(dpk.LAUNCHES)
    cpu = dpk.consensus_scan_cuda(got.cpu(), G, T, D)
    assert dpk.LAUNCHES == n
    for g, r in zip(scan, cpu):
        assert torch.equal(g.cpu(), r)


# (D, T, byte offset of bp): T under one K6 window (WALK_WINDOW columns),
# on a window's boundary and one past it, and long; T off a multiple of 8
# (the output's byte path) and on it (16 bytes a lane)
WALK_CASES = [(3, 31, 1), (3, 1024, 3), (14, 33, 2), (14, 64, 0),
              (14, 2048, 1), (16, 97, 3), (16, 1000, 2)]


@pytest.mark.parametrize("depth,T,off", WALK_CASES)
def test_k6_matches_twin_on_walk_cases(rng, depth, T, off):
    """K6 on walk_cases at its own window (random plane, t = 0 start,
    start codes on a window's first and last column, the 2T ladder, an
    empty group, stays on every window boundary), bp placed at byte
    offset `off`."""
    bp, *rest = walk_cases(rng, T, depth, dpk.WALK_WINDOW, device="cuda")
    G = bp.shape[1]
    moved = torch.empty(bp.numel() + 4, dtype=torch.uint8, device="cuda")
    moved = moved[off:off + bp.numel()].view(bp.shape)
    moved.copy_(bp)
    n = dpk.LAUNCHES["cns_walk"]
    rows, counts = dpk.backtrack_walk_cuda(moved, *rest, 2, G, T, depth)
    torch.cuda.synchronize()
    assert dpk.LAUNCHES["cns_walk"] == n + 1
    ref_rows, ref_counts = cns_dp.backtrack_walk(bp, *rest, 2, G, T, depth)
    assert torch.equal(counts, ref_counts) and torch.equal(rows, ref_rows)
    assert counts[5] == 0 and counts[4] == 2 * T


# (D, P move bytes, B rows): K4's layout follows from them and the SM count
# (tag_layout; on 132 SMs: 8, 17, 128 segments a row at 1 row a block, 17
# at 8 rows, 9 at 4, 33 at 15, 128 segments of 32 bytes at 2)
TAG_CASES = [(3, 128, 8), (14, 257, 8), (16, 2048, 8), (14, 257, 1000),
             (3, 130, 600), (16, 513, 4000), (14, 4096, 200)]


@pytest.mark.parametrize("depth,P,B", TAG_CASES)
def test_k4_matches_twin_on_tag_rows(rng, depth, P, B):
    """K4 on tag_rows (first bad columns on a segment's first and last
    column, a short row, a dead row, a gated row, a row past T, then
    plain rows up to B), every count."""
    G, T = 5, 1024
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    segs = dpk.tag_layout(B, P, sms)[1]
    args = [torch.from_numpy(x).cuda()
            for x in tag_rows(rng, P, T, depth, segs, G, B)]
    msa = cns_dp.alloc_msa(G, T, depth, "cuda")
    n = dpk.LAUNCHES["tags"]
    got = dpk.accumulate_tags_planes_cuda(msa.clone(), *args, MAX_DIFF, T,
                                          depth)
    torch.cuda.synchronize()
    assert dpk.LAUNCHES["tags"] == n + 1
    ref = cns_dp.accumulate_tags_planes(msa.clone(), *args, MAX_DIFF, T,
                                        depth)
    got, ref = cns_dp.counts_i32(got), cns_dp.counts_i32(ref)
    assert torch.equal(got, ref) and int(got.sum()) > 0


TWO = ("cuda:0", "cuda:0")     # two shards on the one card a machine has


@pytest.mark.parametrize("W,B,L", [(256, 300, 1024), (64, 7, 2048),
                                   (192, 9, 512)])
def test_sharded_tb_align_matches_one_launch(rng, W, B, L):
    """K2 + K3 over two shards of one card (and B odd: 4 + 3, 5 + 4),
    a block-route band included, equal to one launch on all rows."""
    args = make_pairs(rng, B, L, W)
    mesh = pm.make_mesh(devices=TWO)
    n = align_tb_cuda.LAUNCHES[tb_key("tb_fwd", W)]
    got = pm.sharded_tb_align(mesh, *args, W=W)
    torch.cuda.synchronize()
    assert align_tb_cuda.LAUNCHES[tb_key("tb_fwd", W)] == n + 2
    for g, r in zip(got, align_tb_cuda.align_tb_batch_cuda(*args, W=W)):
        assert torch.equal(g, r)


def test_sum_over_mesh_wraps_on_the_card(rng):
    """uint16 counts near 2^16 summed over two shards of one card: count
    by count modulo 2^16, the parts left as they were."""
    host = rng.integers(0, 1 << 16, (2, 4097)).astype(np.uint16)
    host[:, :4] = [[65535, 1, 40000, 32768]] * 2
    parts = [torch.from_numpy(h.view(np.int16)).cuda().view(torch.uint16)
             for h in host]
    got = pm.sum_over_mesh(parts, pm.make_mesh(devices=TWO))
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        got.view(torch.int16).cpu().numpy().view(np.uint16),
        host.sum(0, dtype=np.uint16))
    assert int(parts[0].view(torch.int16)[0]) == -1


@pytest.mark.parametrize("G,T,L", [(7, 2048, 1024), (16, 4096, 2048)])
def test_consensus_split_matches_one_card(rng, G, T, L):
    """K4 over two shards of the tasks, summed, equals K4 on all of them
    into one buffer; K5 + K6 over two shards of the groups (G odd: 4 + 3)
    equal them on all groups."""
    msa0, rest = dp_batch(rng, G, T, L, D, MAX_DIFF)
    mesh = pm.make_mesh(devices=TWO)
    one = dpk.accumulate_tags_planes_cuda(cns_dp.alloc_msa(G, T, D, "cuda"),
                                          *rest)
    n = dpk.LAUNCHES["tags"]
    got = pm.sharded_cns_accumulate(mesh, G, T, D, *rest[:5], MAX_DIFF)
    torch.cuda.synchronize()
    assert dpk.LAUNCHES["tags"] == n + 2
    assert torch.equal(got.view(torch.int16), one.view(torch.int16))
    full = dpk.accumulate_tags_planes_cuda(msa0, *rest)
    scan = dpk.consensus_scan_cuda(full, G, T, D)
    rows, counts = dpk.backtrack_walk_cuda(*scan, 2, G, T, D)
    n = dpk.LAUNCHES["cns_walk"]
    got_rows, got_counts, scans = pm.sharded_cns_scan(mesh, full, G, T, D, 2)
    torch.cuda.synchronize()
    assert dpk.LAUNCHES["cns_walk"] == n + 2
    assert torch.equal(got_rows, rows) and torch.equal(got_counts, counts)
    assert torch.equal(torch.cat([s[0] for s in scans], 1), scan[0])
    assert (counts[:G - 1] > 0).all()


def test_graft_dryrun_over_two_shards_matches_one_card(rng):
    """graft_entry.dryrun_multichip(2) over two shards of one card: every
    stage's output equal to the same stages on cuda:0 unsplit."""
    got = graft_entry.dryrun_multichip(2, devices=TWO)
    ref = graft_entry.run_stages(pm.make_mesh(devices=("cuda:0",)), 2)
    torch.cuda.synchronize()
    for key in ("extend", "kmer_total", "aligned_bases", "msa", "rows",
                "counts"):
        assert torch.equal(got[key], ref[key]), key
    np.testing.assert_array_equal(got["specs"], ref["specs"])
    for g, r in zip(got["tb"], ref["tb"]):
        assert torch.equal(g, r)


def test_profile_cns_dp_matches_production_on_the_card(rng):
    """The tool's staged rebuild of the DP batch against dispatch_chunk_dp
    + finish_chunk_dp on the card, supports without a range included: the
    same consensus, tasks and launches of every kernel K2-K6."""
    res = profile_cns_dp.run(profile_cns_dp.parse_args(
        ["--genome-size", "40000", "--coverage", "10", "--unranged", "0.3",
         "--repeat", "1"]))
    assert res["parity"] is True
    assert res["tasks_from_host_ranges"] > 0
    assert min(res["launches_by_kernel"].get(k, 0) for k in (
        "tb_fwd", "tb_bwd", "tags", "cns_scan", "cns_walk")) > 0


def test_bench_accumulate_k4_matches_twin_on_the_card(rng):
    """K4 against its twin and against index_add_ of the decoded tags, at
    a cut of the tool's shapes."""
    res = bench_accumulate.run(bench_accumulate.parse_args(
        ["--B", "16", "--L", "4096", "--T", "4096", "--G", "8", "--reps",
         "2"]))
    assert res["parity"] is True and res["index_add_parity"] is True
    assert res["k4_launches"] == {"tags": 3}
    assert res["plain_launches"] == res["index_add_launches"] == {}



def test_spans_record_under_a_cuda_only_profiler(rng):
    """The benchmark's traced window opens torch.profiler with CUDA
    activity alone: the recorder records inside it, on the opening thread
    and, through carry(), on another."""
    from concurrent.futures import ThreadPoolExecutor

    def work():
        with trace.span("t.thread"):
            pass

    since = trace.mark()
    assert not trace.active()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]):
        assert trace.active()
        with trace.span("t.main"):
            with ThreadPoolExecutor(1) as ex:
                ex.submit(trace.carry(work)).result()
    assert [s.name for s in trace.records(since)] == ["t.thread", "t.main"]


def test_span_clock_is_the_device_traces(rng, tmp_path):
    """A span around a ~50 ms torch.cuda._sleep and its synchronize holds
    the kernel's interval in the exported trace (baseTimeNanoseconds +
    ts), within 1 ms at each end."""
    import json
    torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        with trace.span("t.sleep") as sp:
            torch.cuda._sleep(10 ** 8)             # ~50 ms at 1980 MHz
            torch.cuda.synchronize()
    fn = str(tmp_path / "trace.json")
    prof.export_chrome_trace(fn)
    with open(fn) as f:
        d = json.load(f)
    base = int(d["baseTimeNanoseconds"])
    k = [e for e in d["traceEvents"] if e.get("cat") == "kernel"]
    assert len(k) == 1                          # ATen's spin_kernel
    k0 = base + k[0]["ts"] * 1e3
    k1 = k0 + k[0]["dur"] * 1e3
    assert k1 - k0 > 1e7                        # the sleep ran > 10 ms
    assert abs(k0 - sp.t0) < 1e6, (k0 - sp.t0) / 1e6
    assert abs(sp.t1 - k1) < 1e6, (sp.t1 - k1) / 1e6
    assert sp.t0 - 1e6 <= k0 and k1 <= sp.t1 + 1e6


def test_copy_helper_counts_pageable_and_pinned_bytes(rng):
    a = torch.arange(1000, dtype=torch.int32)
    h = np.arange(333, dtype=np.int16)
    p = torch.from_numpy(h).pin_memory()
    with trace.recording() as got:
        x = trace.to_device(a, "cuda")
        y = trace.to_device(h, "cuda:0", torch.int32)
        z = trace.to_device(p, "cuda")
        trace.to_device(x, "cuda")               # on the device: no copy
        back = trace.to_host(y)
    assert [s.name for s in got] == ["copy.h2d"] * 3 + ["copy.d2h"]
    assert got[0].counts == {"bytes": 4000, "pageable": 4000}
    assert got[1].counts == {"bytes": 666, "pageable": 666}
    assert got[2].counts == {"bytes": 666, "pageable": 0}
    assert got[3].counts == {"bytes": 1332}
    assert torch.equal(x.cpu(), a) and torch.equal(z.cpu(), p)
    assert back.tolist() == list(range(333))


def test_dp_dispatch_spans_on_the_card(rng):
    """run_consensus_device on the DP path with four groups a DP batch
    (dp_budget 1): the in-flight bound waits (cns.wait_device) from the
    third batch on, and every copy the dispatch makes is pageable."""
    import io
    from falcon_tpu_torch.cns.device import run_consensus_device
    from falcon_tpu_torch.cns.runner import ConsensusConfig
    groups = []
    for g in range(12):
        truth = rng.integers(0, 4, 900).astype(np.uint8)
        items = [("%09d" % (10 * g), truth, None)]
        for k in range(4):
            sup = truth.copy()
            hit = rng.random(900) < 0.03
            sup[hit] = (sup[hit] + 1) % 4
            items.append(("%09d" % (10 * g + k + 1), sup, (0, 900, 0, 900)))
        groups.append((items[0][0], items))
    cfg = ConsensusConfig(min_cov=2, min_idt=0.70, min_n_read=2,
                          min_cov_aln=2)
    dev = DeviceCns(device="cuda", use_dp=True, dp_budget=1,
                    chunk_tasks=10 ** 6)
    with trace.recording() as got:
        n = run_consensus_device(iter(groups), cfg, io.StringIO(), dev=dev)
    assert n == 12 and sum(dev.dp_batches.values()) == 3
    names = [s.name for s in got]
    assert names.count("cns.wait_device") == 1
    assert names.count("cns.dispatch") == names.count("cns.finish") == 1
    h2d = [s.counts for s in got if s.name == "copy.h2d"]
    assert h2d and all(c["bytes"] == c["pageable"] > 0 for c in h2d)
