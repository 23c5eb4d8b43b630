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
                        make_pairs, swept_cells_equal)
from falcon_tpu_torch.cns.device import DeviceCns
from falcon_tpu_torch.ops import align_cuda, align_tb_cuda, cns_dp
from falcon_tpu_torch.ops import cns_dp_cuda as dpk
from falcon_tpu_torch.ops.align_device import band_sweep, extend_batch
from falcon_tpu_torch.ops.align_tb import (align_tb_batch, pack_moves,
                                           pack_trace, unpack_trace,
                                           walk_back)

pytestmark = pytest.mark.gpu


@pytest.fixture
def rng():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return np.random.default_rng(5)


@pytest.mark.parametrize("W,L,B", [(64, 512, 24), (256, 2048, 16),
                                   (32, 256, 40), (128, 1024, 70),
                                   (512, 1024, 24), (512, 4096, 12),
                                   (96, 512, 24), (1024, 2048, 8),
                                   (256, 1000, 700)])
def test_k1_matches_twin(rng, W, L, B):
    """Every band of the warp kernel, two of the block kernel, an L that is
    no multiple of 16, and more rows than one wave of warps."""
    args = make_pairs(rng, B, L, W)
    n = align_cuda.LAUNCHES["extend"]
    got = align_cuda.extend_batch_cuda(*args, W=W)
    torch.cuda.synchronize()
    assert align_cuda.LAUNCHES["extend"] == n + 1
    assert torch.equal(got, extend_batch(*args, W=W))


TB_SHAPES = [(32, 256, 40), (64, 512, 24), (128, 1024, 70),
             (256, 2048, 16), (256, 1024, 130)]


@pytest.mark.parametrize("W,L,B", TB_SHAPES)
def test_k2_k3_match_twin(rng, W, L, B):
    args = make_pairs(rng, B, L, W)
    got = align_tb_cuda.align_tb_batch_cuda(*args, W=W)
    torch.cuda.synchronize()
    for name, g, r in zip("i j d moves bases".split(), got,
                          align_tb_batch(*args, W=W)):
        assert torch.equal(g, r), name


@pytest.mark.parametrize("W,L,B", TB_SHAPES)
def test_k2_matches_band_sweep(rng, W, L, B):
    """K2's ends, and its two-bit trace on every cell a row swept."""
    args = make_pairs(rng, B, L, W)
    n = align_tb_cuda.LAUNCHES["tb_fwd"]
    ends, trace = align_tb_cuda.tb_forward_cuda(*args, W, 3)
    torch.cuda.synchronize()
    assert align_tb_cuda.LAUNCHES["tb_fwd"] == n + 1
    p_ends, planes = band_sweep(*args, W, 3, keep_moves=True)
    assert torch.equal(ends, p_ends)
    same, cells = swept_cells_equal(unpack_trace(trace, W), planes, args[1],
                                    args[3], W)
    assert same and cells > 0


@pytest.mark.parametrize("W,L,B", TB_SHAPES)
def test_k3_matches_walk_back(rng, W, L, B):
    """K3 on the plain sweep's trace and ends."""
    args = make_pairs(rng, B, L, W)
    p_ends, planes = band_sweep(*args, W, 3, keep_moves=True)
    n = align_tb_cuda.LAUNCHES["tb_bwd"]
    moves, bases = align_tb_cuda.tb_backward_cuda(
        pack_trace(planes, L), p_ends, args[0], W)
    torch.cuda.synchronize()
    assert align_tb_cuda.LAUNCHES["tb_bwd"] == n + 1
    p_moves, p_bases = walk_back(args[0], p_ends, planes, W)
    assert torch.equal(moves, pack_moves(p_moves))
    assert torch.equal(bases, p_bases)


def test_k2_k3_reject_what_they_do_not_take(rng):
    q, ql, t, tl = make_pairs(rng, 8, 256, 64)
    with pytest.raises(ValueError):           # a band with no instantiation
        align_tb_cuda.align_tb_batch_cuda(q, ql, t, tl, W=96)
    with pytest.raises(ValueError):           # L not a multiple of 16
        align_tb_cuda.align_tb_batch_cuda(
            q[:, :250].contiguous(), ql.clamp_max(250),
            t[:, :250].contiguous(), tl.clamp_max(250), W=64)
    ends, trace = align_tb_cuda.tb_forward_cuda(q, ql, t, tl, 64, 3)
    with pytest.raises(ValueError):           # q on the CPU beside the trace
        align_tb_cuda.tb_backward_cuda(trace, ends, q.cpu(), 64)
    with pytest.raises(ValueError):           # refused before any launch
        DeviceCns(W=96, device="cuda")


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
