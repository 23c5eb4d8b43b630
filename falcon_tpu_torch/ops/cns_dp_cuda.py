"""K4 + K5 + K6 wrappers: the hand-written CUDA device-DP consensus
(csrc/cns_dp.cu).

Same contracts as the plain twins in ops.cns_dp (falcon_tpu/ops/cns_dp.py
accumulate_tags_planes, consensus_scan, backtrack + compact_emit).  Each
wrapper checks device, dtype, shape and contiguity; on CUDA tensors it
launches its kernel or raises, on CPU tensors it runs the twin.  LAUNCHES
counts each kernel's launches.

K4's launch shape, rows a block and segments a row, comes from the
batch's shape and the card's SM count (tag_layout); it changes nothing in
the result.
"""
import ctypes

import numpy as np
import torch

from . import _build
from . import cns_dp

LAUNCHES = {"tags": 0, "cns_scan": 0, "cns_walk": 0}

WALK_WINDOW = 32     # K6: columns a window of its ring (csrc WALK_WINDOW)
MAX_TAG_THREADS = 512     # K4's threads a block (csrc TAG_THREADS)


def tag_layout(B, P, sms):
    """K4's (rows a block, segments a row) for B rows of P move bytes on
    a card of `sms` SMs: segments of ~16 bytes (64 columns), at most 128;
    rows a block the largest power of two up to B / sms, so that the
    blocks reach every SM, within MAX_TAG_THREADS threads a block."""
    segs = max(1, min(128, -(-P // 16)))
    per_sm = -(-B // sms)
    rows = 1 << (max(per_sm, 1).bit_length() - 1)
    return max(1, min(rows, MAX_TAG_THREADS // segs)), segs


def _check(name, x, dtype, shape, device):
    if x.dtype != dtype or tuple(x.shape) != tuple(shape):
        raise ValueError("%s must be %s %s; got %s %s" % (
            name, dtype, tuple(shape), x.dtype, tuple(x.shape)))
    if not x.is_contiguous():
        raise ValueError("%s must be contiguous" % name)
    if x.device != device:
        raise ValueError("%s is on %s, expected %s" % (name, x.device,
                                                       device))


def _check_dims(G, T, D):
    """D in [3, 16]: the scan's delta >= 2 class needs d = 2, and the
    tag latch packs delta into 4 bits."""
    if not 3 <= D <= 16:
        raise ValueError("D must be in [3, 16]; got %d" % D)
    if G < 1 or T < 1:
        raise ValueError("G and T must be positive; got %d, %d" % (G, T))


def _on_cuda(x, what):
    if x.device.type != "cuda":
        raise ValueError("%s: unsupported device %s" % (what, x.device))


def _check_msa(msa, T, D):
    """The flat uint16 count buffer; returns its G."""
    G = cns_dp.g_of(msa.numel(), T, D)
    _check_dims(G, T, D)
    _check("msa", msa, torch.uint16, (cns_dp.msa_size(G, T, D),),
           msa.device)
    if msa.data_ptr() % 4:
        raise ValueError("msa must be 4-byte aligned (K4 adds to 32-bit "
                         "words)")
    return G


def accumulate_tags_planes_cuda(msa, mvp, basep, bd, gidx, s2, max_diff, T,
                                D):
    """Fold one align batch's tags into msa, in place (K4).  Arguments as
    ops.cns_dp.accumulate_tags_planes; max_diff goes to the kernel as the
    float32 the keep gate compares in.  Returns msa."""
    G = _check_msa(msa, T, D)
    P, B = mvp.shape
    dev = msa.device
    _check("mvp", mvp, torch.uint8, (P, B), dev)
    _check("basep", basep, torch.int8, (4 * P, B), dev)
    for name, x in (("bd", bd), ("gidx", gidx), ("s2", s2)):
        _check(name, x, torch.int32, (B,), dev)
    max_diff = np.float32(max_diff)
    if dev.type == "cpu":
        return cns_dp.accumulate_tags_planes(msa, mvp, basep, bd, gidx, s2,
                                             max_diff, T, D)
    _on_cuda(msa, "K4")
    if B and P:
        rows, segs = tag_layout(
            B, P, torch.cuda.get_device_properties(dev).multi_processor_count)
        with torch.cuda.device(dev):
            _build.check(_build.lib().ftt_tags(
                msa.data_ptr(), mvp.data_ptr(), basep.data_ptr(),
                bd.data_ptr(), gidx.data_ptr(), s2.data_ptr(), B, P, G, T,
                D, ctypes.c_float(max_diff), rows, segs,
                _build.stream_of(msa)), "K4")
        LAUNCHES["tags"] += 1
    return msa


def consensus_scan_cuda(msa, G, T, D):
    """Forward DP over t (K5).  Returns (bp [T, G, D*5] uint8, cov [G, T]
    int32, gb_s [G] float32, gb_t, gb_d, gb_b [G] int32), as
    ops.cns_dp.consensus_scan."""
    if _check_msa(msa, T, D) != G:
        raise ValueError("msa holds %d groups, not %d"
                         % (cns_dp.g_of(msa.numel(), T, D), G))
    if msa.device.type == "cpu":
        return cns_dp.consensus_scan(msa, G, T, D)
    _on_cuda(msa, "K5")
    dev = msa.device
    bp = torch.empty((T, G, D * 5), dtype=torch.uint8, device=dev)
    cov = torch.empty((G, T), dtype=torch.int32, device=dev)
    gb_s = torch.empty(G, dtype=torch.float32, device=dev)
    gb = [torch.empty(G, dtype=torch.int32, device=dev) for _ in range(3)]
    with torch.cuda.device(dev):
        _build.check(_build.lib().ftt_cns_scan(
            msa.data_ptr(), G, T, D, bp.data_ptr(), cov.data_ptr(),
            gb_s.data_ptr(), gb[0].data_ptr(), gb[1].data_ptr(),
            gb[2].data_ptr(), _build.stream_of(msa)), "K5")
    LAUNCHES["cns_scan"] += 1
    return (bp, cov, gb_s, *gb)


def backtrack_walk_cuda(bp, cov, gb_s, gb_t, gb_d, gb_b, min_cov, G, T, D):
    """Walk back from each group's best column (K6).  Returns (out [G, 2T]
    uint8 emitted codes, 0 past the count; counts [G] int32), as
    ops.cns_dp.backtrack_walk.  bp is K5's (stay codes at d >= 1 only,
    jumps to d < D)."""
    _check_dims(G, T, D)
    dev = bp.device
    _check("bp", bp, torch.uint8, (T, G, D * 5), dev)
    _check("cov", cov, torch.int32, (G, T), dev)
    _check("gb_s", gb_s, torch.float32, (G,), dev)
    for name, x in (("gb_t", gb_t), ("gb_d", gb_d), ("gb_b", gb_b)):
        _check(name, x, torch.int32, (G,), dev)
    if dev.type == "cpu":
        return cns_dp.backtrack_walk(bp, cov, gb_s, gb_t, gb_d, gb_b,
                                     min_cov, G, T, D)
    _on_cuda(bp, "K6")
    out = torch.zeros((G, 2 * T), dtype=torch.uint8, device=dev)
    counts = torch.empty(G, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        _build.check(_build.lib().ftt_cns_walk(
            bp.data_ptr(), cov.data_ptr(), gb_s.data_ptr(), gb_t.data_ptr(),
            gb_d.data_ptr(), gb_b.data_ptr(), int(min_cov), G, T, D,
            out.data_ptr(), counts.data_ptr(), _build.stream_of(bp)), "K6")
    LAUNCHES["cns_walk"] += 1
    return out, counts
