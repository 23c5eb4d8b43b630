"""The overlap engine's device aligner (port of make_device_aligner,
falcon_tpu/overlap/engine.py:600-700).

Seeding, chaining, record finalisation and dedup are falcon_tpu's
(falcon_tpu.overlap.engine and .table, imported); this module only builds
the (offset, len, dir) extension specs of every candidate and emits the
records around the port's DeviceExtender, whose batches run through K1.
"""
import numpy as np

from falcon_tpu.overlap import table as T
from falcon_tpu.overlap.engine import _dedup_extents

from ..ops.align_device import DeviceExtender


def make_device_aligner(W=512, end_bonus=3, max_batch=512, device=None):
    """An `aligner` for falcon_tpu.overlap.engine.align_candidates: both
    extensions of every candidate ride one batched run_specs call over
    the block's codes, which go to the device once."""
    ext = DeviceExtender(W=W, end_bonus=end_bonus, max_batch=max_batch,
                         device=device)

    def _specs(store, index, rids_a, c):
        ai, bi, strand, qa, ta = c[:, 0], c[:, 1], c[:, 2], c[:, 3], c[:, 4]
        a_same = rids_a is index.rids or (
            len(rids_a) == len(index.rids) and
            np.array_equal(rids_a, index.rids))
        if a_same:
            a_offsets = index.offsets
            a_lens = index.lens
            flat = np.concatenate([index.fwd, index.rev])
            fwd_base = 0
        else:
            a_lens = store.lengths[rids_a].astype(np.int64)
            a_offsets = np.zeros(len(rids_a) + 1, np.int64)
            np.cumsum(a_lens, out=a_offsets[1:])
            a_flat = np.empty(int(a_offsets[-1]), np.uint8)
            for k, rid in enumerate(rids_a):
                cc = store.get_codes(rid)
                a_flat[a_offsets[k]:a_offsets[k] + len(cc)] = cc
            flat = np.concatenate([a_flat, index.fwd, index.rev])
            fwd_base = len(a_flat)
        rev_base = fwd_base + len(index.fwd)
        a_off0 = a_offsets[ai]
        bo = index.offsets[bi]
        t_base = np.where(strand == 0, fwd_base, rev_base)
        N = len(c)
        sp = np.empty((6, 2 * N), np.int64)   # q_off q_len q_dir t_off ...
        sp[:, 0::2] = [a_off0 + qa, a_lens[ai] - qa, np.ones(N),  # fwd
                       t_base + bo + ta, index.lens[bi] - ta, np.ones(N)]
        sp[:, 1::2] = [a_off0 + qa - 1, qa, -np.ones(N),          # bwd
                       t_base + bo + ta - 1, ta, -np.ones(N)]
        return ext.run_specs(flat, *sp)

    def aligner(store, index, rids_a, cands, params):
        if not cands:
            return T.empty(0)
        c = np.asarray(cands, dtype=np.int64)          # [N, 6]
        rids_a = np.asarray(rids_a, np.int64)
        r = _specs(store, index, rids_a, c).reshape(len(c), 2, 3)
        ai, bi, strand, qa, ta = c[:, 0], c[:, 1], c[:, 2], c[:, 3], c[:, 4]
        a_len = np.asarray(store.lengths, np.int64)[rids_a[ai]]
        blen = np.asarray(index.lens, np.int64)[bi]
        a_s = qa - r[:, 1, 0]
        b_s = ta - r[:, 1, 1]
        a_e = qa + r[:, 0, 0]
        b_e = ta + r[:, 0, 1]
        dist = r[:, 0, 2] + r[:, 1, 2]
        rev = strand == 1
        b_s2 = np.where(rev, blen - b_e, b_s)
        b_e2 = np.where(rev, blen - b_s, b_e)
        a_ids = rids_a[ai]
        b_ids = index.rids[bi]
        keep = _dedup_extents(a_ids, b_ids, strand, a_s, a_e, b_s2, b_e2,
                              dist)
        return T.finalize(
            a_ids[keep], b_ids[keep], strand[keep],
            a_s[keep], a_e[keep], a_len[keep], b_s2[keep], b_e2[keep],
            blen[keep], dist[keep],
            params.min_overlap, params.min_idt)

    aligner.ext = ext      # occupancy / cell-accounting surface
    return aligner
