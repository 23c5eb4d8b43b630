"""ctypes binding for the native (C++) host kernels.

Builds falcon_tpu_torch/native/falcon_native.cpp on first use (g++ -O2 -shared)
into the package's own falcon_tpu_torch/_build/ (git ignores it; the CUDA
library of ops/_build.py lands there too) and exposes:

  * align(query, target, band_tolerance, get_aln_str) -- same signature
    and semantics as falcon_tpu_torch.ops.align.align
  * generate_consensus(seqs, min_cov, K, min_idt) -- same as
    falcon_tpu_torch.ops.consensus_dp.generate_consensus

available() reports whether the native library could be built/loaded;
callers fall back to the pure-python kernels otherwise.
"""
import ctypes
import logging
import os
import subprocess

LOG = logging.getLogger(__name__)

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_SRC = os.path.join(_PKG, "native", "falcon_native.cpp")
BUILD_DIR = os.path.join(_PKG, "_build")
_lib = None
_tried = False


def _build_and_load():
    src = os.path.abspath(_SRC)
    os.makedirs(BUILD_DIR, exist_ok=True)
    so = os.path.join(BUILD_DIR, "libfalcon_native.so")
    if not os.path.exists(so) or \
            os.path.getmtime(so) < os.path.getmtime(src):
        tmp = so + ".tmp.%d" % os.getpid()
        cmd = ["g++", "-O2", "-std=c++17", "-shared", "-fPIC", src, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(so)
    lib.ftpu_generate_consensus.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_uint, ctypes.c_uint,
        ctypes.c_uint, ctypes.c_double]
    lib.ftpu_generate_consensus.restype = ctypes.c_void_p
    lib.ftpu_free.argtypes = [ctypes.c_void_p]
    lib.ftpu_align.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.c_char_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p)]
    lib.ftpu_align.restype = ctypes.c_int
    lib.ftpu_cns_from_alns.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_char_p),
        ctypes.POINTER(ctypes.c_char_p), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_int), ctypes.c_uint]
    lib.ftpu_cns_from_alns.restype = ctypes.c_void_p
    lib.ftpu_seed_hits.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_void_p)]
    lib.ftpu_seed_hits.restype = ctypes.c_long
    lib.ftpu_free_i64.argtypes = [ctypes.c_void_p]
    lib.ftpu_seed_hits_idx.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.ftpu_seed_hits_idx.restype = ctypes.c_long
    lib.ftpu_free_i32.argtypes = [ctypes.c_void_p]
    lib.ftpu_moves_to_alns_c.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_long, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p]
    lib.ftpu_moves_to_alns_c.restype = None
    lib.ftpu_seed_chain.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.POINTER(ctypes.c_void_p)]
    lib.ftpu_seed_chain.restype = ctypes.c_long
    lib.ftpu_kmer_table.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.POINTER(ctypes.c_void_p)]
    lib.ftpu_kmer_table.restype = ctypes.c_long
    lib.ftpu_seed_chain_tables.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.POINTER(ctypes.c_void_p)]
    lib.ftpu_seed_chain_tables.restype = ctypes.c_long
    lib.ftpu_free_u64.argtypes = [ctypes.c_void_p]
    lib.ftpu_dust_mask.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_double, ctypes.c_void_p]
    lib.ftpu_dust_mask.restype = ctypes.c_long
    lib.ftpu_tandem_mask.argtypes = [
        ctypes.c_void_p, ctypes.c_long, ctypes.c_void_p, ctypes.c_long,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    lib.ftpu_tandem_mask.restype = ctypes.c_long
    return lib


import threading as _threading

_lib_lock = _threading.Lock()


def get_lib():
    global _lib, _tried
    if _lib is None and not _tried:
        # thread-safe lazy load (callers may hit this from worker threads)
        with _lib_lock:
            if _lib is None and not _tried:
                try:
                    _lib = _build_and_load()
                except Exception as e:
                    LOG.warning("native kernels unavailable (%s); "
                                "falling back to python", e)
                _tried = True
    return _lib


def available():
    return get_lib() is not None


def _as_bytes(s):
    if isinstance(s, bytes):
        return s
    if isinstance(s, str):
        return s.encode()
    return bytes(s)


def align(query, target, band_tolerance, get_aln_str=True):
    """Native banded O(ND) alignment; returns an ops.align.Alignment."""
    from . import align as _pyalign
    lib = get_lib()
    q = _as_bytes(query)
    t = _as_bytes(target)
    out6 = (ctypes.c_int * 6)()
    qa = ctypes.c_void_p()
    ta = ctypes.c_void_p()
    ok = lib.ftpu_align(q, len(q), t, len(t), band_tolerance,
                        1 if get_aln_str else 0, out6,
                        ctypes.byref(qa), ctypes.byref(ta))
    rtn = _pyalign.Alignment()
    if ok:
        (rtn.aln_q_s, rtn.aln_q_e, rtn.aln_t_s, rtn.aln_t_e,
         rtn.dist, rtn.aln_str_size) = [int(x) for x in out6]
    if get_aln_str:
        if qa.value:
            rtn.q_aln_str = ctypes.string_at(qa.value) if ok else b""
            lib.ftpu_free(qa)
        if ta.value:
            rtn.t_aln_str = ctypes.string_at(ta.value) if ok else b""
            lib.ftpu_free(ta)
    return rtn


def seed_hits(q_codes, q_offsets, t_codes, t_offsets, K, stride, max_freq):
    """Block seed join: (q_flat_pos, t_flat_pos) int64 hit arrays.

    q_codes/t_codes: flat uint8 code arrays; *_offsets: int64 read offset
    arrays (len n_reads+1)."""
    import numpy as np
    lib = get_lib()
    q_codes = np.ascontiguousarray(q_codes, dtype=np.uint8)
    t_codes = np.ascontiguousarray(t_codes, dtype=np.uint8)
    q_offsets = np.ascontiguousarray(q_offsets, dtype=np.int64)
    t_offsets = np.ascontiguousarray(t_offsets, dtype=np.int64)
    qp = ctypes.c_void_p()
    tp = ctypes.c_void_p()
    n = lib.ftpu_seed_hits(
        q_codes.ctypes.data, q_offsets.ctypes.data, len(q_offsets) - 1,
        t_codes.ctypes.data, t_offsets.ctypes.data, len(t_offsets) - 1,
        K, stride, max_freq, ctypes.byref(qp), ctypes.byref(tp))
    try:
        qhits = np.ctypeslib.as_array(
            ctypes.cast(qp, ctypes.POINTER(ctypes.c_int64)),
            shape=(max(n, 1),))[:n].copy()
        thits = np.ctypeslib.as_array(
            ctypes.cast(tp, ctypes.POINTER(ctypes.c_int64)),
            shape=(max(n, 1),))[:n].copy()
    finally:
        lib.ftpu_free_i64(qp)
        lib.ftpu_free_i64(tp)
    return qhits, thits


def seed_hits_idx(q_codes, q_offsets, t_codes, t_offsets, K, stride,
                  max_freq):
    """Block seed join with coordinate mapping baked in: returns int32
    (a_idx, qpos, b_idx, tpos) per hit (read indices + read-local
    positions)."""
    import numpy as np
    lib = get_lib()
    q_codes = np.ascontiguousarray(q_codes, dtype=np.uint8)
    t_codes = np.ascontiguousarray(t_codes, dtype=np.uint8)
    q_offsets = np.ascontiguousarray(q_offsets, dtype=np.int64)
    t_offsets = np.ascontiguousarray(t_offsets, dtype=np.int64)
    out4 = (ctypes.c_void_p * 4)()
    n = lib.ftpu_seed_hits_idx(
        q_codes.ctypes.data, q_offsets.ctypes.data, len(q_offsets) - 1,
        t_codes.ctypes.data, t_offsets.ctypes.data, len(t_offsets) - 1,
        K, stride, max_freq, out4)
    try:
        arrs = [np.ctypeslib.as_array(
            ctypes.cast(out4[c], ctypes.POINTER(ctypes.c_int32)),
            shape=(max(n, 1),))[:n].copy() for c in range(4)]
    finally:
        for c in range(4):
            lib.ftpu_free_i32(out4[c])
    return tuple(arrs)


def cns_from_alns(t_len, alns, min_cov):
    """Consensus from precomputed gapped alignments.

    alns: list of (q_aln bytes, t_aln bytes, s1, s2).  Exact tag/MSA/DP
    semantics of generate_consensus given those alignments."""
    lib = get_lib()
    n = len(alns)
    qas = (ctypes.c_char_p * max(n, 1))()
    tas = (ctypes.c_char_p * max(n, 1))()
    s1s = (ctypes.c_int * max(n, 1))()
    s2s = (ctypes.c_int * max(n, 1))()
    for i, (qa, ta, s1, s2) in enumerate(alns):
        qas[i] = _as_bytes(qa)
        tas[i] = _as_bytes(ta)
        s1s[i] = s1
        s2s[i] = s2
    p = lib.ftpu_cns_from_alns(t_len, n, qas, tas, s1s, s2s, min_cov)
    try:
        return ctypes.string_at(p).decode()
    finally:
        lib.ftpu_free(p)


def generate_consensus(seqs, min_cov, K, min_idt):
    lib = get_lib()
    arr = (ctypes.c_char_p * len(seqs))()
    arr[:] = [_as_bytes(s) for s in seqs]
    p = lib.ftpu_generate_consensus(arr, len(seqs), min_cov, K, min_idt)
    try:
        return ctypes.string_at(p).decode()
    finally:
        lib.ftpu_free(p)


def moves_to_alns(packed, lanes, q_list, t_list):
    """Batch gapped-alignment reconstruction from ONE device batch's
    packed move plane (ops.align_tb pack_moves layout [P, B]).

    lanes[i]: which batch column task i used; q_list/t_list: that task's
    base-code arrays.  Returns [(n_cols, q_aln bytes, t_aln bytes)].
    """
    import numpy as np
    lib = get_lib()
    n = len(lanes)
    packed_t = np.ascontiguousarray(packed.T)      # [B, P] contiguous
    P = packed_t.shape[1]
    lanes = np.ascontiguousarray(lanes, dtype=np.int32)
    qlens = np.array([len(q) for q in q_list], dtype=np.int64)
    tlens = np.array([len(t) for t in t_list], dtype=np.int64)
    q_offs = np.zeros(n + 1, np.int64)
    np.cumsum(qlens, out=q_offs[1:])
    t_offs = np.zeros(n + 1, np.int64)
    np.cumsum(tlens, out=t_offs[1:])
    qcat = np.concatenate([np.asarray(q, dtype=np.uint8) for q in q_list]) \
        if n else np.zeros(0, np.uint8)
    tcat = np.concatenate([np.asarray(t, dtype=np.uint8) for t in t_list]) \
        if n else np.zeros(0, np.uint8)
    out_offs = np.zeros(n + 1, np.int64)
    np.cumsum(qlens + tlens, out=out_offs[1:])
    qa = np.empty(int(out_offs[-1]), np.uint8)
    ta = np.empty(int(out_offs[-1]), np.uint8)
    ncols = np.zeros(n, np.int32)
    lib.ftpu_moves_to_alns_c(
        packed_t.ctypes.data, P, n, lanes.ctypes.data,
        qcat.ctypes.data, q_offs.ctypes.data,
        tcat.ctypes.data, t_offs.ctypes.data,
        qa.ctypes.data, ta.ctypes.data, out_offs.ctypes.data,
        ncols.ctypes.data)
    out = []
    for i in range(n):
        c = int(ncols[i])
        o = int(out_offs[i])
        out.append((c, qa[o:o + c].tobytes(), ta[o:o + c].tobytes()))
    return out


def moves_to_alns_lanes(plane, lo, hi, cat, q_offs, q_lens, t_offs, t_lens):
    """moves_to_alns over lanes lo..hi of one batch whose tasks' codes one
    buffer holds, read where they lie: plane the batch's packed moves laid
    out lane-major, [B, P]; cat the codes and, a lane, the offsets and
    lengths of its q and t in cat (the numpy views of
    ops.align_device.pack_tasks's tensors).
    Returns [(n_cols, q_aln bytes, t_aln bytes)] a lane."""
    import numpy as np
    if not (0 <= lo < hi <= min(plane.shape[0], len(q_offs))):
        raise ValueError("lanes %d..%d of a batch of %d" % (
            lo, hi, plane.shape[0]))
    plane = np.ascontiguousarray(plane, dtype=np.uint8)
    n = hi - lo
    out_offs = np.zeros(n + 1, np.int64)
    np.cumsum(q_lens[lo:hi].astype(np.int64) + t_lens[lo:hi],
              out=out_offs[1:])
    qa = np.empty(int(out_offs[-1]), np.uint8)
    ta = np.empty(int(out_offs[-1]), np.uint8)
    q_offs = q_offs[lo:hi].astype(np.int64)
    t_offs = t_offs[lo:hi].astype(np.int64)
    lanes = np.arange(lo, hi, dtype=np.int32)
    ncols = np.zeros(n, np.int32)
    get_lib().ftpu_moves_to_alns_c(
        plane.ctypes.data, plane.shape[1], n, lanes.ctypes.data,
        cat.ctypes.data, q_offs.ctypes.data, cat.ctypes.data,
        t_offs.ctypes.data, qa.ctypes.data, ta.ctypes.data,
        out_offs.ctypes.data, ncols.ctypes.data)
    return [(c, qa[o:o + c].tobytes(), ta[o:o + c].tobytes())
            for c, o in zip(ncols.tolist(), out_offs.tolist())]


def seed_chain(q_codes, q_offsets, t_codes, t_offsets, K, stride,
               max_freq, bin_size, min_hits, filter_mode, rids_a, rids_b,
               topk=3):
    """Fused seed join + diagonal-window chaining for one strand.

    filter_mode: 0 none, 1 keep rids_a[a] < rids_b[b], 2 keep !=.
    topk: disjoint diagonal windows emitted per pair (daligner's
    multiple-local-alignments analog).
    Returns int32 arrays (a_idx, b_idx, q_anchor, t_anchor, n_seeds),
    pairs ascending by (a_idx, b_idx), per-pair candidates by
    (q_anchor, t_anchor).  Exact semantics of
    overlap.engine._chain_candidates (tests/test_engine_chain.py)."""
    import numpy as np
    lib = get_lib()
    q_codes = np.ascontiguousarray(q_codes, dtype=np.uint8)
    t_codes = np.ascontiguousarray(t_codes, dtype=np.uint8)
    q_offsets = np.ascontiguousarray(q_offsets, dtype=np.int64)
    t_offsets = np.ascontiguousarray(t_offsets, dtype=np.int64)
    rids_a = np.ascontiguousarray(rids_a, dtype=np.int64)
    rids_b = np.ascontiguousarray(rids_b, dtype=np.int64)
    # anchors are packed (qpos << 21 | tpos) in the C++ scan
    max_len = max(int(np.diff(q_offsets).max(initial=0)),
                  int(np.diff(t_offsets).max(initial=0)))
    if max_len >= (1 << 21):
        raise ValueError("seed_chain: read length %d exceeds the 2^21 "
                         "position packing" % max_len)
    out5 = (ctypes.c_void_p * 5)()
    n = lib.ftpu_seed_chain(
        q_codes.ctypes.data, q_offsets.ctypes.data, len(q_offsets) - 1,
        t_codes.ctypes.data, t_offsets.ctypes.data, len(t_offsets) - 1,
        K, stride, max_freq, bin_size, min_hits, filter_mode, topk,
        rids_a.ctypes.data, rids_b.ctypes.data, out5)
    try:
        arrs = [np.ctypeslib.as_array(
            ctypes.cast(out5[c], ctypes.POINTER(ctypes.c_int32)),
            shape=(max(n, 1),))[:n].copy() for c in range(5)]
    finally:
        for c in range(5):
            lib.ftpu_free_i32(out5[c])
    return tuple(arrs)


class KmerTable:
    """Owner of a native-malloc'd sorted k-mer table (packed
    key<<34|flat_pos uint64 entries).  Exposes a zero-copy numpy view
    (`arr`); the buffer is freed when the object is collected.  Built
    once per (block, strand) and reused across every pair the block
    participates in (the pack+radix-sort is the dominant per-pair host
    cost at Dmel scale)."""

    def __init__(self, ptr, n):
        import numpy as np
        self._ptr = ptr
        self.n = n
        # captured now: module globals may already be cleared when
        # __del__ runs at interpreter shutdown
        self._free = get_lib().ftpu_free_u64
        self.arr = np.ctypeslib.as_array(
            ctypes.cast(ptr, ctypes.POINTER(ctypes.c_uint64)),
            shape=(max(n, 1),))[:n]

    def __del__(self):
        ptr, self._ptr = getattr(self, "_ptr", None), None
        if ptr:
            try:
                self._free(ptr)
            except TypeError:   # interpreter teardown
                pass

    @property
    def nbytes(self):
        return 8 * self.n


def kmer_table(codes, offsets, K, stride):
    """Pack + key-sort one side's k-mer table; returns a KmerTable."""
    import numpy as np
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    out = ctypes.c_void_p()
    n = lib.ftpu_kmer_table(codes.ctypes.data, offsets.ctypes.data,
                            len(offsets) - 1, K, stride,
                            ctypes.byref(out))
    if n < 0:
        raise MemoryError("ftpu_kmer_table: table allocation failed")
    return KmerTable(out, n)


def seed_chain_tables(qtab, ttab, q_offsets, t_offsets, max_freq,
                      bin_size, min_hits, filter_mode, rids_a, rids_b,
                      topk=3):
    """seed_chain from prebuilt sorted KmerTables (join + chain only).

    Exact same outputs as seed_chain on the tables' source arrays; the
    pack+sort cost is paid once per block via kmer_table and amortized
    across the block-pair triangle."""
    import numpy as np
    lib = get_lib()
    q_offsets = np.ascontiguousarray(q_offsets, dtype=np.int64)
    t_offsets = np.ascontiguousarray(t_offsets, dtype=np.int64)
    rids_a = np.ascontiguousarray(rids_a, dtype=np.int64)
    rids_b = np.ascontiguousarray(rids_b, dtype=np.int64)
    max_len = max(int(np.diff(q_offsets).max(initial=0)),
                  int(np.diff(t_offsets).max(initial=0)))
    if max_len >= (1 << 21):
        raise ValueError("seed_chain: read length %d exceeds the 2^21 "
                         "position packing" % max_len)
    out5 = (ctypes.c_void_p * 5)()
    n = lib.ftpu_seed_chain_tables(
        qtab.arr.ctypes.data if qtab.n else None, qtab.n,
        ttab.arr.ctypes.data if ttab.n else None, ttab.n,
        q_offsets.ctypes.data, len(q_offsets) - 1,
        t_offsets.ctypes.data, len(t_offsets) - 1,
        max_freq, bin_size, min_hits, filter_mode, topk,
        rids_a.ctypes.data, rids_b.ctypes.data, out5)
    try:
        arrs = [np.ctypeslib.as_array(
            ctypes.cast(out5[c], ctypes.POINTER(ctypes.c_int32)),
            shape=(max(n, 1),))[:n].copy() for c in range(5)]
    finally:
        for c in range(5):
            lib.ftpu_free_i32(out5[c])
    return tuple(arrs)


def dust_mask(codes, offsets, window=64, max_dist=8, min_frac=0.7):
    """C++ dust mask; bit-identical to io.masking.dust_mask."""
    import numpy as np
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    out = np.zeros(len(codes), np.uint8)
    rc = lib.ftpu_dust_mask(codes.ctypes.data, len(codes),
                            offsets.ctypes.data, len(offsets) - 1,
                            window, max_dist, float(min_frac),
                            out.ctypes.data)
    if rc < 0:
        raise ValueError("ftpu_dust_mask failed")
    return out.astype(bool)


def tandem_mask(codes, offsets, k=12, max_period=500):
    """C++ tandem mask; bit-identical to io.masking.tandem_mask."""
    import numpy as np
    lib = get_lib()
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    offsets = np.ascontiguousarray(offsets, dtype=np.int64)
    out = np.zeros(len(codes), np.uint8)
    rc = lib.ftpu_tandem_mask(codes.ctypes.data, len(codes),
                              offsets.ctypes.data, len(offsets) - 1,
                              k, max_period, out.ctypes.data)
    if rc < 0:
        raise ValueError("ftpu_tandem_mask failed (k out of range?)")
    return out.astype(bool)
