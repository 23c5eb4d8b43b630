"""Multi-GPU data parallelism for the overlap engine (port of
falcon_tpu/parallel/mesh.py).

falcon_tpu shards extension batches over a 1-D "pair" mesh with
jax.shard_map: every device runs the banded extension kernel on its shard
and the host gathers the (i, j, d) results.  Here the mesh is a tuple of
torch.devices and the shard_map is written out, once, in
sharded_specs_extend, the entry of ops.align_device.DeviceExtender's
run_specs: a batch's rows are cut into contiguous shards, one per mesh
entry, every shard is queued on its own device's current stream before any
is waited on, and the results are concatenated in shard order on the
mesh's first device.

K1 (ops.align_cuda) has no row tile, so a batch needs no padding to a
multiple of (256 x devices) as the Pallas kernel's did
(falcon_tpu/ops/align_device.py:516-520): B rows are split as evenly as
possible (shard_bounds), and a mesh entry whose shard is empty launches
nothing.  A mesh may name one device more than once (two shards on one
card), and on CPU devices every shard runs K1's plain twin.  A mesh of
one entry is the single-device path: one gather and one K1 launch a batch.

The extender's default mesh (extender_mesh) is every visible GPU only when
the caller asked for CUDA without naming a device in a process that is not
one of several; a named device (cuda:1, FTPU_TORCH_DEVICE=cuda:1) is a mesh
of that device alone, and so is the process's own card
(utils.device.process_card) in one of several processes.

The consensus split (the device-DP chain of cns.device._dispatch_dp_batch
over a mesh, falcon_tpu's shard_map blocks in __graft_entry__.py) is three
more helpers: sharded_tb_align (K2 + K3 data-parallel over alignment
rows), sharded_cns_accumulate (K4 data-parallel over alignment tasks, each
device into a count buffer of its own, summed by sum_over_mesh, the psum),
and sharded_cns_scan (K5 + K6 split over seed groups).  Each shard launches
on its own device's current stream, and its results are copied to mesh[0]
only after its launches were queued there.  A copy between devices waits
on the source device's stream, so every shard's inputs are copied out of
mesh[0] before any shard launches: a copy queued behind the first shard's
kernels on mesh[0] would hold the other devices back until they end.
Shards on one card stay buffers of their own.
"""
import os

import numpy as np
import torch

from ..ops import cns_dp
from ..ops.align_cuda import extend_batch_cuda
from ..ops.align_device import gather_specs2_packed
from ..ops.align_tb_cuda import align_tb_batch_cuda
from ..ops.cns_dp_cuda import (accumulate_tags_planes_cuda,
                               backtrack_walk_cuda, consensus_scan_cuda)
from ..utils import trace
from ..utils.device import resolve_device
from .distributed import want_distributed


def make_mesh(n_devices=None, devices=None):
    """The 'pair' axis: a tuple of torch.devices.  By default every visible
    CUDA device (falcon_tpu's jax.devices()); devices= names them instead
    (falcon_tpu's mesh= argument), e.g. ("cpu",) * 3 or ("cuda:0",) * 2.
    The first n_devices are kept when it is given."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: torch.cuda.is_available() is "
                               "False; pass devices= to build a mesh")
        devices = range(torch.cuda.device_count())
        devs = tuple(torch.device("cuda", k) for k in devices)
    else:
        devs = tuple(_indexed(torch.device(d)) for d in devices)
    if n_devices is not None:
        devs = devs[:n_devices]
    if not devs:
        raise ValueError("make_mesh: no devices")
    return devs


def extender_mesh(device=None, devices=None):
    """The mesh a DeviceExtender shards over: make_mesh(devices=devices)
    when devices is given; else every visible GPU when the request
    (device, else FTPU_TORCH_DEVICE, else "cuda") is CUDA with no index
    and the process is not one of several; else the one device it
    resolves to (utils.device.resolve_device: under several processes a
    bare "cuda" is the process's own card)."""
    if devices is not None:
        return make_mesh(devices=devices)
    dev = resolve_device(device)
    req = device if device is not None else \
        os.environ.get("FTPU_TORCH_DEVICE", "cuda")
    if dev.type == "cuda" and torch.device(req).index is None and \
            not want_distributed():
        return make_mesh()
    return (dev,)


def _indexed(dev):
    """A CUDA device with its index made explicit (cuda -> cuda:k, the
    current one), so that equal devices compare and hash equal."""
    if dev.type == "cuda" and dev.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return dev


def shard_bounds(B, n):
    """Contiguous [lo, hi) row ranges of B rows over n mesh entries, as even
    as possible: the first B % n shards get one row more."""
    base, extra = divmod(B, n)
    bounds = []
    lo = 0
    for k in range(n):
        hi = lo + base + (k < extra)
        bounds.append((lo, hi))
        lo = hi
    return bounds


def replicate(x, mesh):
    """{device: x on it} for every distinct device of the mesh: one copy to
    each, none to the device x is on."""
    return {dev: x if x.device == dev else trace.to_device(x, dev)
            for dev in set(mesh)}


def _on(x, dev, dtype):
    """x (numpy array or tensor) as a contiguous dtype tensor on dev."""
    if isinstance(x, np.ndarray):
        x = np.ascontiguousarray(x)
    return trace.to_device(x, dev, dtype).contiguous()


def _gather(parts, mesh, B):
    """Shard results [3, b_k] concatenated in shard order on mesh[0]."""
    if not parts:
        return torch.empty((3, B), dtype=torch.int32, device=mesh[0])
    if len(parts) == 1:
        return parts[0].to(mesh[0])
    return torch.cat([p.to(mesh[0]) for p in parts], 1)


def sharded_specs_extend(mesh, words, sel, L, W, end_bonus):
    """Run one spec batch over the mesh (falcon_tpu's shard_map of the
    packed gather and the extension).

    words: the 2-bit packed block codes (int64 tensor of uint32 words,
    ops.align_device.gather_specs2_packed), replicated: either one tensor,
    copied here to each distinct device, or {device: replica} as replicate
    gives, so that a caller with many batches over one block pair copies
    once.  sel: [6, B] int32 specs (q_off, q_len, q_dir, t_off, t_len,
    t_dir), numpy or a tensor; each shard's columns go to its device in one
    copy.  Every shard gathers and runs K1 on its own device; all are
    queued before any is waited on.  Returns [3, B] int32 (i, j, d) on
    mesh[0], not waited on."""
    reps = words if isinstance(words, dict) else replicate(words, mesh)
    B = sel.shape[1]
    parts = []
    for (lo, hi), dev in zip(shard_bounds(B, len(mesh)), mesh):
        if hi == lo:
            continue
        s = _on(sel[:, lo:hi], dev, torch.int32)
        q, t = gather_specs2_packed(reps[dev], *s, L=L, fill_q=4, fill_t=5)
        parts.append(extend_batch_cuda(q, s[1], t, s[4], W=W,
                                       end_bonus=end_bonus))
    return _gather(parts, mesh, B)


def sum_over_mesh(parts, mesh):
    """falcon_tpu's psum: the partial tensors of the shards (each on any
    device of the mesh, all of one shape and dtype) added into a new
    tensor on mesh[0], in their own dtype.  A uint16 tensor (the count
    buffer) adds count by count modulo 2^16, as a psum of a uint16 array
    wraps: its int16 view is added, since two's-complement addition of 16
    bits is addition modulo 2^16.  The buffer's 32-bit words, into which
    K4 adds 1 << 16h, are never added as such: a carry out of a low count
    would land in its neighbour."""
    if not parts:
        raise ValueError("sum_over_mesh: no parts")
    dtype = parts[0].dtype
    as16 = dtype == torch.uint16

    def view(p):
        return p.view(torch.int16) if as16 else p
    acc = view(parts[0]).to(mesh[0], copy=True)
    for p in parts[1:]:
        if p.dtype != dtype or p.shape != parts[0].shape:
            raise ValueError("sum_over_mesh: parts differ in dtype or shape")
        acc += view(p).to(mesh[0])
    return acc.view(dtype) if as16 else acc


def sharded_tb_align(mesh, q, qlen, t, tlen, W, end_bonus=3):
    """K2 + K3 over the mesh (falcon_tpu's shard_map of align_tb_batch over
    'pair'): each shard's rows of the [B, L] planes (numpy arrays or
    tensors) go to its device and run align_tb_batch_cuda there, all
    shards queued before any is waited on.  Returns align_tb_batch's
    (best_i, best_j, best_d, moves [ceil(2L/4), B] uint8, bases [2L, B]
    int8) on mesh[0]; moves and bases keep the batch as their minor axis,
    so the shards concatenate on dim 1."""
    B = q.shape[0]
    shards = [(_on(q[lo:hi], dev, torch.int8),
               _on(qlen[lo:hi], dev, torch.int32),
               _on(t[lo:hi], dev, torch.int8),
               _on(tlen[lo:hi], dev, torch.int32))
              for (lo, hi), dev in zip(shard_bounds(B, len(mesh)), mesh)
              if hi > lo]
    parts = [align_tb_batch_cuda(*x, W=W, end_bonus=end_bonus)
             for x in shards]
    ends = _gather([torch.stack(p[:3]) for p in parts], mesh, B)
    moves, bases = (torch.cat([p[k].to(mesh[0]) for p in parts], 1)
                    for k in (3, 4))
    return ends[0], ends[1], ends[2], moves, bases


def sharded_cns_accumulate(mesh, G, T, D, mvp, basep, bd, gidx, s2, max_diff,
                           seeds=None, tlens=None):
    """K4 over the mesh (falcon_tpu's shard_map of accumulate_tags with a
    psum of the count buffer): the B alignment tasks (the minor axis of
    mvp [P, B] and basep [4P, B], and bd, gidx, s2 [B]; numpy arrays or
    tensors) are cut into shards; each shard's tags are folded on its
    device into a fresh count buffer of G groups (alloc_msa), and the
    buffers are summed on mesh[0] (sum_over_mesh).  The seeds' own tags
    (add_self_tags, seeds [G, T], tlens [G]) are added once, on mesh[0],
    when seeds is given.  Returns the uint16 count buffer on mesh[0]."""
    B = mvp.shape[1]
    shards = [(dev, _on(mvp[:, lo:hi], dev, torch.uint8),
               _on(basep[:, lo:hi], dev, torch.int8),
               _on(bd[lo:hi], dev, torch.int32),
               _on(gidx[lo:hi], dev, torch.int32),
               _on(s2[lo:hi], dev, torch.int32))
              for (lo, hi), dev in zip(shard_bounds(B, len(mesh)), mesh)
              if hi > lo]
    parts = [accumulate_tags_planes_cuda(cns_dp.alloc_msa(G, T, D, dev),
                                         *x, max_diff, T, D)
             for dev, *x in shards]
    msa = sum_over_mesh(parts, mesh) if parts else \
        cns_dp.alloc_msa(G, T, D, mesh[0])
    if seeds is not None:
        cns_dp.add_self_tags(msa, _on(seeds, mesh[0], torch.int8),
                             _on(tlens, mesh[0], torch.int32), T)
    return msa


def sharded_cns_scan(mesh, msa, G, T, D, min_cov):
    """K5 then K6 over the mesh, split over the G seed groups
    (falcon_tpu's shard_map of consensus_scan + backtrack + compact_emit
    over 'pair'), for any G: shard_bounds cuts the groups.  Both regions
    of the count buffer are group-major ([G, ...] flat), so a shard's
    buffer is its rows of the L0 region's [G, -1] view, then its rows of
    the Ld region's, then one zero dump slot, copied to its device; the
    flat buffer itself is never cut (that would mix groups).  Returns
    (emitted rows [G, 2T] uint8 and counts [G] int32 on mesh[0], as
    backtrack_walk_cuda gives them for all G groups on one device; the
    shards' scans, consensus_scan_cuda's outputs, each on its device)."""
    L0SZ = cns_dp.l0_size(G, T)
    m16 = msa.view(torch.int16)
    l0 = m16[:L0SZ].view(G, -1)
    ld = m16[L0SZ:L0SZ + cns_dp.ld_size(G, T, D)].view(G, -1)
    bufs = []
    for (lo, hi), dev in zip(shard_bounds(G, len(mesh)), mesh):
        if hi == lo:
            continue
        a, b = (hi - lo) * l0.shape[1], (hi - lo) * ld.shape[1]
        buf = torch.empty(a + b + 1, dtype=torch.int16, device=dev)
        buf[:a].copy_(l0[lo:hi].reshape(-1))
        buf[a:a + b].copy_(ld[lo:hi].reshape(-1))
        buf[a + b:].zero_()
        bufs.append((hi - lo, buf.view(torch.uint16)))
    rows, counts, scans = [], [], []
    for n, buf in bufs:
        scan = consensus_scan_cuda(buf, n, T, D)
        out, cnt = backtrack_walk_cuda(*scan, int(min_cov), n, T, D)
        rows.append(out)
        counts.append(cnt)
        scans.append(scan)
    return (torch.cat([r.to(mesh[0]) for r in rows]),
            torch.cat([c.to(mesh[0]) for c in counts]), scans)
