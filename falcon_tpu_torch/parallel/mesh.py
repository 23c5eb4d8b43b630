"""Multi-GPU data parallelism for the overlap engine (port of
falcon_tpu/parallel/mesh.py).

falcon_tpu shards extension batches over a 1-D "pair" mesh with
jax.shard_map: every device runs the banded extension kernel on its shard
and the host gathers the (i, j, d) results.  Here the mesh is a tuple of
torch.devices and the shard_map is written out: a batch's rows are cut
into contiguous shards, one per mesh entry, every shard is queued on its
own device's current stream before any is waited on, and the results are
concatenated in shard order on the mesh's first device.

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
"""
import os

import numpy as np
import torch

from ..ops.align_cuda import extend_batch_cuda
from ..ops.align_device import gather_pad2, gather_specs2_packed, pack_tasks
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
    return {dev: x if x.device == dev else x.to(dev) for dev in set(mesh)}


def _on(x, dev, dtype):
    """x (numpy array or tensor) as a contiguous dtype tensor on dev."""
    if isinstance(x, np.ndarray):
        x = torch.from_numpy(np.ascontiguousarray(x))
    return x.to(dev, dtype).contiguous()


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


def sharded_tasks_extend(mesh, tasks, chunk, L, W, end_bonus):
    """Run one batch of (q_codes, t_codes) tasks over the mesh (falcon_tpu's
    DeviceExtender.run over its mesh).  The rows `chunk` (indices into
    tasks) are cut into contiguous shards; each shard's codes are packed on
    the host into one flat buffer (ops.align_device.pack_tasks), copied to
    its device, padded there to [b, L] planes (gather_pad2) and run through
    K1.  Every shard is queued before any is waited on.  Returns
    [3, len(chunk)] int32 (i, j, d) on mesh[0], not waited on."""
    B = len(chunk)
    parts = []
    for (lo, hi), dev in zip(shard_bounds(B, len(mesh)), mesh):
        if hi == lo:
            continue
        cat, qo, ql, to, tl = pack_tasks(tasks, chunk[lo:hi], hi - lo, L)
        cat = _on(cat, dev, torch.int8)
        qo, ql, to, tl = (_on(x, dev, torch.int32) for x in (qo, ql, to, tl))
        q, t = gather_pad2(cat, qo, ql, to, tl, L, 4, 5)
        parts.append(extend_batch_cuda(q, ql, t, tl, W=W,
                                       end_bonus=end_bonus))
    return _gather(parts, mesh, B)


class ShardedExtender:
    """Data-parallel front end over K1 (falcon_tpu's ShardedExtender) for
    host-padded batches: one contiguous shard of rows per mesh entry, no
    padding of B."""

    def __init__(self, mesh=None, W=512, end_bonus=3):
        self.mesh = mesh or make_mesh()
        self.W = W
        self.end_bonus = end_bonus
        self.n_dev = len(self.mesh)

    def launch(self, q, qlen, t, tlen):
        """q/t: [B, L] codes (q padded with 4, t with 5), qlen/tlen: [B];
        numpy arrays or tensors on any device.  Queues every shard and
        returns [3, B] int32 (i, j, d) on mesh[0], not waited on."""
        B = q.shape[0]
        parts = []
        for (lo, hi), dev in zip(shard_bounds(B, self.n_dev), self.mesh):
            if hi == lo:
                continue
            parts.append(extend_batch_cuda(
                _on(q[lo:hi], dev, torch.int8),
                _on(qlen[lo:hi], dev, torch.int32),
                _on(t[lo:hi], dev, torch.int8),
                _on(tlen[lo:hi], dev, torch.int32),
                W=self.W, end_bonus=self.end_bonus))
        return _gather(parts, self.mesh, B)

    def extend(self, q, qlen, t, tlen):
        """As launch, waited on: numpy arrays (i, j, d) of length B."""
        out = self.launch(q, qlen, t, tlen).cpu().numpy()
        return out[0], out[1], out[2]
