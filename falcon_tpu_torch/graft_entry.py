"""Graft entry points of the port (counterpart of __graft_entry__.py, the
JAX package's root file): the flagship kernel on one device, and the
consensus pipeline split over several.

entry(device=None)  -> (fn, example_args): K1, the batched banded
                       overlap extension (ops.align_cuda), at W 256 on the
                       example batch (8 x 512), on the card unless a CPU
                       device is asked for (then fn runs K1's plain twin).
dryrun_multichip    -> the five stages of falcon_tpu's dryrun over a mesh
                       of n devices, with its shapes, seeds and checks:
  1. K1 at W 128 data-parallel over the batch's rows, with a k-mer count
     histogram and the aligned bases summed over the mesh (sum_over_mesh,
     falcon_tpu's psum);
  2. DeviceExtender(W=64).run_specs over the mesh on self-slices of one
     flat code array;
  3. K2 + K3 at W 64 over the rows (parallel.mesh.sharded_tb_align);
  4. K4 over alignment tasks, each device into a count buffer of its own,
     summed modulo 2^16 a count (sharded_cns_accumulate), G = 2n groups of
     T = 1024 columns, D = D_DEFAULT;
  5. K5 + K6 over the seed groups (sharded_cns_scan), every group's
     consensus checked against its seed.

The mesh.  falcon_tpu builds a 2-D jax Mesh, 'pair' x 'block' ((n/2, 2)
for even n, (n, 1) for odd n), whose 'block' axis shards only the k-mer
count matrix, and splits its consensus stages over 'pair'.  Here the mesh
is the flat tuple of torch.devices that parallel.mesh.make_mesh returns,
and every stage, the k-mer sum included, is split over all of it: the
'pair' axis is the whole mesh.  So the consensus stages take G = 2n groups
where falcon_tpu takes 2 x |pair| (the same for odd n, 2n against n for
even n).  Shards are contiguous and as even as shard_bounds makes them,
so no stage needs its rows or groups to divide by n.
"""
import numpy as np
import torch

from .ops import cns_dp
from .ops.align_cuda import extend_batch_cuda
from .ops.align_device import DeviceExtender
from .parallel import mesh as pm
from .utils.device import resolve_device

KMER_BINS = 4096     # columns of the k-mer count histogram


def _example_batch(B=8, L=512, seed=0):
    rng = np.random.RandomState(seed)
    q = np.full((B, L), 4, np.int32)
    t = np.full((B, L), 5, np.int32)
    qlen = np.zeros(B, np.int32)
    tlen = np.zeros(B, np.int32)
    for b in range(B):
        n = int(L * 0.8)
        tt = rng.randint(0, 4, n)
        qq = tt.copy()
        sub = rng.rand(n) < 0.05
        qq[sub] = (qq[sub] + 1) % 4
        q[b, :n] = qq
        t[b, :n] = tt
        qlen[b] = n
        tlen[b] = n
    return q, qlen, t, tlen


def entry(device=None):
    """(fn, args): fn(q, qlen, t, tlen) runs K1 at W 256 and returns its
    [3, B] int32 (best_i, best_j, best_d); args is the example batch as
    int8 / int32 tensors on the device (utils.device.resolve_device)."""
    dev = resolve_device(device)

    def fn(q, qlen, t, tlen):
        return extend_batch_cuda(q, qlen, t, tlen, W=256)

    q, qlen, t, tlen = _example_batch()
    args = (torch.from_numpy(q).to(dev, torch.int8),
            torch.from_numpy(qlen).to(dev),
            torch.from_numpy(t).to(dev, torch.int8),
            torch.from_numpy(tlen).to(dev))
    return fn, args


def cns_inputs(G, T=1024, D=cns_dp.D_DEFAULT):
    """The consensus stages' inputs, as falcon_tpu's dryrun makes them:
    random seeds (RandomState(5)) of T - 9 bases, and 2G alignment tasks,
    two a group, each a perfect self-alignment of its group's seed (its
    move stream n consume-matches, END->START), so that the DP must emit
    seed[1:] a group.  T > 500: the keep gate needs ncols > 500
    (falcon.c:629).  Returns a dict of numpy arrays: seeds [G, T] int8,
    tlens [G] int32, mvp [T/2, 2G] uint8, q [2G, T] int8 (the JAX
    package's accumulate_tags reads the q bases), basep [2T, 2G] int8 (the
    same bases as K3 lays them out: the q base at each column that
    consumes q, else 4), bd, gidx, s2 [2G] int32, and G, T, D, max_diff."""
    rng = np.random.RandomState(5)
    seeds = rng.randint(0, 4, (G, T)).astype(np.int8)
    tlens = np.full(G, T - 9, np.int32)
    Btot = 2 * G
    S = 2 * T
    P_ = S // 4
    mv = np.full((S, Btot), 3, np.uint8)
    q = np.full((Btot, T), 4, np.int8)
    gidx = np.repeat(np.arange(G, dtype=np.int32), Btot // G)
    for b in range(Btot):
        g = gidx[b]
        n = int(tlens[g])
        mv[-n:, b] = 0          # end->start order: n consume-matches
        q[b, :n] = seeds[g, :n]
    mvp = (mv.reshape(P_, 4, Btot) * (1 << (2 * np.arange(4)))[None, :, None]
           ).sum(axis=1).astype(np.uint8)
    # START->END column k < n consumes q[k]; the rest are inactive
    basep = np.full((S, Btot), 4, np.int8)
    basep[:T] = q.T
    return dict(G=G, T=T, D=D, max_diff=np.float32(0.3), seeds=seeds,
                tlens=tlens, mvp=mvp, q=q, basep=basep,
                bd=np.zeros(Btot, np.int32), gidx=gidx,
                s2=np.zeros(Btot, np.int32))


def spec_inputs(n_devices):
    """Stage 2's inputs (RandomState(3)): one flat array of 4096 codes and
    3n self-slices of it, (offset, len) in [0, 2048) x [100, 300)."""
    rngs = np.random.RandomState(3)
    flat = rngs.randint(0, 4, 4096).astype(np.uint8)
    Nsp = 3 * n_devices
    sp_off = rngs.randint(0, 2048, Nsp).astype(np.int64)
    sp_len = rngs.randint(100, 300, Nsp).astype(np.int64)
    return flat, sp_off, sp_len


def sharded_extend_sums(mesh, q, qlen, t, tlen, kmer_counts, W=128):
    """Stage 1: K1 on each shard's rows, and on each shard's device the
    column sums of its rows of kmer_counts [B, KMER_BINS] int32 and the
    sum of its best_i + best_j, both then summed over the mesh
    (sum_over_mesh).  Returns ((i, j, d) [3, B] int32, k-mer totals
    [KMER_BINS] int32, aligned bases [] int32), all on mesh[0]."""
    B = q.shape[0]
    parts, totals, bases = [], [], []
    for (lo, hi), dev in zip(pm.shard_bounds(B, len(mesh)), mesh):
        if hi == lo:
            continue
        out = extend_batch_cuda(
            pm._on(q[lo:hi], dev, torch.int8),
            pm._on(qlen[lo:hi], dev, torch.int32),
            pm._on(t[lo:hi], dev, torch.int8),
            pm._on(tlen[lo:hi], dev, torch.int32), W=W)
        parts.append(out)
        totals.append(pm._on(kmer_counts[lo:hi], dev, torch.int32)
                      .sum(0, dtype=torch.int32))
        bases.append((out[0] + out[1]).sum(dtype=torch.int32))
    return (pm._gather(parts, mesh, B), pm.sum_over_mesh(totals, mesh),
            pm.sum_over_mesh(bases, mesh))


def run_stages(mesh, n_devices):
    """The five stages over `mesh` at the shapes falcon_tpu's dryrun takes
    for n_devices (the shapes follow n_devices, the shards the mesh, so
    that a mesh of one device runs the same work unsplit).  Returns a dict
    of every stage's outputs, tensors on mesh[0]: extend ([3, B]),
    kmer_total, aligned_bases, specs (run_specs' [3n, 3] int64 numpy),
    tb (sharded_tb_align's five), cns (cns_inputs' dict), msa (the summed
    count buffer with the seeds' own tags), rows and counts (the
    compacted consensus codes), scans (each shard's K5 outputs, on its
    device)."""
    B = 2 * n_devices  # >= one pair-batch row per device
    q, qlen, t, tlen = _example_batch(B=B, L=256)
    out = {}
    out["extend"], out["kmer_total"], out["aligned_bases"] = \
        sharded_extend_sums(mesh, q, qlen, t, tlen,
                            np.ones((B, KMER_BINS), np.int32))
    flat, sp_off, sp_len = spec_inputs(n_devices)
    ones = np.ones(len(sp_off), np.int64)
    ext = DeviceExtender(W=64, devices=mesh)
    out["specs"] = ext.run_specs(flat, sp_off, sp_len, ones, sp_off, sp_len,
                                 ones)
    out["tb"] = pm.sharded_tb_align(mesh, q, qlen, t, tlen, W=64)
    out["cns"] = c = cns_inputs(2 * n_devices)
    out["msa"] = pm.sharded_cns_accumulate(
        mesh, c["G"], c["T"], c["D"], c["mvp"], c["basep"], c["bd"],
        c["gidx"], c["s2"], c["max_diff"], seeds=c["seeds"],
        tlens=c["tlens"])
    out["rows"], out["counts"], out["scans"] = pm.sharded_cns_scan(
        mesh, out["msa"], c["G"], c["T"], c["D"], min_cov=1)
    return out


def dryrun_multichip(n_devices, devices=None):
    """Run the five stages over make_mesh(n_devices, devices) (every
    visible GPU by default; devices= names them, e.g. ("cpu",) * 3 or
    ("cuda:0",) * 2) and check them as falcon_tpu's dryrun does.  Returns
    run_stages' outputs."""
    mesh = pm.make_mesh(n_devices, devices)
    if len(mesh) != n_devices:
        raise ValueError("need %d devices, have %d" % (n_devices, len(mesh)))
    out = run_stages(mesh, n_devices)
    bi = out["extend"][0].cpu()
    if tuple(bi.shape) != (2 * n_devices,) or not (bi > 0).all():
        raise AssertionError("sharded extension produced empty alignments")
    if int(out["kmer_total"].min()) != 2 * n_devices or \
            int(out["kmer_total"].max()) != 2 * n_devices:
        raise AssertionError("k-mer counts summed over the mesh are wrong")
    r = out["specs"]
    _, _, sp_len = spec_inputs(n_devices)
    if len(r) != 3 * n_devices or (r[:, 2] != 0).any():
        raise AssertionError("sharded spec path: self-slices must align "
                             "with distance 0")
    if (r[:, 0] != sp_len).any():
        raise AssertionError("sharded spec path: self-slices must extend "
                             "to their ends")
    if not (out["tb"][0].cpu() > 0).all():
        raise AssertionError("sharded traceback produced empty alignments")
    c = out["cns"]
    rows, counts = out["rows"].cpu().numpy(), out["counts"].cpu().numpy()
    for g in range(c["G"]):
        want = "".join("ACGT"[x] for x in c["seeds"][g, 1:c["tlens"][g]])
        got = cns_dp.assemble_compacted(rows[g], int(counts[g])).upper()
        if got != want:
            raise AssertionError("sharded compacted consensus wrong for "
                                 "group %d" % g)
    return out
