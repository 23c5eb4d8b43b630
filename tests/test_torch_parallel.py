"""falcon_tpu_torch.parallel.mesh (multi-device sharding of K1's batches)
against falcon_tpu.parallel.mesh on the CPU: the port's mesh of three CPU
devices, falcon_tpu's virtual 8-device CPU mesh (tests/conftest.py), the
same inputs, bit-equal (i, j, d); and DeviceExtender over a mesh against
DeviceExtender on one device."""
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from falcon_tpu.ops import align_device as jad
from falcon_tpu.parallel import mesh as jmesh
from falcon_tpu_torch.ops import align_cuda
from falcon_tpu_torch.ops.align_device import DeviceExtender, pack_flat_2bit
from falcon_tpu_torch.parallel import mesh as tmesh

from tests.test_parallel import mk

CPU3 = ("cpu",) * 3


def _jax_mesh():
    if len(jax.devices()) < 2:
        pytest.skip("needs falcon_tpu's virtual multi-device CPU mesh "
                    "(tests/conftest.py)")
    return jmesh.make_mesh()


def test_make_mesh_and_shards():
    mesh = tmesh.make_mesh(devices=CPU3)
    assert mesh == (torch.device("cpu"),) * 3
    assert tmesh.make_mesh(n_devices=2, devices=CPU3) == mesh[:2]
    assert tmesh.shard_bounds(13, 3) == [(0, 5), (5, 9), (9, 13)]
    assert tmesh.shard_bounds(2, 3) == [(0, 1), (1, 2), (2, 2)]
    assert tmesh.shard_bounds(0, 2) == [(0, 0), (0, 0)]
    with pytest.raises(ValueError):
        tmesh.make_mesh(devices=())


@pytest.mark.parametrize("B,L,seed", [(40, 512, 0), (13, 256, 3)])
def test_sharded_extender_matches_jax(B, L, seed):
    """ShardedExtender.extend over three CPU devices against falcon_tpu's
    over its eight (XLA extension): 40 rows (14/13/13 here, 5 a device
    there) and 13 rows (5/4/4 here; falcon_tpu pads to 16)."""
    q, qlen, t, tlen = mk(B, L, seed=seed)
    ref = jmesh.ShardedExtender(mesh=_jax_mesh(), W=128,
                                use_pallas=False).extend(q, qlen, t, tlen)
    got = tmesh.ShardedExtender(tmesh.make_mesh(devices=CPU3),
                                W=128).extend(q, qlen, t, tlen)
    for name, g, r in zip("ijd", got, ref):
        np.testing.assert_array_equal(g, np.asarray(r), err_msg=name)
    assert got[0].shape == (B,)
    # CPU shards run the twin: no kernel launch is counted
    assert "cpu" not in align_cuda.BY_DEVICE


def _spec_batch(B, L, seed):
    """A flat code array of B (q, t) read pairs and their extension specs,
    forward and backward (dir -1 reads a slice reversed), lengths in
    [L/4, L]: (flat uint8, sel [6, B] int32)."""
    q, qlen, t, tlen = mk(B, L, err=0.1, seed=seed)
    rng = np.random.RandomState(seed + 1)
    parts, sel, off = [], np.zeros((6, B), np.int32), 0
    for b in range(B):
        n = int(rng.randint(L // 4, qlen[b] + 1))
        d = 1 if b % 2 == 0 else -1
        for k, seq in ((0, q[b, :n]), (3, t[b, :n])):
            parts.append(seq.astype(np.uint8))
            sel[k:k + 3, b] = (off if d == 1 else off + n - 1, n, d)
            off += n
    return np.concatenate(parts), sel


@pytest.mark.parametrize("B", [24, 13])
def test_sharded_specs_extend_matches_jax(B):
    """sharded_specs_extend over three CPU devices against falcon_tpu's
    over its eight, on the same packed words and specs (falcon_tpu's
    shard_map wants B a multiple of its eight devices: its batch is padded
    with empty rows, the port's is not)."""
    L = 256
    flat, sel = _spec_batch(B, L, seed=5)
    words = pack_flat_2bit(flat)
    wl = 1 << int(np.ceil(np.log2(max(len(words), 2))))
    words_p = np.zeros(wl, np.uint32)
    words_p[:len(words)] = words
    Bp = -(-B // 8) * 8
    sel_p = np.zeros((6, Bp), np.int32)
    sel_p[:, :B] = sel
    ref = jmesh.sharded_specs_extend(_jax_mesh(), jnp.asarray(words_p),
                                     jnp.asarray(sel_p), L, 128, 3, False)
    ref = np.stack([np.asarray(x)[:B] for x in ref])
    mesh = tmesh.make_mesh(devices=CPU3)
    got = tmesh.sharded_specs_extend(
        mesh, torch.from_numpy(words.astype(np.int64)), sel, L, 128, 3)
    assert got.dtype == torch.int32 and got.shape == (3, B)
    np.testing.assert_array_equal(got.numpy(), ref)
    # replicas handed in give the same batch
    reps = tmesh.replicate(torch.from_numpy(words.astype(np.int64)), mesh)
    assert list(reps) == [torch.device("cpu")]
    again = tmesh.sharded_specs_extend(mesh, reps, torch.from_numpy(sel),
                                       L, 128, 3)
    assert torch.equal(again, got)


def test_device_extender_over_a_mesh_matches_one_device():
    """DeviceExtender.run_specs and run over a three-CPU mesh equal the
    one-device runs, task by task, and count each task's cells once."""
    flat, sel = _spec_batch(30, 512, seed=9)
    one = DeviceExtender(W=128, device="cpu")
    three = DeviceExtender(W=128, device="cpu", devices=CPU3)
    assert len(one.mesh) == 1 and len(three.mesh) == 3
    ref = one.run_specs(flat, *sel)
    got = three.run_specs(flat, *sel)
    np.testing.assert_array_equal(got, ref)
    assert (three.cells_issued, three.cells_useful) == \
        (one.cells_issued, one.cells_useful)
    tasks = []
    for b in range(0, 30, 2):             # the forward specs
        q0, n, d = sel[0:3, b]
        t0, m, _ = sel[3:6, b]
        tasks.append((flat[q0:q0 + n], flat[t0:t0 + m]))
    np.testing.assert_array_equal(three.run(tasks), one.run(tasks))
    # and falcon_tpu's extender (on its eight-device mesh) on the same tasks
    jref = jad.DeviceExtender(W=128, use_pallas=False).run(tasks)
    np.testing.assert_array_equal(one.run(tasks), np.asarray(jref))


FAKE_GPUS = tuple(torch.device("cuda", k) for k in range(3))


@pytest.mark.parametrize("device,env,want", [
    (None, None, FAKE_GPUS), ("cuda", None, FAKE_GPUS),
    (None, "cuda", FAKE_GPUS), ("cuda:1", None, FAKE_GPUS[1:2]),
    (torch.device("cuda", 1), None, FAKE_GPUS[1:2]),
    (None, "cuda:2", FAKE_GPUS[2:]), ("cpu", "cuda", (torch.device("cpu"),)),
])
def test_extender_mesh_takes_every_gpu_only_when_none_is_named(
        device, env, want, monkeypatch):
    """On a (faked) three-GPU host the extender shards over every GPU only
    when CUDA was asked for without an index; a named device, by argument
    or FTPU_TORCH_DEVICE, is a mesh of that device alone; devices= wins."""
    def resolve(d=None):
        d = torch.device(d if d is not None else
                         os.environ.get("FTPU_TORCH_DEVICE", "cuda"))
        return torch.device("cuda", d.index or 0) if d.type == "cuda" else d

    real = tmesh.make_mesh
    monkeypatch.setattr(tmesh, "resolve_device", resolve)
    monkeypatch.setattr(tmesh, "make_mesh", lambda n_devices=None,
                        devices=None: FAKE_GPUS if devices is None
                        else real(n_devices, devices))
    if env is None:
        monkeypatch.delenv("FTPU_TORCH_DEVICE", raising=False)
    else:
        monkeypatch.setenv("FTPU_TORCH_DEVICE", env)
    assert DeviceExtender(W=128, device=device).mesh == want
    assert DeviceExtender(W=128, device=device, devices=CPU3).mesh == \
        (torch.device("cpu"),) * 3


def _fake_gpus(monkeypatch, n):
    """torch.cuda as a host with n GPUs shows it, cuda:0 current."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "fake GPU")


@pytest.mark.parametrize("n,pid,device,env,want", [
    (4, 0, None, None, "cuda:0"), (4, 1, None, None, "cuda:1"),
    (4, 6, None, None, "cuda:2"), (4, 3, "cuda", None, "cuda:3"),
    (4, 5, None, "cuda", "cuda:1"), (1, 1, None, None, "cuda:0"),
    (4, 1, "cuda:0", None, "cuda:0"), (4, 2, None, "cuda:3", "cuda:3"),
    (4, 1, "cpu", None, "cpu"),
])
def test_each_process_takes_its_own_card(n, pid, device, env, want,
                                         monkeypatch):
    """On a (faked) host with n GPUs, a process launched as one of several
    (FTPU_COORDINATOR_ADDRESS, FTPU_PROCESS_ID) resolves a bare cuda to
    cuda:(pid % n), and its extender's mesh is that card alone; on a
    one-card host every process takes cuda:0; a named device wins."""
    from falcon_tpu_torch.utils.device import resolve_device
    _fake_gpus(monkeypatch, n)
    monkeypatch.setenv("FTPU_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("FTPU_NUM_PROCESSES", "8")
    monkeypatch.setenv("FTPU_PROCESS_ID", str(pid))
    if env is None:
        monkeypatch.delenv("FTPU_TORCH_DEVICE", raising=False)
    else:
        monkeypatch.setenv("FTPU_TORCH_DEVICE", env)
    assert resolve_device(device) == torch.device(want)
    assert DeviceExtender(W=128, device=device).mesh == (torch.device(want),)


@pytest.mark.parametrize("device", [None, "cuda"])
def test_one_process_shards_over_every_gpu(device, monkeypatch):
    """Without the process variables a bare cuda is the current card and
    the extender's mesh is every (faked) GPU."""
    from falcon_tpu_torch.utils.device import resolve_device
    _fake_gpus(monkeypatch, 4)
    for key in ("FTPU_COORDINATOR_ADDRESS", "FTPU_PROCESS_ID",
                "FTPU_TORCH_DEVICE"):
        monkeypatch.delenv(key, raising=False)
    assert resolve_device(device) == torch.device("cuda", 0)
    assert DeviceExtender(W=128, device=device).mesh == tuple(
        torch.device("cuda", k) for k in range(4))


@pytest.mark.parametrize("n,num,warned", [(4, 4, False), (4, 2, False),
                                          (4, 8, True), (1, 2, True)])
def test_process_card_warns_when_processes_can_share_a_card(
        n, num, warned, monkeypatch, caplog):
    """process_card warns, once a process, exactly when there are more
    processes (FTPU_NUM_PROCESSES) than visible GPUs, so that two processes
    of a host may land on one card."""
    import logging

    from falcon_tpu_torch.utils import device as udev
    _fake_gpus(monkeypatch, n)
    monkeypatch.setattr(udev, "_logged", set())
    monkeypatch.setenv("FTPU_COORDINATOR_ADDRESS", "127.0.0.1:1")
    monkeypatch.setenv("FTPU_NUM_PROCESSES", str(num))
    monkeypatch.setenv("FTPU_PROCESS_ID", "1")
    with caplog.at_level(logging.INFO, logger=udev.LOG.name):
        assert udev.process_card() == torch.device("cuda", 1 % n)
        udev.process_card()
    warnings = [r for r in caplog.records if r.levelno == logging.WARNING]
    assert len(warnings) == int(warned)
