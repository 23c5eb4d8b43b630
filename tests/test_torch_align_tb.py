"""falcon_tpu_torch.ops.align_tb (plain twin of K2 + K3) against
falcon_tpu's align_tb_batch and align_tb_batch_pallas on the CPU: bit-equal
on (i, j, d, packed moves, bases)."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from falcon_tpu.ops import align_tb as jtb
from falcon_tpu.ops.align_tb_pallas import align_tb_batch_pallas
from falcon_tpu_torch.ops import align_tb as ttb
from falcon_tpu_torch.ops.align_tb_cuda import align_tb_batch_cuda

from tests.test_torch_align_device import _edge_rows, _pairs


def _port(q, qlen, t, tlen, W):
    return [x.numpy() for x in align_tb_batch_cuda(
        torch.from_numpy(q), torch.from_numpy(qlen), torch.from_numpy(t),
        torch.from_numpy(tlen), W=W)]


@pytest.mark.parametrize("W,L,edge", [(64, 128, False), (64, 128, True),
                                      (32, 256, False)])
def test_align_tb_batch_matches_jax(W, L, edge):
    q, qlen, t, tlen = _pairs(8, L, err=0.15, seed=7)
    if edge:
        _edge_rows(q, qlen, t, tlen, seed=9)
    args = (jnp.asarray(q), jnp.asarray(qlen), jnp.asarray(t),
            jnp.asarray(tlen))
    xla = [np.asarray(x) for x in jtb.align_tb_batch(*args, W=W)]
    pal = [np.asarray(x) for x in align_tb_batch_pallas(
        *args, W=W, block_b=8, interpret=True, emit_base=True)]
    got = _port(q, qlen, t, tlen, W)
    for name, g, x in zip("i j d moves".split(), got, xla):
        np.testing.assert_array_equal(g, x, err_msg="xla " + name)
    # the Pallas kernel never scores a one-side-empty row (see
    # test_torch_align_device.test_extend_batch_edge_rows)
    rows = [b for b in range(8) if not (edge and b in (1, 2))]
    for name, g, p in zip("i j d moves bases".split(), got, pal):
        np.testing.assert_array_equal(g[..., rows], p[..., rows],
                                      err_msg="pallas " + name)


def test_moves_roundtrip():
    """unpack_moves / moves_to_alignment: the columns rebuild the end
    cell and the distance (tests/test_cns_device.py::
    test_align_tb_roundtrip), and match falcon_tpu's host functions."""
    rng = np.random.RandomState(11)
    q, qlen, t, tlen = _pairs(4, 512, err=0.2, seed=12)
    bi, bj, bd, mvp, _ = _port(q, qlen, t, tlen, 128)
    mv = ttb.unpack_moves(mvp)
    np.testing.assert_array_equal(mv, jtb.unpack_moves(mvp))
    np.testing.assert_array_equal(
        ttb.pack_moves(torch.from_numpy(mv)).numpy(), mvp)
    for b in range(4):
        qc = q[b, :qlen[b]].astype(np.uint8)
        tc = t[b, :tlen[b]].astype(np.uint8)
        qa, ta = ttb.moves_to_alignment(qc, tc, mv[:, b])
        assert (qa, ta) == jtb.moves_to_alignment(qc, tc, mv[:, b])
        assert len(qa) == len(ta) > 0
        nq = sum(1 for c in qa if c != ord("-"))
        nt = sum(1 for c in ta if c != ord("-"))
        assert (nq, nt) == (bi[b], bj[b])
        assert sum(1 for a, c in zip(qa, ta) if a != c) == bd[b]
    odd = rng.randint(0, 4, (7, 3)).astype(np.int8)
    np.testing.assert_array_equal(
        ttb.pack_moves(torch.from_numpy(odd)).numpy(),
        np.asarray(jtb.pack_moves(jnp.asarray(odd))))
