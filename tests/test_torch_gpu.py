"""The port's CUDA kernels against their plain twins, on the card.

These tests need a CUDA GPU and nvcc; they skip elsewhere.  They import no
JAX, so on a machine without it run them with the repo's conftest (which
configures JAX) left out:

    python -m pytest --noconftest -m gpu tests/test_torch_gpu.py
"""
import numpy as np
import pytest
import torch

from chip_smoke import make_pairs
from falcon_tpu_torch.ops import align_cuda, align_tb_cuda
from falcon_tpu_torch.ops.align_device import extend_batch
from falcon_tpu_torch.ops.align_tb import align_tb_batch

pytestmark = pytest.mark.gpu


@pytest.fixture
def rng():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA GPU")
    return np.random.default_rng(5)


@pytest.mark.parametrize("W,L,B", [(64, 512, 24), (256, 2048, 16)])
def test_k1_matches_twin(rng, W, L, B):
    args = make_pairs(rng, B, L, W)
    n = align_cuda.LAUNCHES["extend"]
    got = align_cuda.extend_batch_cuda(*args, W=W)
    torch.cuda.synchronize()
    assert align_cuda.LAUNCHES["extend"] == n + 1
    assert torch.equal(got, extend_batch(*args, W=W))


@pytest.mark.parametrize("W,L,B", [(64, 512, 24), (256, 2048, 16)])
def test_k2_k3_match_twin(rng, W, L, B):
    args = make_pairs(rng, B, L, W)
    got = align_tb_cuda.align_tb_batch_cuda(*args, W=W)
    torch.cuda.synchronize()
    for name, g, r in zip("i j d moves bases".split(), got,
                          align_tb_batch(*args, W=W)):
        assert torch.equal(g, r), name


def test_k1_rejects_cpu_only_inputs(rng):
    q, ql, t, tl = make_pairs(rng, 8, 256, 64)
    with pytest.raises(ValueError):
        align_cuda.extend_batch_cuda(q, ql.cpu(), t, tl, W=64)
