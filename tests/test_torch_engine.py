"""The port's make_device_aligner against falcon_tpu's on the CPU: the same
overlap table, field for field, on a simulated block pair -- once within
one block and once across two blocks."""
import os

import numpy as np
import pytest

from falcon_tpu.io import readstore
from falcon_tpu.overlap import engine
from falcon_tpu.utils import sim
from falcon_tpu_torch.overlap.engine import make_device_aligner


@pytest.fixture(scope="module")
def store(tmp_path_factory):
    g = sim.random_genome(24_000, seed=31)
    reads = sim.simulate_reads(g, coverage=8, mean_len=3000, min_len=1000,
                               error=0.08, seed=32)
    fa = os.path.join(tmp_path_factory.mktemp("engine"), "r.fasta")
    with open(fa, "w") as f:
        for i, (_, r) in enumerate(reads):
            f.write(">r%d\n%s\n" % (i, r))
    return readstore.ReadStore.from_fasta_files([fa])


@pytest.mark.parametrize("pair", [(0, 0), (0, 1)])
def test_device_aligner_matches_jax(store, monkeypatch, pair):
    monkeypatch.setenv("FTPU_USE_PALLAS", "0")     # JAX on the CPU: XLA
    params = engine.OverlapParams(min_overlap=500)
    blocks = store.split_blocks(block_bases=100_000)
    assert len(blocks) >= 2
    a, b = blocks[pair[0]], blocks[pair[1]]
    ref = engine.overlap_blocks(store, a, b, params,
                                aligner=engine.make_device_aligner(W=256))
    aligner = make_device_aligner(W=256, device="cpu")
    got = engine.overlap_blocks(store, a, b, params, aligner=aligner)
    assert len(ref) > 10
    assert got.dtype == ref.dtype and len(got) == len(ref)
    for name in ref.dtype.names:
        np.testing.assert_array_equal(got[name], ref[name], err_msg=name)
    assert 0 < aligner.ext.occupancy() < 1
