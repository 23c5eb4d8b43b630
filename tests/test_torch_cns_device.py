"""The port's run_consensus_device against falcon_tpu's host-MSA device
path (DeviceCns(use_dp=False), XLA alignment on the CPU): byte-equal
preads, on the inputs of tests/test_cns_device.py plus a few more
groups."""
import io

import numpy as np

from falcon_tpu.cns import device as jdev
from falcon_tpu.cns import runner
from falcon_tpu_torch.cns import device as tdev

from tests.test_cns_device import A, noisy


def _groups():
    """test_device_consensus_quality_vs_host's group, two more with
    ranged and partial supports, and one the gates drop."""
    out = []
    for gi, (n, nsup, err, seed) in enumerate(((4000, 14, 0.12, 5),
                                               (2500, 8, 0.10, 6),
                                               (1800, 6, 0.15, 7),
                                               (900, 2, 0.10, 8))):
        rng = np.random.RandomState(seed)
        truth = rng.randint(0, 4, n).astype(np.uint8)
        seed_seq = A[truth].tobytes().decode()
        sid = "%09d" % (100 * gi)
        items = [(sid, seed_seq, None)]
        for k in range(nsup):
            if gi == 1 and k % 2:
                # support covering the seed's second half only
                part = truth[n // 2:]
                sup = A[noisy(part, err, rng)].tobytes().decode()
                rng_ = (0, len(sup), n // 2, n)
            else:
                sup = A[noisy(truth, err, rng)].tobytes().decode()
                rng_ = (0, len(sup), 0, n)
            items.append(("%09d" % (100 * gi + k + 1), sup, rng_))
        out.append((sid, items))
    return out


def test_run_consensus_device_matches_jax():
    cfg = runner.ConsensusConfig(min_cov=2, min_idt=0.70, min_n_read=4,
                                 min_cov_aln=4, output_multi=False)
    ref_out, ref_marks = io.StringIO(), []
    n_ref = jdev.run_consensus_device(
        iter(_groups()), cfg, ref_out,
        dev=jdev.DeviceCns(use_dp=False, use_pallas=False, chunk_tasks=16),
        progress_cb=ref_marks.append)
    got_out, got_marks = io.StringIO(), []
    n_got = tdev.run_consensus_device(
        iter(_groups()), cfg, got_out,
        dev=tdev.DeviceCns(device="cpu", chunk_tasks=16),
        progress_cb=got_marks.append)
    assert n_ref == 3
    assert n_got == n_ref
    assert got_out.getvalue() == ref_out.getvalue()
    assert got_marks == ref_marks


def test_align_tasks_match_jax():
    """Per-task (dist, n_cols, q_aln, t_aln) of one chunk."""
    rng = np.random.RandomState(3)
    tasks = []
    for n in (300, 700, 1500, 2100):
        t = rng.randint(0, 4, n).astype(np.uint8)
        tasks.append((noisy(t, 0.12, rng), t))
    ref = jdev.DeviceCns(use_dp=False, use_pallas=False).align_tasks(tasks)
    got = tdev.DeviceCns(device="cpu").align_tasks(tasks)
    assert got == ref
