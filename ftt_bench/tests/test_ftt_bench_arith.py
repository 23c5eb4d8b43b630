"""The window's rate over whole units, the device-interval union, the idle
gaps and their naming, and the roofline arithmetic, on hand-made inputs."""
import time

import numpy as np
import pytest

from ftt_bench import devtrace, entries, roofline


def test_window_runs_whole_units():
    done = []

    def unit(k):
        time.sleep(0.03)
        done.append(k)

    k, elapsed = entries.run_units(0.07, unit)
    # units start until 0.07 s have passed: 0.00, 0.03, 0.06; the last
    # one runs to its end, and the time counts to that end
    assert k == 3 and done == [0, 1, 2]
    assert 0.09 <= elapsed < 0.2


def test_window_runs_one_unit_longer_than_the_window():
    k, elapsed = entries.run_units(0.01, lambda k: time.sleep(0.05))
    assert k == 1 and elapsed >= 0.05


EV = [("k1", 0.0, 1.0, "kernel"), ("k2", 0.5, 1.5, "kernel"),
      ("cp", 3.0, 3.5, "gpu_memcpy"), ("k1", 4.0, 4.25, "kernel")]


def test_union_counts_overlaps_once():
    assert devtrace.union_s(EV) == pytest.approx(1.5 + 0.5 + 0.25)
    assert devtrace.busy_intervals(EV) == [(0.0, 1.5), (3.0, 3.5),
                                           (4.0, 4.25)]


def test_clip_and_idle_gaps():
    ev = devtrace.clip(EV, 1.0, 5.0)
    assert devtrace.union_s(ev) == pytest.approx(0.5 + 0.5 + 0.25)
    gaps = devtrace.idle_gaps(ev, 1.0, 5.0)
    assert gaps == [(1.5, 3.0), (3.5, 4.0), (4.25, 5.0)]


def test_gaps_named_by_open_spans():
    gaps = [(1.5, 3.0), (3.5, 4.0), (4.25, 5.0)]
    spans = [("cns.dispatch", 1.0, 2.0), ("cns.finish", 1.8, 3.8)]
    got = dict(devtrace.gaps_by_span(gaps, spans))
    assert got["cns.dispatch"] == pytest.approx(0.3)
    assert got["cns.dispatch+cns.finish"] == pytest.approx(0.2)
    assert got["cns.finish"] == pytest.approx(1.0 + 0.3)
    assert got["host"] == pytest.approx(0.2 + 0.75)


def test_top_ops_and_kernel_time():
    assert devtrace.top_ops(EV, 2) == [["k1", 1.25], ["k2", 1.0]]
    assert devtrace.kernel_s(EV, ("k1",)) == pytest.approx(1.25)
    assert devtrace.kernel_s(EV, ("cp",)) == 0.0     # copies are no kernel


def brute_band_cells(q, t, W):
    n = 0
    for i in range(q + 1):
        for j in range(t + 1):
            if (i, j) == (0, 0):
                continue
            d = i - j
            if -W - 1 <= d <= W - 2 or (i, j) == (W - 1, 0):
                n += 1
    return n


@pytest.mark.parametrize("q,t,W", [(5, 7, 4), (40, 33, 8), (100, 3, 16),
                                   (3, 90, 8), (64, 64, 32)])
def test_band_cells_closed_form(q, t, W):
    assert int(roofline.band_cells(q, t, W)) == brute_band_cells(q, t, W)


def test_k2_roofline_of_hand_made_tasks():
    q = np.array([1000, 2000])
    t = np.array([1000, 2000])
    ops, nbytes = roofline.k2_work(q, t, 256)
    cells = int(roofline.band_cells(q, t, 256).sum())
    assert ops == 7 * cells
    assert nbytes == 6000 + 40 + 6000 * 64
    bound = max(ops / (64 * 132 * 1980e6), nbytes / 3.35e12)
    assert roofline.roofline_pct(ops, nbytes, 2 * bound) == \
        pytest.approx(50.0)
    assert roofline.roofline_pct(ops, nbytes, 0) is None


def test_k1_work_counts_five_ops_a_cell():
    ops, nbytes = roofline.k1_work([300], [280], 256)
    assert ops == 5 * int(roofline.band_cells(300, 280, 256))
    assert nbytes == 580 // 4 + 12


def test_spans_wrap_time_note_and_restore():
    import types
    from ftt_bench.spans import Spans

    class Layer:
        def step(self, x):
            return x + 1

    mod = types.ModuleType("mod")
    mod.double = lambda x: 2 * x
    spans, seen = Spans(), []
    spans.wrap(Layer, "step", "layer.step",
               note=lambda args, kw, out: seen.append(out))
    spans.wrap(mod, "double", "mod.double")
    assert Layer().step(1) == 2 and mod.double(3) == 6 and seen == [2]
    assert [n for n, _, _ in spans.items] == ["layer.step", "mod.double"]
    assert spans.total("layer.step") >= 0.0
    spans.restore()
    assert Layer.step.__name__ == "step" and mod.double(3) == 6
    assert len(spans.items) == 2
