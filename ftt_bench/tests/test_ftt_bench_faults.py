"""Whole runs on the CPU at toy size, past the harness's look for a card:
the sound program comes out `correct`; the cell's control (limits/<cell>
.json: the program with a guarantee of the configuration broken) and each
fault the cell can have, planted underneath the timed path, come out not
`correct`.  The faults: a step that returns its state unchanged, half of
the batch left out, an answer altered where it is produced, and (the
consensus cells) each pread cut short, as a DP that stops early.  (No cell
crosses chips, so none can leave out an exchange between them.)"""
import numpy as np
import pytest

from ftt_bench import entries, run
from ftt_bench.tests.tiny import card_assembly_registry, toy_registry

ON_CARD = "ecoli-dp.assembly-1mb"


@pytest.fixture(scope="module")
def regs(tmp_path_factory):
    return {"cpu": toy_registry(str(tmp_path_factory.mktemp("toy"))),
            "cuda": card_assembly_registry(
                str(tmp_path_factory.mktemp("card")))}


@pytest.fixture
def where(request, regs, monkeypatch):
    """(registry, device) for the cell: the card for the assembly cell
    (skipped without one), the CPU twins for the others."""
    cell = request.node.callspec.params["cell"]
    if cell == ON_CARD:
        import torch
        if not torch.cuda.is_available():
            pytest.skip("a whole assembly runs on the card")
        return regs["cuda"], "cuda"
    import torch
    # the twins beside other busy workers thrash on OpenMP threads
    threads = torch.get_num_threads()
    torch.set_num_threads(2)
    request.addfinalizer(lambda: torch.set_num_threads(threads))
    monkeypatch.setenv("FTPU_TORCH_DEVICE", "cpu")
    monkeypatch.setenv("FTPU_CNS_CHUNK_TASKS", "256")
    monkeypatch.setattr(entries.ConsensusEntry, "WARM_GROUPS", 2)
    return regs["cpu"], "cpu"


def _alter(s):
    b = bytearray(s.encode())
    for i in range(0, len(b), 40):
        b[i] = ord("A") if b[i] != ord("A") else ord("C")
    return b.decode()


def cns_fault(monkeypatch, kind):
    from falcon_tpu_torch.cns.device import DeviceCns
    for name in ("finish_chunk", "finish_chunk_dp"):
        orig = getattr(DeviceCns, name)

        def finish(self, state, _orig=orig):
            out = _orig(self, state)
            if kind == "unchanged":
                return [(sid, seq) for sid, seq, _ in state[0]]
            if kind == "half":
                return [(sid, c if k % 2 else "")
                        for k, (sid, c) in enumerate(out)]
            if kind == "truncated":
                return [(sid, c[:len(c) * 7 // 10]) for sid, c in out]
            return [(sid, _alter(c)) for sid, c in out]

        monkeypatch.setattr(DeviceCns, name, finish)


def overlap_fault(monkeypatch, kind):
    from falcon_tpu_torch.overlap import engine, table
    orig = engine.align_candidates

    def align(store, index, rids_a, cands, params, aligner=None):
        if kind == "unchanged":
            return table.empty(0)
        if kind == "half":
            return orig(store, index, rids_a, cands[::2], params, aligner)
        out = orig(store, index, rids_a, cands, params, aligner)
        out["b_id"] = (out["b_id"] + 1) % len(store)
        return out

    monkeypatch.setattr(engine, "align_candidates", align)


def contig_fault(monkeypatch, kind):
    from falcon_tpu_torch.pipeline.driver import Pipeline
    if kind == "unchanged":
        return cns_fault(monkeypatch, "unchanged")
    orig = Pipeline.phase2

    def phase2(self, ovl_fn):
        path = orig(self, ovl_fn)        # p_ctg.fa, the graph's product
        with open(path) as f:
            lines = f.read().split("\n")
        for i, ln in enumerate(lines):
            if ln and not ln.startswith(">"):
                lines[i] = ln[:len(ln) // 2] if kind == "half" \
                    else _alter(ln)
        with open(path, "w") as f:
            f.write("\n".join(lines))
        return path

    monkeypatch.setattr(Pipeline, "phase2", phase2)


CELLS = {"ecoli-dp.consensus": cns_fault,
         "ecoli-hostmsa.consensus": cns_fault,
         "ecoli-dp.raw-overlap": overlap_fault,
         ON_CARD: contig_fault}
PARAMS = [pytest.param(c, marks=pytest.mark.gpu) if c == ON_CARD else c
          for c in sorted(CELLS)]


def one_run(where, cell, override=None, seed=2 ** 31 + 11):
    reg, device = where
    return run.run_cell(reg, reg.workload(cell), seed, 0.5, 0,
                        device=device, require_card=False,
                        cfg_override=override)


@pytest.mark.parametrize("cell", PARAMS)
def test_sound_run_is_correct(where, cell):
    res = one_run(where, cell)
    assert res["correct"], res["checks"]
    assert set(res["metrics"]) == {m["name"]
                                   for m in where[0].end_to_end(cell)}
    assert all(np.isfinite(m["value"]) and m["value"] > 0
               for m in res["metrics"].values())


@pytest.mark.parametrize("cell", PARAMS)
def test_control_is_not_correct(where, cell):
    res = one_run(where, cell, where[0].limits(cell)["control"])
    assert not res["correct"], res["checks"]


FAULTS = [pytest.param(c, k, marks=pytest.mark.gpu) if c == ON_CARD else (c, k)
          for c in sorted(CELLS)
          for k in ["unchanged", "half", "altered"] +
          (["truncated"] if CELLS[c] is cns_fault else [])]


@pytest.mark.parametrize("cell,kind", FAULTS)
def test_planted_fault_is_not_correct(where, cell, kind, monkeypatch):
    CELLS[cell](monkeypatch, kind)
    res = one_run(where, cell)
    assert not res["correct"], res["checks"]
    if kind == "truncated":
        # exact where it lands: only the uncovered share catches it
        err = res["checks"]["pread_error"]
        assert err["value"] <= err["limit"], res["checks"]
