"""Every cell's files load by name, and a configuration, a cell and a
per-layer metric are added from new files and BENCHMARK.json entries
alone."""
import json
import os
import shutil

import pytest

from ftt_bench import registry

ROOT = registry.ROOT


@pytest.fixture(scope="module")
def reg():
    return registry.Registry()


def test_benchmark_json_keys(reg):
    spec = reg.spec
    assert set(spec) == {"command", "paths", "run_seconds", "configs",
                         "workloads", "end_to_end", "per_layer"}
    for c in spec["configs"]:
        assert os.path.isfile(os.path.join(ROOT, c["file"]))
    names = [m["name"] for m in spec["end_to_end"] + spec["per_layer"]]
    assert len(names) == len(set(names))


@pytest.mark.parametrize("cell", [w["name"] for w in registry.Registry()
                                  .spec["workloads"]])
def test_cell_files_load_by_name(reg, cell):
    wl = reg.workload(cell)
    config = reg.config(wl["config"])
    tr = reg.traffic(wl["traffic"])
    limits = reg.limits(cell)
    assert config["name"] == wl["config"]
    assert tr["entry"] in ("consensus", "pipeline")
    assert set(limits["checks"]) and "control" in limits
    e2e = {m["name"] for m in reg.end_to_end(cell)}
    assert "setup_s" in e2e and tr["rate_metric"] in e2e and len(e2e) >= 2
    layer = reg.per_layer(cell)
    assert layer
    for m in layer:
        assert m["moves"] in e2e
        assert callable(reg.reader(m["name"]))


def test_config_cell_and_metric_from_files_alone(tmp_path):
    """A new configuration file, a limits file and a metric reader, with
    their BENCHMARK.json entries, are found without any code change."""
    bench = tmp_path / "ftt_bench"
    shutil.copytree(registry.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "_cache",
                                                  "tests"))
    spec = json.load(open(os.path.join(ROOT, "BENCHMARK.json")))
    cfg = json.load(open(bench / "configs" / "ecoli-dp.json"))
    cfg.update(name="ecoli-dp-w128", bands={"K1": 128, "K2": 128})
    json.dump(cfg, open(bench / "configs" / "ecoli-dp-w128.json", "w"))
    shutil.copy(bench / "limits" / "ecoli-dp.consensus.json",
                bench / "limits" / "ecoli-dp-w128.consensus.json")
    (bench / "metrics" / "cns.tasks.py").write_text(
        "def read(run):\n"
        "    return float(sum(len(q) for q, _ in run.cell.tasks['K2']))\n")
    spec["configs"].append(dict(spec["configs"][0], name="ecoli-dp-w128",
                                file="ftt_bench/configs/ecoli-dp-w128.json"))
    cell = "ecoli-dp-w128.consensus"
    spec["workloads"].append({"name": cell, "config": "ecoli-dp-w128",
                              "traffic": "consensus", "chips": 1,
                              "why": "a narrower band"})
    for m in spec["end_to_end"]:
        if m["name"] == "consensus_support_bases_per_s":
            m["workloads"].append(cell)
    spec["per_layer"].append({
        "name": "cns.tasks", "unit": "tasks", "better": "higher",
        "source": "program_counter", "layer": "cns.device",
        "moves": "consensus_support_bases_per_s", "workloads": [cell]})
    json.dump(spec, open(tmp_path / "BENCHMARK.json", "w"))
    reg = registry.Registry(str(bench))
    wl = reg.workload(cell)
    assert reg.config(wl["config"])["bands"]["K2"] == 128
    assert reg.limits(cell)["checks"]
    names = [m["name"] for m in reg.per_layer(cell)]
    assert names == ["cns.tasks"]

    class Cell:
        tasks = {"K2": [([1, 2, 3], [1, 2, 3])]}

    class Run:
        cell = Cell()

    assert reg.reader("cns.tasks")(Run()) == 3.0
