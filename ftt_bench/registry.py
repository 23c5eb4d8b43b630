"""Everything the harness knows about cells, found by name.

BENCHMARK.json at the root of the checkout names the cells; each cell's
configuration, traffic mix, limits and per-layer metrics live in files of
their own under this folder:

  configs/<config>.json    the deployment: fc_run cfg keys, consensus path
  traffic/<traffic>.json   the read set, the entry the window drives and
                           its parameters (one general generator reads it)
  limits/<cell>.json       the numbers that decide `correct`, each with its
                           limit, and the control that has to fail them
  metrics/<metric>.py      one reader per per-layer metric: read(run)
                           returns a number, or None when it finds nothing

A later cell, configuration or metric is new files plus new entries in
BENCHMARK.json; no file here changes.
"""
import importlib.util
import json
import os

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)


class Registry:
    def __init__(self, bench_dir=HERE, benchmark_json=None):
        self.dir = bench_dir
        path = benchmark_json or os.path.join(os.path.dirname(bench_dir),
                                              "BENCHMARK.json")
        with open(path) as f:
            self.spec = json.load(f)
        self._metric_mods = {}

    def _json(self, kind, name):
        path = os.path.join(self.dir, kind, name + ".json")
        if not os.path.isfile(path):
            raise KeyError("no %s file %s" % (kind, path))
        with open(path) as f:
            return json.load(f)

    def workload(self, name):
        for w in self.spec["workloads"]:
            if w["name"] == name:
                return w
        raise KeyError("no workload %r in BENCHMARK.json" % name)

    def config(self, name):
        return self._json("configs", name)

    def traffic(self, name):
        return self._json("traffic", name)

    def limits(self, cell):
        return self._json("limits", cell)

    def end_to_end(self, cell):
        """The cell's end-to-end metrics (BENCHMARK.json entries)."""
        return [m for m in self.spec["end_to_end"]
                if cell in m.get("workloads", [cell])]

    def per_layer(self, cell):
        """The per-layer metrics this cell reports: those listing it, and
        those without a list whose end-to-end metric the cell reports."""
        e2e = {m["name"] for m in self.end_to_end(cell)}
        out = []
        for m in self.spec["per_layer"]:
            if "workloads" in m:
                if cell in m["workloads"]:
                    out.append(m)
            elif m["moves"] in e2e:
                out.append(m)
        return out

    def reader(self, metric):
        """The read(run) function of metrics/<metric>.py."""
        if metric not in self._metric_mods:
            path = os.path.join(self.dir, "metrics", metric + ".py")
            if not os.path.isfile(path):
                raise KeyError("no reader %s" % path)
            spec = importlib.util.spec_from_file_location(
                "ftt_bench_metric_" + metric.replace(".", "_").replace(
                    "-", "_"), path)
            mod = importlib.util.module_from_spec(spec)
            spec.loader.exec_module(mod)
            self._metric_mods[metric] = mod
        return self._metric_mods[metric].read
