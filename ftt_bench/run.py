"""Run one cell of the benchmark of falcon_tpu_torch once.

    python -m ftt_bench.run --workload <cell> --seed <n> --seconds <s>
        --trace <0|1>

(or python3 ftt_bench/run.py ...), from the root of a checkout.  The cell
(BENCHMARK.json) names a configuration and a traffic mix, whose files under
ftt_bench/ say what to build and which entry the window drives.  Set-up
simulates the reads from --seed, builds what the entry takes, and warms the
cell's shapes; the window then starts units of work until --seconds have
passed.  After it, the program's state is freed and the plain reference
(reference.py) judges a sample of what the window produced.

With --trace 0 the last line of standard output carries the cell's
end-to-end metrics; with --trace 1 its per-layer metrics, read from the
benchmark's own spans and the device trace of the window.  The numbers
that decide `correct` come last in that line and, each beside its limit,
as the last lines of standard error.

Without a CUDA card (or with fewer than the cell asks for), or when the
process holds jax, jaxlib, flax or falcon_tpu (whole top-level names) once
the window has closed, the run exits non-zero and prints no result.
"""
import time

T_START = time.time()

import argparse      # noqa: E402
import gc            # noqa: E402
import json          # noqa: E402
import os            # noqa: E402
import shutil        # noqa: E402
import subprocess    # noqa: E402
import sys           # noqa: E402
import tempfile      # noqa: E402

if __package__ in (None, ""):
    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))

from ftt_bench import devtrace, entries, registry   # noqa: E402
from ftt_bench.spans import Spans                   # noqa: E402

FORBIDDEN = ("jax", "jaxlib", "flax", "falcon_tpu")


def forbidden_modules(modules=None):
    """Loaded modules whose top-level name, compared whole, is one of
    FORBIDDEN (falcon_tpu_torch is not falcon_tpu)."""
    mods = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in mods} & set(FORBIDDEN))


def set_cache_dirs():
    """Every build and kernel cache at a fixed path inside the checkout
    (the port itself builds into falcon_tpu_torch/_build/)."""
    base = os.path.join(registry.HERE, "_cache")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_ext")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")


def card_info():
    """(name, power limit W, SM clock MHz) as nvidia-smi reads them, or
    None where it is absent."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.sm",
             "--format=csv,noheader,nounits"], capture_output=True,
            text=True, timeout=30).stdout.splitlines()[0]
        name, limit, clock = (x.strip() for x in out.split(","))
        return name, float(limit), float(clock)
    except (OSError, IndexError, ValueError, subprocess.SubprocessError):
        return None


class Run:
    """What the per-layer readers see: the window, its spans and device
    events, and what the benchmark counted in the window."""

    def __init__(self, cell, spans, events, w0, w1, units):
        self.cell = cell
        self.spans = spans
        self.events = events
        self.w0, self.w1 = w0, w1
        self.window_s = w1 - w0
        self.units = units


def trace_hooks(cell, spans):
    """The benchmark's spans around the port's layers, and the task counts
    of K1 and K2, for a traced window."""
    import numpy as np
    from falcon_tpu_torch.cns.device import DeviceCns
    from falcon_tpu_torch.overlap import engine
    from falcon_tpu_torch.pipeline.driver import Pipeline

    for name in ("dispatch_chunk", "dispatch_chunk_dp"):
        spans.wrap(DeviceCns, name, "cns.dispatch")
    for name in ("finish_chunk", "finish_chunk_dp"):
        spans.wrap(DeviceCns, name, "cns.finish")
    for k in (0, 1, 2):
        spans.wrap(Pipeline, "phase%d" % k, "pipeline.phase%d" % k)

    align_batches = DeviceCns._align_batches

    def counted(self, tasks):
        cell.tasks["K2"].append((
            np.fromiter((len(q) for q, _ in tasks), np.int64, len(tasks)),
            np.fromiter((len(t) for _, t in tasks), np.int64, len(tasks))))
        return align_batches(self, tasks)

    spans.replace(DeviceCns, "_align_batches", counted)

    def chained(args, kw, out):
        cell.chain.append(out[2])

    spans.wrap(engine, "chain_blocks", "overlap.chain", note=chained)

    def extended(args, kw, out):
        store, index, rids_a, cands = args[:4]
        aligner = args[5] if len(args) > 5 else kw.get("aligner")
        if aligner is None or not cands:
            return
        c = np.asarray(cands, np.int64)
        a_len = np.asarray(store.lengths, np.int64)[
            np.asarray(rids_a, np.int64)[c[:, 0]]]
        b_len = np.asarray(index.lens, np.int64)[c[:, 1]]
        qa, ta = c[:, 3], c[:, 4]
        q = np.concatenate([a_len - qa, qa])
        t = np.concatenate([b_len - ta, ta])
        cap = np.minimum(q, t) + cell.config["bands"]["K1"] // 2 + 8
        cell.tasks["K1"].append((np.minimum(q, cap), np.minimum(t, cap)))

    spans.wrap(engine, "align_candidates", "extender.align", note=extended)


def run_cell(reg, workload, seed, seconds, trace, device="cuda",
             t_start=None, cfg_override=None, require_card=True):
    """One run of a cell; returns the result object (the last line)."""
    t_start = T_START if t_start is None else t_start
    config = reg.config(workload["config"])
    tr = reg.traffic(workload["traffic"])
    limits = reg.limits(workload["name"])
    set_cache_dirs()
    os.environ["FTPU_CNS_DP"] = "1" if config["consensus_path"] == "dp" \
        else "0"
    import torch
    on_card = device != "cpu"
    if require_card and on_card and (
            not torch.cuda.is_available() or
            torch.cuda.device_count() < workload["chips"]):
        raise SystemExit("no CUDA card, or fewer than the %d the cell asks "
                         "for: nothing measured" % workload["chips"])
    workdir = tempfile.mkdtemp(prefix="ftt_bench.")
    cell = entries.Cell(workload, config, tr, limits, seed, workdir, device,
                        cfg_override)
    entry = None
    spans = Spans()
    try:
        cell.mark("start")
        entry = entries.ENTRIES[tr["entry"]](cell)
        entry.warm()
        if on_card:
            torch.cuda.synchronize()
        prof = None
        if trace:
            trace_hooks(cell, spans)
            if on_card:
                prof = devtrace.DeviceTrace(os.path.join(workdir,
                                                         "trace.json"))
                prof.__enter__()
        setup_s = time.time() - t_start
        print("setup_s %.3f: %s" % (setup_s, " ".join(
            "%s %.3f" % kv for kv in cell.setup_parts.items())),
            file=sys.stderr)
        w0 = time.time()
        win = entry.window(seconds)
        if on_card:
            torch.cuda.synchronize()
        w1 = time.time()
        events = []
        if prof is not None:
            prof.__exit__(None, None, None)
            events = devtrace.clip(prof.read(), w0, w1)
        spans.restore()
        device_info = {"platform": "gpu" if on_card else "cpu",
                       "kind": torch.cuda.get_device_name(0) if on_card
                       else "cpu",
                       "count": workload["chips"] if on_card else 0}
        if on_card:
            device_info["memory_peak_bytes"] = max(
                torch.cuda.max_memory_allocated(d)
                for d in range(torch.cuda.device_count()))
            info = card_info()
            if info:
                device_info["power_limit_w"] = info[1]
                print("card %s power_limit_w %s sm_clock_mhz %s" % info,
                      file=sys.stderr)
        entry.release()
        gc.collect()
        if on_card:
            torch.cuda.empty_cache()
        checks = entry.check()
    finally:
        spans.restore()
        if entry is not None and hasattr(entry, "cleanup"):
            entry.cleanup()
        shutil.rmtree(workdir, ignore_errors=True)

    metrics = {}
    if not trace:
        for m in reg.end_to_end(workload["name"]):
            if m["name"] == "setup_s":
                value = setup_s
            elif m["name"] == tr["rate_metric"]:
                value = win["work"] / win["elapsed"]
            else:
                continue
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        run = Run(cell, spans, events, w0, w1, win["units"])
        for m in reg.per_layer(workload["name"]):
            value = reg.reader(m["name"])(run)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        if on_card:
            busy = devtrace.union_s(events)
            device_info["busy_s"] = busy
            device_info["window_s"] = run.window_s
    limit = limits["checks"]
    correct = all(k in checks and checks[k] <= v for k, v in limit.items())
    result = {"correct": correct, "attempted": win["units"], "failed": 0,
              "metrics": metrics, "device": device_info}
    if trace and on_card:
        gaps = devtrace.idle_gaps(events, w0, w1)
        result["breakdown"] = {
            "device_ops": devtrace.top_ops(events),
            "idle_gaps": devtrace.gaps_by_span(gaps, spans.items)}
    result["checks"] = {k: {"value": checks.get(k), "limit": v}
                        for k, v in limit.items()}
    return result


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    reg = registry.Registry()
    workload = reg.workload(args.workload)
    result = run_cell(reg, workload, args.seed, args.seconds, args.trace)
    bad = forbidden_modules()
    if bad:
        print("forbidden modules loaded: %s" % ", ".join(bad),
              file=sys.stderr)
        return 3
    for k, c in result["checks"].items():
        print("check %s %r limit %r %s" % (
            k, c["value"], c["limit"],
            "ok" if c["value"] is not None and c["value"] <= c["limit"]
            else "FAIL"), file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
