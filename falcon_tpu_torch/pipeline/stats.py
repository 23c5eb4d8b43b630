"""Pre-assembly statistics report.

The reference computes read-set metrics (count/total/N50/p95/esize) for raw
reads, seed reads and preads, plus yield/fragmentation/truncation of the
error-correction step (reference: falcon_kit/stats_preassembly.py:102-273).
"""
import numpy as np

from ..io import fasta


def stats_from_lengths(lengths):
    lengths = np.sort(np.asarray(lengths, dtype=np.int64))[::-1]
    if len(lengths) == 0:
        return dict(nreads=0, total=0, n50=0, p95=0, esize=0.0)
    total = int(lengths.sum())
    csum = np.cumsum(lengths)
    n50 = int(lengths[np.searchsorted(csum, total / 2)])
    p95 = int(np.percentile(lengths, 5))  # length of the 95th pct read
    esize = float((lengths.astype(np.float64) ** 2).sum() / total)
    return dict(nreads=int(len(lengths)), total=total, n50=n50, p95=p95,
                esize=round(esize, 3))


def fragmentation_truncation(raw_store, preads_fn):
    """Mean preads-per-seed (fragmentation) and mean seed bases lost to
    correction (truncation), from the --output-multi pread naming
    "prolog/<seed><i>/<b>_<e>" (reference: stats_preassembly.py
    metric_fragmentation/metric_truncation:137-156 +
    functional.calc_metric_fragmentation/truncation:364-379)."""
    per_seed_count = {}
    per_seed_bases = {}
    for rec in fasta.read_fasta(preads_fn):
        name = rec.name
        if not name.startswith("prolog/"):
            continue
        core, region = name.split("/")[1], name.split("/")[2]
        seed = core[:-1]
        b, e = region.split("_")
        per_seed_count[seed] = per_seed_count.get(seed, 0) + 1
        per_seed_bases[seed] = per_seed_bases.get(seed, 0) + \
            (int(e) - int(b))
    if not per_seed_count:
        return -1.0, -1.0
    frag = sum(per_seed_count.values()) / len(per_seed_count)
    name_to_rid = {n: i for i, n in enumerate(raw_store.names)}
    diffs = []
    for seed, bases in per_seed_bases.items():
        rid = name_to_rid.get(seed)
        if rid is None:
            try:
                rid = int(seed)
            except ValueError:
                continue
        if rid >= len(raw_store):
            continue
        diffs.append(int(raw_store.lengths[rid]) - bases)
    trunc = (sum(diffs) / len(diffs)) if diffs else -1.0
    return round(frag, 3), round(trunc, 3)


def preassembly_report(raw_store, preads_fn, length_cutoff, genome_size):
    raw = stats_from_lengths(raw_store.lengths)
    seed_lens = raw_store.lengths[raw_store.lengths >= length_cutoff]
    seeds = stats_from_lengths(seed_lens)
    pread_lens = [len(r.sequence) for r in fasta.read_fasta(preads_fn)]
    preads = stats_from_lengths(pread_lens)
    frag, trunc = fragmentation_truncation(raw_store, preads_fn)

    report = {
        "genome_length": int(genome_size),
        "length_cutoff": int(length_cutoff),
        "raw_reads": raw["nreads"], "raw_bases": raw["total"],
        "raw_n50": raw["n50"], "raw_p95": raw["p95"],
        "raw_esize": raw["esize"],
        "raw_coverage": round(raw["total"] / genome_size, 3)
        if genome_size else 0,
        "seed_reads": seeds["nreads"], "seed_bases": seeds["total"],
        "seed_n50": seeds["n50"], "seed_p95": seeds["p95"],
        "seed_esize": seeds["esize"],
        "seed_coverage": round(seeds["total"] / genome_size, 3)
        if genome_size else 0,
        "preassembled_reads": preads["nreads"],
        "preassembled_bases": preads["total"],
        "preassembled_n50": preads["n50"],
        "preassembled_p95": preads["p95"],
        "preassembled_esize": preads["esize"],
        "preassembled_coverage": round(preads["total"] / genome_size, 3)
        if genome_size else 0,
        "preassembled_yield": round(preads["total"] / seeds["total"], 3)
        if seeds["total"] else 0,
        "preassembled_seed_fragmentation": frag,
        "preassembled_seed_truncation": trunc,
    }
    return report
