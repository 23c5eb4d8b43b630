"""Simulated runs and their truth check, for smoke runs and benches of the
port.

write_sim_run lays out a pipeline run on a genome simulated with
utils.sim (reads, input.fofn, a [General] cfg in the style of
bench_e2e.py, and the truth genome).  score_assembly scores p_ctg.fa
against that truth the way tools/check_assembly.py does -- windows
anchored on the truth by an exact probe, then aligned there by the host
banded aligner -- except that the windows tile every contig end to end,
so the covered fraction of the truth is the genome recovery.
"""
import os

import numpy as np

from ..graph.to_contig import rc
from ..io import fasta
from ..ops import align as pyalign
from ..ops import native
from . import sim

CFG = """[General]
input_fofn = input.fofn
input_type = raw
use_device = true
genome_size = %d
seed_coverage = 20
length_cutoff = -1
length_cutoff_pr = 2000
pa_DBsplit_option = -x500 -s%g
ovlp_DBsplit_option = -x500 -s%g
pa_HPCdaligner_option = -v -e.70 -l1000
ovlp_HPCdaligner_option = -v -e.96 -l500
falcon_sense_option = --output-multi --min-idt 0.70 --min-cov 2 --max-n-read 400
overlap_filtering_setting = --max-diff 120 --max-cov 120 --min-cov 2
"""


def write_sim_run(out_dir, genome_size, coverage=24, mean_len=9000,
                  error=0.08, seed=1, block_mb=10):
    """Simulate a genome and its reads from `seed` and write raw_reads.fa,
    input.fofn, fc_run.cfg and genome.txt into out_dir.  Returns the
    genome string."""
    genome = sim.random_genome(genome_size, seed=seed)
    reads = sim.simulate_reads(genome, coverage=coverage, mean_len=mean_len,
                               min_len=2000, error=error, seed=seed + 1,
                               fast=True)
    fasta.write_fasta(os.path.join(out_dir, "raw_reads.fa"), reads, width=0)
    with open(os.path.join(out_dir, "input.fofn"), "w") as f:
        f.write("raw_reads.fa\n")
    with open(os.path.join(out_dir, "fc_run.cfg"), "w") as f:
        f.write(CFG % (genome_size, block_mb, block_mb))
    with open(os.path.join(out_dir, "genome.txt"), "w") as f:
        f.write(genome)
    return genome


def score_assembly(p_ctg, genome, win_len=5000, probe=60):
    """Contig count and sizes, genome recovery (fraction of the truth
    covered by anchored contig windows) and identity (mean and median
    over the windows) of p_ctg against the truth genome."""
    al = native.align if native.available() else pyalign.align
    G = len(genome)
    grc = rc(genome)
    ctgs = sorted((r.sequence for r in fasta.read_fasta(p_ctg)),
                  key=lambda s: -len(s))
    covered = np.zeros(G, dtype=bool)
    idts = []
    n_unanchored = 0
    for s in ctgs:
        for w0 in range(0, max(1, len(s) - probe), win_len):
            hit = None
            # shift the probe past a contig error, up to 4 tries
            for k in range(4):
                p = s[w0 + k * probe:w0 + (k + 1) * probe]
                if len(p) < probe:
                    break
                for src in (genome, grc):
                    pos = src.find(p)
                    if pos >= 0:
                        hit = (src, pos - k * probe)
                        break
                if hit:
                    break
            if hit is None or hit[1] < 0:
                n_unanchored += 1
                continue
            src, pos = hit
            L = min(win_len, len(s) - w0, len(src) - pos)
            a = al(s[w0:w0 + L], src[pos:pos + L + max(200, L // 10)],
                   1500, False)
            if a.aln_str_size > 0.5 * L:
                idts.append(1.0 - a.dist / max(1, a.aln_str_size))
            if src is genome:
                covered[pos:pos + L] = True
            else:
                covered[G - pos - L:G - pos] = True
    return {
        "n_contigs": len(ctgs),
        "total_contig_bases": sum(len(s) for s in ctgs),
        "largest_contig": len(ctgs[0]) if ctgs else 0,
        "genome_size": G,
        "recovery": float(covered.mean()),
        "windows": len(idts),
        "unanchored_windows": n_unanchored,
        "mean_identity": float(np.mean(idts)) if idts else None,
        "median_identity": float(np.median(idts)) if idts else None,
    }
