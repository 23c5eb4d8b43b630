"""Score an assembly against its simulation truth genome (counterpart of
falcon_tpu's tools/check_assembly.py; the same arguments, probes, window
sampling and JSON).

Reports: contig count/lengths and sampled identity (banded alignment of
contig windows at their anchored truth positions; window target starts
exactly at the anchor).  The reference's docstring promises a genome
recovery too, which it computes and never prints; the port computes none
(utils.simcheck.score_assembly gives one).

The scoring is host code (ops.native.align, or ops.align.align when the
C++ library is absent) on every device.  --device is resolved all the
same, as every tool of the port resolves it, so the tool raises on a
machine without a GPU unless it is given --device cpu.  Not a verbatim
copy of falcon_tpu's tool (so not in the copies the tests compare line for
line): it adds --device and has no sys.path preamble; tests/
test_torch_tools.py holds its JSON equal to the reference tool's.

Usage: python -m falcon_tpu_torch.tools.check_assembly <p_ctg.fa>
       <genome.txt|fa> [--windows N] [--win-len L] [--device D]
"""
import argparse
import json
import sys

import numpy as np

from ..graph.to_contig import rc
from ..io import fasta
from ..ops import align as pyalign
from ..ops import native
from .common import add_device_arg, device_of


def load_genome(path):
    if path.endswith((".fa", ".fasta")):
        return "".join(r.sequence for r in fasta.read_fasta(path))
    with open(path) as f:
        return f.read().strip()


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("p_ctg")
    p.add_argument("genome")
    p.add_argument("--windows", type=int, default=64)
    p.add_argument("--win-len", type=int, default=5000)
    add_device_arg(p, "; the scoring is host code on either")
    return p.parse_args(argv)


def run(args):
    """The score of args.p_ctg against args.genome, as a dict with the
    reference tool's keys."""
    device_of(args.device)
    al = native.align if native.available() else pyalign.align

    genome = load_genome(args.genome)
    G = len(genome)
    grc = rc(genome)
    ctgs = sorted(fasta.read_fasta(args.p_ctg),
                  key=lambda r: -len(r.sequence))
    total_ctg = sum(len(c.sequence) for c in ctgs)

    idts = []
    n_anchor_fail = 0
    rng = np.random.RandomState(7)
    for c in ctgs:
        s = c.sequence
        # anchor the contig's span on the truth with probes at both ends
        # + sampled interior windows
        n_win = max(2, min(args.windows, len(s) // args.win_len))
        starts = sorted(set(
            [100, max(0, len(s) - args.win_len - 100)] +
            list(rng.randint(0, max(1, len(s) - args.win_len),
                             n_win))))
        for w0 in starts:
            probe = s[w0:w0 + 60]
            if len(probe) < 60:
                continue
            pos, src = -1, None
            for g in (genome, grc):
                pos = g.find(probe)
                if pos >= 0:
                    src = g
                    break
            if pos < 0:
                n_anchor_fail += 1
                continue
            L = min(args.win_len, len(s) - w0, len(src) - pos)
            a = al(s[w0:w0 + L], src[pos:pos + L + max(200, L // 10)],
                   1500, False)
            if a.aln_str_size > 0.5 * L:
                idts.append(1.0 - a.dist / max(1, a.aln_str_size))
    return {
        "n_contigs": len(ctgs),
        "total_contig_bases": total_ctg,
        "largest_contig": len(ctgs[0].sequence) if ctgs else 0,
        "genome_size": G,
        "largest_over_genome": round(
            len(ctgs[0].sequence) / G, 4) if ctgs else 0,
        "total_over_genome": round(total_ctg / G, 4),
        "sampled_windows": len(idts),
        "anchor_failures": n_anchor_fail,
        "median_identity": round(float(np.median(idts)), 5) if idts
        else None,
        "mean_identity": round(float(np.mean(idts)), 5) if idts
        else None,
    }


def main(argv=None):
    print(json.dumps(run(parse_args(argv))))
    return 0


if __name__ == "__main__":
    sys.exit(main())
