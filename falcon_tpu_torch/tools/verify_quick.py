"""Quick verification drive (counterpart of falcon_tpu's
tools/verify_quick.py): a simulated genome -> the port's whole Pipeline
-> the largest contig must reconstruct the genome (> 0.9 of its length,
> 0.99 sampled identity), and the run ends with VERIFY OK.

The same genome (seed 42), reads (seed 43) and cfg as the reference tool,
but for use_device and the device:

  --device cuda (default)  use_device = true on the card: K1 in the
                           extender, K2 + K3 in the host-MSA consensus;
                           raises without a GPU
  --device cpu             use_device = true with the kernels' plain twins
  --device host            use_device = false: the host aligner and host
                           consensus, which is the reference tool's run (it
                           hard-codes use_device = false)

The device is resolved once and handed to the Pipeline by name, so the
extender runs on that one card.  --genome-size shrinks the genome (100 kb
by default); the reads' mean length is the reference's 7 kb or a fifth of
the genome, whichever is shorter (a smaller genome of 7 kb reads gives no
contig).  The run happens in a temporary directory that is removed at
the end; the kernel launches of the run are printed beside the result.

Usage: python -m falcon_tpu_torch.tools.verify_quick [--device D]
       [--genome-size N]
"""
import argparse
import json
import os
import shutil
import sys
import tempfile
import time

from ..graph.to_contig import rc
from ..io import fasta
from ..ops import align as pyalign
from ..ops import native
from ..pipeline.driver import Pipeline
from ..utils import sim
from .common import device_of, launch_counts, launches_since, sync

CFG = """[General]
input_fofn = input.fofn
input_type = raw
genome_size = %d
seed_coverage = 15
length_cutoff = -1
length_cutoff_pr = 1000
use_device = %s
pa_DBsplit_option = -x500 -s50
ovlp_DBsplit_option = -x500 -s50
falcon_sense_option = --output-multi --min-idt 0.70 --min-cov 2 --max-n-read 1800
overlap_filtering_setting = --max-diff 100 --max-cov 100 --min-cov 1
"""


def parse_args(argv=None):
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--device", default="cuda",
                   help="cuda (default; raises without a GPU), cuda:k, cpu "
                        "(the kernels' plain twins) or host "
                        "(use_device = false)")
    p.add_argument("--genome-size", type=int, default=100000)
    return p.parse_args(argv)


def identity(contig, genome):
    """Sampled identity of the contig against the genome, the reference
    tool's way: anchor contig[500:560] exactly on either strand, then align
    2000-base windows at up to 8 offsets; None when the anchor fails."""
    al = native.align if native.available() else pyalign.align
    s = contig
    best = None
    for g in (genome, rc(genome)):
        i = g.find(s[500:560])
        if i >= 0:
            best = (g, i)
            break
    if not best:
        return None
    g, i = best
    tot_d = tot_b = 0
    for w0 in range(500, len(s) - 2500, max(1, (len(s) - 3000) // 8)):
        q = s[w0:w0 + 2000]
        t = g[i - 500 + w0: i - 500 + w0 + 2100]
        a = al(q, t, 400)
        tot_d += a.dist
        tot_b += 2000
    return 1.0 - tot_d / max(tot_b, 1)


def run(args):
    """Simulate, assemble and check; returns the result as a dict, or
    raises RuntimeError when a bar is missed."""
    host = args.device == "host"
    dev, card = device_of("cpu" if host else args.device)
    G = args.genome_size
    out = tempfile.mkdtemp(prefix="ftpu_torch_verify_")
    cwd = os.getcwd()
    try:
        os.chdir(out)
        genome = sim.random_genome(G, seed=42)
        reads = sim.simulate_reads(genome, coverage=18,
                                   mean_len=min(7000, G // 5), min_len=1500,
                                   error=0.05, seed=43)
        fasta.write_fasta("raw_reads.fa", reads, width=80)
        with open("input.fofn", "w") as f:
            f.write(os.path.abspath("raw_reads.fa") + "\n")
        with open("fc_run.cfg", "w") as f:
            f.write(CFG % (G, "false" if host else "true"))
        before = launch_counts()
        t0 = time.perf_counter()
        p_ctg = Pipeline("fc_run.cfg", ".", device=dev,
                         use_device=not host).run()
        sync(dev)
        seconds = time.perf_counter() - t0
        launches = launches_since(before)
        ctgs = list(fasta.read_fasta(p_ctg)) if p_ctg else []
    finally:
        os.chdir(cwd)
        shutil.rmtree(out, ignore_errors=True)
    if not ctgs:
        raise RuntimeError("verify_quick: no contigs")
    s = max(ctgs, key=lambda c: len(c.sequence)).sequence
    res = {"device": "host" if host else str(dev), "card": card,
           "genome_size": G, "contig": len(s), "pipeline_s": seconds,
           "launches": launches}
    if len(s) <= 0.9 * G:
        raise RuntimeError("verify_quick: contig %d of %d" % (len(s), G))
    res["identity"] = identity(s, genome)
    if res["identity"] is None:
        raise RuntimeError("verify_quick: anchor failed")
    if res["identity"] <= 0.99:
        raise RuntimeError("verify_quick: sampled identity %.5f"
                           % res["identity"])
    return res


def main(argv=None):
    res = run(parse_args(argv))
    print("contig: %d of %d" % (res["contig"], res["genome_size"]))
    print("sampled identity: %.5f" % res["identity"])
    print(json.dumps(res))
    print("VERIFY OK")
    return 0


if __name__ == "__main__":
    sys.exit(main())
