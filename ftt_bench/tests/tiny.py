"""A copy of the benchmark's files with every read set cut to toy size,
for driving whole runs on the CPU (the port's plain twins), and a smaller
copy of the assembly cell for the card, where a whole assembly of a toy
genome is too thin to come out right."""
import json
import os
import shutil

from ftt_bench import registry

TOY = {"consensus": 12000, "raw-overlap": 12000, "assembly-1mb": 16000}


def toy_registry(root):
    bench = os.path.join(root, "ftt_bench")
    shutil.copytree(registry.HERE, bench,
                    ignore=shutil.ignore_patterns("__pycache__", "_cache",
                                                  "tests"))
    shutil.copy(os.path.join(registry.ROOT, "BENCHMARK.json"), root)
    for name in os.listdir(os.path.join(bench, "traffic")):
        path = os.path.join(bench, "traffic", name)
        with open(path) as f:
            tr = json.load(f)
        gs = TOY[name[:-5]]
        # reads of 1-2.5 kb keep every DP bucket at T <= 4096, where
        # the plain twins are quick
        tr["reads"].update(genome_size=gs, mean_len=1600, min_len=900)
        tr.setdefault("cfg", {}).update(
            genome_size=gs, length_cutoff=-1, length_cutoff_pr=800,
            pa_DBsplit_option="-x500 -s0.15",
            ovlp_DBsplit_option="-x500 -s0.15",
            pa_HPCdaligner_option="-v -e.70 -l500")
        tr.update(warm_genome_size=4000, min_overlap=500,
                  warm_cfg={"genome_size": 4000,
                            "pa_DBsplit_option": "-x500 -s0.05",
                            "ovlp_DBsplit_option": "-x500 -s0.05"})
        if tr["entry"] == "pipeline" and tr["target"] == "overlapping":
            # no DP here: reads of 1.5-5 kb keep the cell's own -l1000
            # and its check of true overlaps of 1500 bases
            tr["reads"].update(mean_len=3000, min_len=1500)
            del tr["cfg"]["pa_HPCdaligner_option"]
        with open(path, "w") as f:
            json.dump(tr, f)
    return registry.Registry(bench)


def card_assembly_registry(root, genome_size=400000):
    """The assembly cell on a genome of genome_size with the cell's own
    reads (9 kb mean), blocks cut to keep 6 block pairs."""
    reg = toy_registry(root)
    path = os.path.join(reg.dir, "traffic", "assembly-1mb.json")
    with open(registry.HERE + "/traffic/assembly-1mb.json") as f:
        tr = json.load(f)
    mb = "-x500 -s%g" % (genome_size * 24 / 3 / 1e6)
    tr["reads"]["genome_size"] = genome_size
    tr["cfg"].update(genome_size=genome_size, pa_DBsplit_option=mb,
                     ovlp_DBsplit_option=mb)
    with open(path, "w") as f:
        json.dump(tr, f)
    return registry.Registry(reg.dir)
