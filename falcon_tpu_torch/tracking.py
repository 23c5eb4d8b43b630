"""Read-to-contig tracking (the unzip/polish support tools).

Reimplements the reference's read-tracking chain (reference:
falcon_kit/mains/{get_read_ctg_map,generate_read_to_ctg_map,rr_ctg_track,
pr_ctg_track,fetch_reads}.py) against this pipeline's artifacts:

  * pread -> contig map from the assembly graph node map
    (generate_read_to_ctg_map.py:12-41)
  * rawread -> contig via best-n seed overlaps: each raw read's top
    overlapping seed reads vote for their contigs with summed overlap
    lengths (rr_ctg_track.py tr_stage1 + run_track_reads:33-116,
    heap semantics preserved)
  * pread -> contig via pread-vs-pread overlaps (pr_ctg_track.py)
  * per-contig raw-read FASTA extraction (fetch_reads.py:15-60)

In this pipeline pread ids are dense "%09d" row ids and each pread's
provenance is its seed raw read, recorded by the driver in
1-preads_ovl/pread_ids ("<pread_id> <prolog name>" rows, the DBdump
id-dump analog).
"""
import os
from heapq import heappush, heappushpop

from .io import fasta


def load_pread_ids(path):
    """pread_id -> original pread name (prolog/<seed>N/0_len)."""
    out = {}
    with open(path) as f:
        for line in f:
            pid, name = line.split()
            out[pid] = name
    return out


def pread_to_seed(pread_name):
    """'prolog/000000123 0/0_5000'-style name -> seed rawread id
    (the fc_consensus --output-multi naming, consensus.py:293)."""
    if pread_name.startswith("prolog/"):
        core = pread_name.split("/")[1]
        return core[:-1]  # strip the region index digit
    return pread_name


def pread_to_ctg_map(asm_dir, out_fn=None):
    """pread id -> set of contigs, from the assembly graph node map
    (reference: generate_read_to_ctg_map.py)."""
    from .graph.asm_graph import AsmGraph
    asm = AsmGraph(os.path.join(asm_dir, "sg_edges_list"),
                   os.path.join(asm_dir, "utg_data"),
                   os.path.join(asm_dir, "ctg_paths"))
    rid_to_ctg = {}
    for node, ctgs in asm.node_to_ctg.items():
        rid = node.split(":")[0]
        rid_to_ctg.setdefault(rid, set()).update(ctgs)
    if out_fn:
        with open(out_fn, "w") as f:
            for rid in sorted(rid_to_ctg):
                for ctg in sorted(rid_to_ctg[rid]):
                    f.write("%s %s\n" % (rid, ctg))
    return rid_to_ctg


def track_reads(overlap_lines, rid_to_ctg, out_f, min_len=2500, bestn=40):
    """bread -> contig table with best-n a-read voting
    (reference: rr_ctg_track.py tr_stage1 + run_track_reads).

    overlap_lines: iterable of 13-column rows where the a-read (q) is the
    entity already mapped to contigs (seed raw read or pread) and the
    b-read (t) is the read being tracked.
    Output rows: "bread ctg count rank score in_ctg".
    """
    bread_to_areads = {}
    for l in overlap_lines:
        q_id, t_id = l[:2]
        overlap_len = -int(l[2])
        t_l = int(l[11])
        if t_l < min_len:
            continue
        if q_id not in rid_to_ctg:
            continue
        heap = bread_to_areads.setdefault(t_id, [])
        if len(heap) < bestn:
            heappush(heap, (overlap_len, q_id))
        else:
            heappushpop(heap, (overlap_len, q_id))

    for bread in bread_to_areads:
        ctg_score = {}
        for s, rid in bread_to_areads[bread]:
            for ctg in rid_to_ctg.get(rid, ()):
                cs = ctg_score.setdefault(ctg, [0, 0])
                cs[0] += -s
                cs[1] += 1
        # tie-break by contig id so the F orientation outranks its R twin
        # (the reference leaves ties in dict order, rr_ctg_track.py:105)
        rows = sorted(ctg_score.items(), key=lambda kv: (kv[1][0], kv[0]))
        rank = 0
        for ctg, (score, count) in rows:
            in_ctg = 1 if bread in rid_to_ctg and \
                ctg in rid_to_ctg.get(bread, ()) else 0
            out_f.write("%s %s %d %d %d %d\n" % (
                bread, ctg, count, rank, score, in_ctg))
            rank += 1


def run_tracking(out_dir, min_len=2500, bestn=40):
    """Produce read_maps/{read_to_contig_map,rawread_to_contigs,
    pread_to_contigs} from the pipeline's artifacts
    (reference: 2-asm-falcon/read_maps layout, rr_ctg_track.py:100)."""
    asm_dir = os.path.join(out_dir, "2-asm-falcon")
    maps_dir = os.path.join(asm_dir, "read_maps")
    os.makedirs(maps_dir, exist_ok=True)

    rid_to_ctg = pread_to_ctg_map(
        asm_dir, os.path.join(maps_dir, "read_to_contig_map"))

    # pread -> contigs via pread-vs-pread overlaps
    ovl_fn = os.path.join(asm_dir, "preads.ovl")
    if os.path.exists(ovl_fn):
        from .overlap.records import read_overlap_lines
        with open(os.path.join(maps_dir, "pread_to_contigs"), "w") as f:
            track_reads(read_overlap_lines(ovl_fn), rid_to_ctg, f,
                        min_len=min_len, bestn=bestn)

    # rawread -> contigs: seed raw reads inherit their preads' contigs,
    # then raw-vs-raw overlaps vote
    ids_fn = os.path.join(out_dir, "1-preads_ovl", "pread_ids")
    raw_ovl = os.path.join(out_dir, "0-rawreads", "raw_overlaps.ovl")
    if os.path.exists(ids_fn) and os.path.exists(raw_ovl):
        pread_names = load_pread_ids(ids_fn)
        seed_to_ctg = {}
        for pid, name in pread_names.items():
            seed = pread_to_seed(name)
            if pid in rid_to_ctg:
                seed_to_ctg.setdefault(seed, set()).update(rid_to_ctg[pid])
        from .overlap.records import read_overlap_lines
        with open(os.path.join(maps_dir, "rawread_to_contigs"), "w") as f:
            track_reads(read_overlap_lines(raw_ovl), seed_to_ctg, f,
                        min_len=min_len, bestn=bestn)
    return maps_dir


def fetch_reads(out_dir, ctg_list=None, min_ctg_size=0):
    """Per-contig raw-read FASTA extraction for unzip
    (reference: fetch_reads.py:15-60).  Writes
    3-unzip/reads/<ctg>/reads.fa for each tracked contig."""
    from .io.readstore import ReadStore
    asm_dir = os.path.join(out_dir, "2-asm-falcon")
    maps_fn = os.path.join(asm_dir, "read_maps", "rawread_to_contigs")
    store = ReadStore.load(os.path.join(out_dir, "0-rawreads", "raw_reads"))
    name_to_rid = {n: i for i, n in enumerate(store.names)}

    ctg_reads = {}
    with open(maps_fn) as f:
        for line in f:
            bread, ctg, count, rank, score, in_ctg = line.split()
            if int(rank) == 0:  # best contig only
                ctg_reads.setdefault(ctg, []).append(bread)

    out_base = os.path.join(out_dir, "3-unzip", "reads")
    written = {}
    for ctg, reads in ctg_reads.items():
        if ctg_list and ctg not in ctg_list:
            continue
        d = os.path.join(out_base, ctg)
        os.makedirs(d, exist_ok=True)
        fn = os.path.join(d, "reads.fa")
        with open(fn, "w") as f:
            for name in sorted(reads):
                rid = name_to_rid.get(name)
                if rid is None and name.lstrip("0"):
                    try:
                        rid = int(name)
                    except ValueError:
                        rid = None
                if rid is None or rid >= len(store):
                    continue
                f.write(">%s\n%s\n" % (name, store.get_seq(rid)))
        written[ctg] = fn
    return written
