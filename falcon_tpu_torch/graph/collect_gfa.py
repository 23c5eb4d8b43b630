"""Collect assembly artifacts into GFA JSON (pread-level and contig-level).

Exact reimplementation of the reference GFA collection mains
(reference: falcon_kit/mains/collect_pread_gfa.py and
collect_contig_gfa.py): tiling paths (+ optionally the whole string graph)
-> GFAGraph JSON on an output stream; forward-strand coordinate fixup for
reverse-oriented overlaps (collect_pread_gfa.py:81-89); contig-level GFA
with a_ctg placement edges (collect_contig_gfa.py:10-62).
"""
from ..io import fasta
from . import tiling as tiling_mod
from .asm_graph import AsmGraph
from .gfa import GFAGraph, serialize_gfa


def load_seqs(fasta_fn, store_only_seq_len):
    seqs = {}
    for r in fasta.read_fasta(fasta_fn):
        if store_only_seq_len:
            seqs[r.name] = (len(r.sequence), "*")
        else:
            seqs[r.name] = (len(r.sequence), r.sequence.upper())
    return seqs


def load_pread_overlaps(fp):
    d = {}
    for line in fp:
        sl = line.strip().split()
        if len(sl) < 13:
            continue
        d[(sl[0], sl[1])] = sl[0:4] + [int(v) for v in sl[4:12]] + sl[12:]
        # overlaps are not always symmetric in preads.ovl; add the reverse
        # record without overwriting an existing one
        if (sl[1], sl[0]) not in d:
            d[(sl[1], sl[0])] = ([sl[1], sl[0], sl[2], sl[3]] +
                                 [int(v) for v in sl[8:12]] +
                                 [int(v) for v in sl[4:8]] + sl[12:])
    return d


def load_sg_edges(fp):
    d = {}
    for line in fp:
        sl = line.strip().split()
        if len(sl) < 8:
            continue
        d[(sl[0], sl[1])] = (sl[0:3] + [int(v) for v in sl[3:6]] +
                             [float(sl[6])] + sl[7:])
    return d


def _add_node(g, v, preads_dict):
    v_name = v.split(":")[0]
    v_len, v_seq = preads_dict[v_name]
    g.add_node(v_name, v_len, v_seq)


def _add_edge(g, v, w, edge_split_line, preads_overlap_dict, sg_edges_dict):
    edge_name = "edge-%d" % len(g.edges)
    v_name, v_orient = v.split(":")
    w_name, w_orient = w.split(":")
    v_orient = "+" if v_orient == "E" else "-"
    w_orient = "+" if w_orient == "E" else "-"

    sg_edge = sg_edges_dict[(v, w)]
    overlap = preads_overlap_dict[(v_name, w_name)]
    labels = {"tp": edge_split_line, "sg_edge": sg_edge, "overlap": overlap}

    # coordinates must be on the fwd strand in GFA; the overlap table
    # reports them on the alignment strand
    (_, _, score, idt, v_rev, v_start, v_end, v_len,
     w_rev, w_start, w_end, w_len) = overlap[0:12]
    if v_rev == 1:
        v_start, v_end = v_end, v_start
        v_start = v_len - v_start
        v_end = v_len - v_end
    if w_rev == 1:
        w_start, w_end = w_end, w_start
        w_start = w_len - w_start
        w_end = w_len - w_end
    g.add_edge(edge_name, v_name, v_orient, w_name, w_orient,
               v_start, v_end, w_start, w_end, "*", tags={}, labels=labels)


def _add_tiling_paths(g, tiling_paths, preads_dict, preads_overlap_dict,
                      sg_edges_dict):
    for ctg_id, tp in tiling_paths.items():
        for e in tp.edges:
            _add_node(g, e.v, preads_dict)
            _add_node(g, e.w, preads_dict)
    for ctg_id, tp in tiling_paths.items():
        for e in tp.edges:
            _add_edge(g, e.v, e.w, e.get_split_line(),
                      preads_overlap_dict, sg_edges_dict)
    for ctg_id, tp in tiling_paths.items():
        if not tp.edges:
            continue
        path_nodes = []
        path_cigars = []
        v = tp.edges[0].v
        v_name = v.split(":")[0]
        path_nodes.append(v_name)
        path_cigars.append("%dM" % tp.coords[v])
        for e in tp.edges:
            w_name = e.w.split(":")[0]
            path_nodes.append(w_name)
            path_cigars.append("%dM" % abs(e.e - e.b))
        g.add_path(ctg_id, path_nodes, path_cigars)


def _add_string_graph(g, sg_edges_list, utg_data, ctg_paths, preads_dict,
                      preads_overlap_dict, sg_edges_dict):
    asm = AsmGraph(sg_edges_list, utg_data, ctg_paths)
    for (v, w) in asm.sg_edges:
        _add_node(g, v, preads_dict)
        _add_node(g, w, preads_dict)
    for (v, w), edge_data in asm.sg_edges.items():
        if edge_data[-1] != "G":
            continue
        _add_edge(g, v, w, edge_data, preads_overlap_dict, sg_edges_dict)


def collect_pread_gfa(fp_out, p_ctg_tiling_path="p_ctg_tiling_path",
                      a_ctg_tiling_path="a_ctg_tiling_path",
                      preads_fasta="preads4falcon.fasta",
                      p_ctg_fasta="p_ctg.fa", a_ctg_fasta="a_ctg.fa",
                      sg_edges_list="sg_edges_list",
                      preads_ovl="preads.ovl", utg_data="utg_data",
                      ctg_paths="ctg_paths", add_string_graph=False,
                      write_reads=False, min_p_len=0, min_a_len=0,
                      only_these_contigs=""):
    g = GFAGraph()
    preads_dict = load_seqs(preads_fasta, not write_reads)
    with open(preads_ovl) as fp:
        preads_overlap_dict = load_pread_overlaps(fp)
    with open(sg_edges_list) as fp:
        sg_edges_dict = load_sg_edges(fp)

    p_ctg_seqs = load_seqs(p_ctg_fasta, True)
    a_ctg_seqs = load_seqs(a_ctg_fasta, True)
    p_ctg_lens = {k: v[0] for k, v in p_ctg_seqs.items()}
    a_ctg_lens = {k: v[0] for k, v in a_ctg_seqs.items()}

    p_whitelist = set(p_ctg_seqs.keys())
    a_whitelist = set(a_ctg_seqs.keys())
    if only_these_contigs:
        p_whitelist = set(
            open(only_these_contigs).read().splitlines()) & p_whitelist
        a_whitelist = set(
            k for k in a_ctg_seqs
            if k.split("-")[0].split("_")[0] in p_whitelist)

    p_paths = tiling_mod.load_tiling_paths(
        p_ctg_tiling_path, whitelist_seqs=p_whitelist, contig_lens=p_ctg_lens)
    a_paths = tiling_mod.load_tiling_paths(
        a_ctg_tiling_path, whitelist_seqs=a_whitelist, contig_lens=a_ctg_lens)

    _add_tiling_paths(g, p_paths, preads_dict, preads_overlap_dict,
                      sg_edges_dict)
    _add_tiling_paths(g, a_paths, preads_dict, preads_overlap_dict,
                      sg_edges_dict)
    if add_string_graph:
        _add_string_graph(g, sg_edges_list, utg_data, ctg_paths, preads_dict,
                          preads_overlap_dict, sg_edges_dict)
    fp_out.write(serialize_gfa(g))
    fp_out.write("\n")


def collect_contig_gfa(fp_out, p_ctg_tiling_path="p_ctg_tiling_path",
                       a_ctg_tiling_path="a_ctg_tiling_path",
                       p_ctg_fasta="p_ctg.fa", a_ctg_fasta="a_ctg.fa",
                       write_contigs=False, min_p_len=0, min_a_len=0,
                       only_these_contigs=""):
    g = GFAGraph()
    p_ctg_dict = load_seqs(p_ctg_fasta, not write_contigs)
    a_ctg_dict = load_seqs(a_ctg_fasta, not write_contigs)
    p_ctg_lens = {k: v[0] for k, v in p_ctg_dict.items()}
    p_ctg_seqs = {k: v[1] for k, v in p_ctg_dict.items()}
    a_ctg_lens = {k: v[0] for k, v in a_ctg_dict.items()}
    a_ctg_seqs = {k: v[1] for k, v in a_ctg_dict.items()}

    p_whitelist = set(p_ctg_seqs.keys())
    a_whitelist = set(a_ctg_seqs.keys())
    if only_these_contigs:
        p_whitelist = set(
            open(only_these_contigs).read().splitlines()) & p_whitelist
        a_whitelist = set(
            k for k in a_ctg_seqs
            if k.split("-")[0].split("_")[0] in p_whitelist)

    p_paths = tiling_mod.load_tiling_paths(
        p_ctg_tiling_path, whitelist_seqs=p_whitelist, contig_lens=p_ctg_lens)
    a_paths = tiling_mod.load_tiling_paths(
        a_ctg_tiling_path, whitelist_seqs=a_whitelist, contig_lens=a_ctg_lens)

    a_placement = tiling_mod.find_a_ctg_placement(p_paths, a_paths)

    for ctg_id in p_paths:
        g.add_node(ctg_id, p_ctg_lens[ctg_id], p_ctg_seqs[ctg_id])
    for ctg_id in a_paths:
        g.add_node(ctg_id, a_ctg_lens[ctg_id], a_ctg_seqs[ctg_id])

    for p_ctg_id, a_dict in a_placement.items():
        for a_ctg_id, placement in a_dict.items():
            start, end, p_ctg_id, a_ctg_id, first_node, last_node = placement
            a_len = a_ctg_lens[a_ctg_id]
            g.add_edge("edge-%d" % len(g.edges), p_ctg_id, "+", a_ctg_id,
                       "+", start, start, 0, 0, "*", tags={}, labels={})
            g.add_edge("edge-%d" % len(g.edges), a_ctg_id, "+", p_ctg_id,
                       "+", a_len, a_len, end, end, "*", tags={}, labels={})
    fp_out.write(serialize_gfa(g))
    fp_out.write("\n")
