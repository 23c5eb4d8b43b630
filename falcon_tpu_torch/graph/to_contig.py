"""Contig sequence synthesis from the string graph.

Semantically exact reimplementation of the reference's
fc_graph_to_contig (reference: falcon_kit/mains/graph_to_contig.py):
reads sg_edges_list + utg_data + ctg_paths + preads4falcon.fasta; stitches
p_ctg sequence = first full read + per-edge suffix slices (reverse
complemented when s > t); for compound utgs repeatedly extracts
score-weighted shortest paths as alternate haplotig candidates, aligns each
alternate against the base path (band 1500, 250k length guard) to annotate
identity/coverage; writes p_ctg.fa, a_ctg_all.fa, a_ctg_base.fa and the
three tiling-path files.

The weighted shortest path matches networkx Dijkstra tie-breaking
(heap entries (dist, push_counter, node)).
"""
import heapq
import logging
import os

from ..io import fasta
from ..ops import align as _align
from ..ops import kmer as _kmer
from .sg import reverse_end

LOG = logging.getLogger(__name__)

_RC = dict(zip("ACGTacgtNn-", "TGCAtgcaNn-"))


class TooLongError(Exception):
    pass


def rc(seq):
    return "".join(_RC[c] for c in reversed(seq))


def get_aln_data(t_seq, q_seq):
    """Identity/coverage metrics for an alternate path vs its base
    (reference: graph_to_contig.py:52-104)."""
    aln_data = []
    K = 8
    lookup = _kmer.KmerLookup(t_seq, K)
    qp, tp = lookup.find_kmer_pos_for_seq(q_seq)
    if len(qp) != 0:
        r = _kmer.find_best_aln_range(qp, tp, K, K * 5, 12)
        s1, e1, s2, e2 = r.s1, r.e1, r.s2, r.e2
        max_len = 250000  # same allocation guard as the reference
        if (e1 - s1) >= max_len or (e2 - s2) >= max_len:
            raise TooLongError(
                "q_len=%d or t_len=%d are too big, over 500k" %
                (e1 - s1, e2 - s2))
        if e1 - s1 > 100:
            LOG.debug("aligning alt path: q=%d t=%d", e1 - s1, e2 - s2)
            from ..ops import native
            if native.available():
                aln = native.align(q_seq[s1:e1], t_seq[s2:e2], 1500, True)
            else:
                aln = _align.align(q_seq[s1:e1], t_seq[s2:e2], 1500, True)
            if aln.aln_str_size > 100:
                aln_data.append(("dummy", 0, s1, e1, len(q_seq), s2, e2,
                                 len(t_seq), aln.aln_str_size, aln.dist))
    return aln_data


def _dijkstra(adj, src, dst):
    """(path, dist); None if unreachable.  Matches networkx 1.x
    single_source_dijkstra tie behavior: heap entries are (dist, node), so
    equal-distance ties resolve by node-name comparison.
    adj: node -> list[(neighbor, weight)] in insertion order."""
    dist = {}
    seen = {src: 0}
    paths = {src: [src]}
    pq = [(0, src)]
    while pq:
        d, v = heapq.heappop(pq)
        if v in dist:
            continue
        dist[v] = d
        if v == dst:
            return paths[v], d
        for (u, w) in adj.get(v, ()):
            vu = d + w
            if u not in dist and (u not in seen or vu < seen[u]):
                seen[u] = vu
                paths[u] = paths[v] + [u]
                heapq.heappush(pq, (vu, u))
    return None, None


def yield_first_seq(one_path_edges, seqs):
    """Prepend the entire first read for non-circular paths
    (reference: graph_to_contig.py:113-124)."""
    if one_path_edges and one_path_edges[0][0] != one_path_edges[-1][1]:
        vv = one_path_edges[0][0]
        vv_rid, vv_letter = vv.split(":")
        if vv_letter == "E":
            yield seqs[vv_rid]
        else:
            assert vv_letter == "B"
            yield rc(seqs[vv_rid])


def run(out_dir=".", improper_p_ctg=False, proper_a_ctg=False,
        read_fasta_fn=None, edge_data_file=None, utg_data_file=None,
        ctg_data_file=None):
    """Generate p_ctg/a_ctg fasta + tiling paths
    (reference: graph_to_contig.py:127-394)."""
    read_fasta_fn = read_fasta_fn or os.path.join(out_dir, "preads4falcon.fasta")
    edge_data_file = edge_data_file or os.path.join(out_dir, "sg_edges_list")
    utg_data_file = utg_data_file or os.path.join(out_dir, "utg_data")
    ctg_data_file = ctg_data_file or os.path.join(out_dir, "ctg_paths")

    reads_in_layout = set()
    with open(edge_data_file) as f:
        for line in f:
            l = line.strip().split()
            v, w, rid, s, t, aln_score, idt, type_ = l
            if type_ != "G":
                continue
            reads_in_layout.add(v.split(":")[0])
            reads_in_layout.add(w.split(":")[0])

    seqs = {}
    for rec in fasta.read_fasta(read_fasta_fn):
        if rec.name not in reads_in_layout:
            continue
        seqs[rec.name] = rec.sequence.upper()

    edge_data = {}
    with open(edge_data_file) as f:
        for line in f:
            l = line.strip().split()
            v, w, rid, s, t, aln_score, idt, type_ = l
            if type_ != "G":
                continue
            r2, dir2 = w.split(":")
            s = int(s)
            t = int(t)
            aln_score = int(aln_score)
            idt = float(idt)
            if s < t:
                e_seq = seqs[rid][s:t]
                assert dir2 == "E"
            else:
                # s/t were swapped for reverse-orientation overlaps in
                # the string-graph stage
                e_seq = rc(seqs[rid][t:s])
                assert dir2 == "B"
            edge_data[(v, w)] = (rid, s, t, aln_score, idt, e_seq)

    utg_data = {}
    with open(utg_data_file) as f:
        for line in f:
            l = line.strip().split()
            s, v, t, type_, length, score, path_or_edges = l
            if type_ not in ("compound", "simple", "contained"):
                continue
            length = int(length)
            score = int(score)
            if type_ in ("simple", "contained"):
                path_or_edges = path_or_edges.split("~")
            else:
                path_or_edges = [tuple(e.split("~"))
                                 for e in path_or_edges.split("|")]
            utg_data[(s, v, t)] = type_, length, score, path_or_edges

    def opath(name):
        return os.path.join(out_dir, name)

    p_ctg_out = open(opath("p_ctg.fa"), "w")
    a_ctg_out = open(opath("a_ctg_all.fa"), "w")
    a_ctg_base_out = open(opath("a_ctg_base.fa"), "w")
    p_ctg_t_out = open(opath("p_ctg_tiling_path"), "w")
    a_ctg_t_out = open(opath("a_ctg_tiling_path"), "w")
    a_ctg_base_t_out = open(opath("a_ctg_base_tiling_path"), "w")
    layout_ctg = set()

    with open(ctg_data_file) as f:
        for line in f:
            l = line.strip().split()
            ctg_id, c_type_, i_utig, t0, length, score, utgs = l
            s0 = i_utig.split("~")[0]
            if (reverse_end(t0), reverse_end(s0)) in layout_ctg:
                continue
            layout_ctg.add((s0, t0))

            ctg_label = i_utig + "~" + t0
            utgs = utgs.split("|")
            one_path = []
            total_score = 0
            total_length = 0
            a_ctg_group = {}

            for utg in utgs:
                s, v, t = utg.split("~")
                type_, length, score, path_or_edges = utg_data[(s, v, t)]
                total_score += score
                total_length += length
                if type_ == "simple":
                    if one_path:
                        one_path.extend(path_or_edges[1:])
                    else:
                        one_path.extend(path_or_edges)
                elif type_ == "compound":
                    adj = {}

                    def add_adj(v1, v2, wgt):
                        adj.setdefault(v1, [])
                        if all(x[0] != v2 for x in adj[v1]):
                            adj[v1].append((v2, wgt))

                    all_alt_path = []
                    for (ss, vv, tt) in path_or_edges:
                        sub = utg_data[(ss, vv, tt)]
                        sub_path = sub[3]
                        v1 = sub_path[0]
                        for v2 in sub_path[1:]:
                            add_adj(v1, v2, edge_data[(v1, v2)][3])
                            v1 = v2

                    sp, spl = _dijkstra(adj, s, t)
                    all_alt_path.append((spl, sp))
                    while True:
                        n0 = sp[0]
                        for n1 in sp[1:]:
                            adj[n0] = [x for x in adj.get(n0, ())
                                       if x[0] != n1]
                            n0 = n1
                        sp, spl = _dijkstra(adj, s, t)
                        if sp is None:
                            break
                        all_alt_path.append((spl, sp))
                    all_alt_path.sort()
                    all_alt_path.reverse()
                    shortest_path = all_alt_path[0][1]
                    if one_path:
                        one_path.extend(shortest_path[1:])
                    else:
                        one_path.extend(shortest_path)
                    a_ctg_group[(s, t)] = all_alt_path

            if not one_path:
                continue

            one_path_edges = list(zip(one_path[:-1], one_path[1:]))

            if improper_p_ctg:
                sub_seqs = []
            else:
                sub_seqs = list(yield_first_seq(one_path_edges, seqs))
            for vv, ww in one_path_edges:
                rid, s, t, aln_score, idt, e_seq = edge_data[(vv, ww)]
                sub_seqs.append(e_seq)
                p_ctg_t_out.write("%s %s %s %s %d %d %d %0.2f\n" % (
                    ctg_id, vv, ww, rid, s, t, aln_score, idt))
            p_ctg_out.write(">%s %s %s %d %d\n" % (
                ctg_id, ctg_label, c_type_, total_length, total_score))
            p_ctg_out.write("".join(sub_seqs) + "\n")

            a_id = 1
            for (v, w) in a_ctg_group:
                atig_output = []
                score, atig_path = a_ctg_group[(v, w)][0]
                atig_path_edges = list(zip(atig_path[:-1], atig_path[1:]))
                if not proper_a_ctg:
                    sub_seqs = []
                else:
                    sub_seqs = list(yield_first_seq(atig_path_edges, seqs))
                total_length = 0
                total_score = 0
                for vv, ww in atig_path_edges:
                    rid, s, t, aln_score, idt, e_seq = edge_data[(vv, ww)]
                    sub_seqs.append(e_seq)
                    total_length += abs(s - t)
                    total_score += aln_score
                base_seq = "".join(sub_seqs)
                atig_output.append((v, w, atig_path, total_length,
                                    total_score, base_seq, atig_path_edges,
                                    0, 1, 1))

                for score, atig_path in a_ctg_group[(v, w)][1:]:
                    atig_path_edges = list(zip(atig_path[:-1], atig_path[1:]))
                    if not proper_a_ctg:
                        sub_seqs = []
                    else:
                        sub_seqs = list(yield_first_seq(atig_path_edges, seqs))
                    total_length = 0
                    total_score = 0
                    for vv, ww in atig_path_edges:
                        rid, s, t, aln_score, idt, e_seq = edge_data[(vv, ww)]
                        sub_seqs.append(e_seq)
                        total_length += abs(s - t)
                        total_score += aln_score
                    seq = "".join(sub_seqs)

                    delta_len = len(seq) - len(base_seq)
                    idt = 0.0
                    cov = 0.0
                    if len(base_seq) > 2000 and len(seq) > 2000:
                        try:
                            aln_data = get_aln_data(base_seq, seq)
                            if len(aln_data) != 0:
                                idt = 1.0 - 1.0 * \
                                    aln_data[-1][-1] / aln_data[-1][-2]
                                cov = 1.0 * \
                                    (aln_data[-1][3] - aln_data[-1][2]) / \
                                    aln_data[-1][4]
                        except TooLongError:
                            LOG.warning(
                                "Seqs too long for get_aln_data(); "
                                "setting idt/cov to -1 at atig_path[:-1]==%r",
                                atig_path[:-1])
                            idt = -1.0
                            cov = -1.0
                    atig_output.append((v, w, atig_path, total_length,
                                        total_score, seq, atig_path_edges,
                                        delta_len, idt, cov))

                if len(atig_output) == 1:
                    continue

                sub_id = 0
                for data in atig_output:
                    (v0, w0, tig_path, total_length, total_score, seq,
                     atig_path_edges, delta_len, a_idt, cov) = data
                    for vv, ww in atig_path_edges:
                        rid, s, t, aln_score, idt, e_seq = edge_data[(vv, ww)]
                        t_out = a_ctg_t_out if sub_id != 0 else a_ctg_base_t_out
                        t_out.write("%s-%03d-%02d %s %s %s %d %d %d %0.2f\n" % (
                            ctg_id, a_id, sub_id, vv, ww, rid, s, t,
                            aln_score, idt))
                    f_out = a_ctg_out if sub_id != 0 else a_ctg_base_out
                    f_out.write(">%s-%03d-%02d %s %s %d %d %d %d %0.2f %0.2f\n" % (
                        ctg_id, a_id, sub_id, v0, w0, total_length,
                        total_score, len(atig_path_edges), delta_len,
                        a_idt, cov))
                    f_out.write(seq + "\n")
                    sub_id += 1
                a_id += 1

    a_ctg_out.close()
    a_ctg_base_out.close()
    p_ctg_out.close()
    a_ctg_t_out.close()
    a_ctg_base_t_out.close()
    p_ctg_t_out.close()


def dedup_a_tigs(out_dir=".", max_idt=96, max_aln_cov=97, min_len_diff=500):
    """a_ctg_all.fa -> a_ctg.fa, dropping alternate tigs too similar to
    their base (reference: falcon_kit/mains/dedup_a_tigs.py:22-32)."""
    in_fn = os.path.join(out_dir, "a_ctg_all.fa")
    out_fn = os.path.join(out_dir, "a_ctg.fa")
    with open(out_fn, "w") as f:
        for rec in fasta.read_fasta(in_fn):
            parts = (rec.name + " " + rec.comment).split()
            tig_id, v, w, len_, ovl, ne, delta_l, idt, cov = parts
            if 100 * float(idt) > max_idt and \
                    100 * float(cov) > max_aln_cov and \
                    abs(int(delta_l)) < min_len_diff:
                continue
            f.write(">" + rec.name +
                    ((" " + rec.comment) if rec.comment else "") + "\n")
            f.write(rec.sequence + "\n")
