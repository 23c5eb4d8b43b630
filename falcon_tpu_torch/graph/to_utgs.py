"""Unitig sequence emission (fc_graph_to_utgs).

Exact reimplementation of the reference's unitig FASTA tool
(reference: falcon_kit/mains/graph_to_utgs.py:59-177): simple unitigs are
stitched from edge sequences; compound unitigs yield the best path plus
every alternate score-weighted shortest path that is not a near-duplicate
(idt >= 0.96 and cov >= 0.98 vs the base path).  Writes utgs.fa.
"""
import os

from .asm_graph import AsmGraph
from .to_contig import TooLongError, _dijkstra, get_aln_data


def run(out_dir="."):
    def p(name):
        return os.path.join(out_dir, name)

    asm = AsmGraph(p("sg_edges_list"), p("utg_data"), p("ctg_paths"))
    asm.load_sg_seq(p("preads4falcon.fasta"))

    with open(p("utgs.fa"), "w") as out:
        for (s, t, v), (type_, length, score, path_or_edges) in \
                asm.utg_data.items():
            if type_ == "simple":
                path = path_or_edges.split("~")
                seq = asm.get_seq_from_path(path)
                out.write(">%s~%s~%s-%d %d %d\n" % (s, v, t, 0, length,
                                                    score))
                out.write(seq + "\n")
            elif type_ == "compound":
                adj = {}

                def add_adj(v1, v2, wgt):
                    adj.setdefault(v1, [])
                    if all(x[0] != v2 for x in adj[v1]):
                        adj[v1].append((v2, wgt))

                edges = [c.split("~") for c in path_or_edges.split("|")]
                for (ss, vv, tt) in edges:
                    sub = asm.utg_data[(ss, tt, vv)][3].split("~")
                    v1 = sub[0]
                    for v2 in sub[1:]:
                        add_adj(v1, v2, asm.sg_edges[(v1, v2)][1])
                        v1 = v2

                sp, spl = _dijkstra(adj, s, t)
                if sp is None:
                    continue
                all_alt = [(spl, sp)]
                while True:
                    if s == t:
                        break
                    n0 = sp[0]
                    for n1 in sp[1:]:
                        adj[n0] = [x for x in adj.get(n0, ()) if x[0] != n1]
                        n0 = n1
                    sp, spl = _dijkstra(adj, s, t)
                    if sp is None:
                        break
                    all_alt.append((spl, sp))
                all_alt.sort()
                all_alt.reverse()

                def path_seq(atig_path):
                    pairs = list(zip(atig_path[:-1], atig_path[1:]))
                    seqs, tl, ts = [], 0, 0
                    for vv, ww in pairs:
                        (rid, ss_, tt_), aln_score, idt, _ = \
                            asm.sg_edges[(vv, ww)]
                        seqs.append(asm.sg_edge_seqs[(vv, ww)])
                        tl += abs(ss_ - tt_)
                        ts += aln_score
                    return "".join(seqs), tl, ts

                score0, atig_path = all_alt[0]
                base_seq, tl, ts = path_seq(atig_path)
                atig_output = [(s, t, atig_path, tl, ts, base_seq, 1, 1)]

                for score_a, atig_path in all_alt[1:]:
                    seq, tl, ts = path_seq(atig_path)
                    try:
                        aln_data = get_aln_data(base_seq, seq)
                    except TooLongError:
                        aln_data = []
                    if aln_data:
                        idt = 1.0 - 1.0 * aln_data[-1][-1] / aln_data[-1][-2]
                        cov = 1.0 * (aln_data[-1][3] - aln_data[-1][2]) / \
                            aln_data[-1][4]
                        if idt < 0.96 or cov < 0.98:
                            atig_output.append((s, t, atig_path, tl, ts,
                                                seq, idt, cov))
                    else:
                        atig_output.append((s, t, atig_path, tl, ts, seq,
                                            0, 0))

                for sub_id, data in enumerate(atig_output):
                    v0, w0, tig_path, tl, ts, seq, a_idt, cov = data
                    out.write(">%s~%s~%s-%d %d %d\n" % (v0, "NA", w0,
                                                        sub_id, tl, ts))
                    out.write(seq + "\n")
