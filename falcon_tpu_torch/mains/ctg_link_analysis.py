"""fc_ctg_link_analysis equivalent: contig-contig link tables via string
graph edges crossing contig boundaries
(reference: falcon_kit/mains/ctg_link_analysis.py:8-87)."""
import os
import sys

from ..graph.asm_graph import AsmGraph


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    out_dir = argv[1] if len(argv) > 1 else "."

    def p(name):
        return os.path.join(out_dir, name)

    asm = AsmGraph(p("sg_edges_list"), p("utg_data"), p("ctg_paths"))

    ctg_pair_links = {}
    for (v, w) in asm.sg_edges:
        if v in asm.node_to_ctg and w in asm.node_to_ctg:
            for c1 in asm.node_to_ctg[v]:
                for c2 in asm.node_to_ctg[w]:
                    if c1 != c2:
                        ctg_pair_links.setdefault((c1, c2), set()).add(
                            (v, w))

    utg_pair_links = {}
    for (v, w) in asm.sg_edges:
        if v in asm.node_to_utg and w in asm.node_to_utg:
            for u1 in asm.node_to_utg[v]:
                for u2 in asm.node_to_utg[w]:
                    if u1 != u2:
                        utg_pair_links.setdefault((u1, u2), set()).add(
                            (v, w))

    def expand(path_slice):
        utgs = []
        for (s, v, t) in path_slice:
            u = (s, t, v)
            type_, length, score, path_or_edges = asm.utg_data[u]
            if type_ == "compound":
                for sub in path_or_edges.split("|"):
                    ss, vv, tt = sub.split("~")
                    utgs.append((ss, tt, vv))
            else:
                utgs.append(u)
        return utgs

    for (ctg1, ctg2), links in ctg_pair_links.items():
        if not links:
            continue
        utg1 = expand(asm.ctg_data[ctg1][-1][-5:])
        utg2 = expand(asm.ctg_data[ctg2][-1][:5])
        for u1 in utg1:
            for u2 in utg2:
                c = utg_pair_links.get((tuple(u1), tuple(u2)), set())
                if not c:
                    continue
                s1, t1, v1 = u1
                s2, t2, v2 = u2
                len_1 = asm.ctg_data[ctg1][3]
                len_2 = asm.ctg_data[ctg2][3]
                print("{} {} {:7d}\t{:7d}\t{}\t{}\t{}\t{} {} {}".format(
                    ctg1, ctg2, len_1, len_2, len(utg1), len(utg2),
                    len(links), "~".join((s1, v1, t1)),
                    "~".join((s2, v2, t2)), len(c)))
    return 0


if __name__ == "__main__":
    sys.exit(main())
