"""fc_contig_annotate equivalent: per-node contig coordinates + membership
(reference: falcon_kit/mains/contig_annotate.py:8-31)."""
import os
import sys

from ..graph.asm_graph import AsmGraph


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    out_dir = argv[1] if len(argv) > 1 else "."

    def p(name):
        return os.path.join(out_dir, name)

    asm = AsmGraph(p("sg_edges_list"), p("utg_data"), p("ctg_paths"))
    coor_map = {}
    coor = 0
    for fn in ("p_ctg_tiling_path", "a_ctg_tiling_path"):
        with open(p(fn)) as f:
            for row in f:
                row = row.strip().split()
                ctg_id, v, w, edge_rid, b, e = row[:6]
                if ctg_id not in coor_map:
                    coor = 0
                    coor_map[ctg_id] = {v: 0}
                    coor += abs(int(b) - int(e))
                    coor_map[ctg_id][w] = coor
                    print(ctg_id, v, 0,
                          " ".join(sorted(asm.node_to_ctg[v])))
                    print(ctg_id, w, coor,
                          " ".join(sorted(asm.node_to_ctg[w])))
                else:
                    coor += abs(int(b) - int(e))
                    coor_map[ctg_id][w] = coor
                    print(ctg_id, w, coor,
                          " ".join(sorted(asm.node_to_ctg[w])))
    return 0


if __name__ == "__main__":
    sys.exit(main())
