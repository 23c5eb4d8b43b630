"""fc_actg_coordinate equivalent: a_ctg coordinates on the primary contig
(reference: falcon_kit/mains/actg_coordinate.py:8-30)."""
import os
import sys

from ..io import fasta


def main(argv=None):
    argv = argv if argv is not None else sys.argv
    out_dir = argv[1] if len(argv) > 1 else "."

    p_ctg_coor_map = {}
    coor = 0
    with open(os.path.join(out_dir, "p_ctg_tiling_path")) as f:
        for row in f:
            row = row.strip().split()
            ctg_id, v, w, edge_rid, b, e = row[:6]
            if ctg_id not in p_ctg_coor_map:
                coor = 0
                p_ctg_coor_map[ctg_id] = {v: 0}
                coor += abs(int(b) - int(e))
                p_ctg_coor_map[ctg_id][w] = coor
            else:
                coor += abs(int(b) - int(e))
                p_ctg_coor_map[ctg_id][w] = coor

    for r in fasta.read_fasta(os.path.join(out_dir, "a_ctg.fa")):
        parts = (r.name + " " + r.comment).split()
        rid, v, w = parts[:3]
        pid = rid.split("-")[0]
        print(rid, p_ctg_coor_map[pid][v], p_ctg_coor_map[pid][w])
    return 0


if __name__ == "__main__":
    sys.exit(main())
