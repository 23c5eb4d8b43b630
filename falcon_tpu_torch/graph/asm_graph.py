"""Assembly-graph loader: sg_edges_list + utg_data + ctg_paths as one
queryable object (exact reimplementation of reference
falcon_kit/fc_asm_graph.py AsmGraph)."""
from ..io import fasta
from .to_contig import rc


class AsmGraph:
    def __init__(self, sg_file, utg_file, ctg_file):
        self.sg_edges = {}
        self.sg_edge_seqs = {}
        self.utg_data = {}
        self.ctg_data = {}
        self.utg_to_ctg = {}
        self.node_to_ctg = {}
        self.node_to_utg = {}
        self._load_sg(sg_file)
        self._load_utg(utg_file)
        self._load_ctg(ctg_file)
        self._build_node_map()

    def _load_sg(self, sg_file):
        with open(sg_file) as f:
            for line in f:
                l = line.strip().split()
                v, w = l[0:2]
                seq_id = l[2]
                b, e = int(l[3]), int(l[4])
                score, idt = int(l[5]), float(l[6])
                type_ = l[7]
                self.sg_edges[(v, w)] = ((seq_id, b, e), score, idt, type_)

    def load_sg_seq(self, fasta_fn):
        all_read_ids = set()
        for (v, w), data in self.sg_edges.items():
            if data[-1] != "G":
                continue
            all_read_ids.add(v.split(":")[0])
            all_read_ids.add(w.split(":")[0])
        seqs = {}
        for r in fasta.read_fasta(fasta_fn):
            if r.name in all_read_ids:
                seqs[r.name] = r.sequence.upper()
        for (v, w), data in self.sg_edges.items():
            (seq_id, s, t), _, _, type_ = data
            if type_ != "G":
                continue
            if s < t:
                self.sg_edge_seqs[(v, w)] = seqs[seq_id][s:t]
            else:
                self.sg_edge_seqs[(v, w)] = rc(seqs[seq_id][t:s])

    def get_seq_from_path(self, path):
        if not self.sg_edge_seqs:
            return ""
        v = path[0]
        out = []
        for w in path[1:]:
            out.append(self.sg_edge_seqs[(v, w)])
            v = w
        return "".join(out)

    def _load_utg(self, utg_file):
        with open(utg_file) as f:
            for line in f:
                l = line.strip().split()
                s, v, t = l[0:3]
                type_ = l[3]
                length, score = int(l[4]), int(l[5])
                self.utg_data[(s, t, v)] = (type_, length, score, l[6])

    def _load_ctg(self, ctg_file):
        with open(ctg_file) as f:
            for line in f:
                l = line.strip().split()
                ctg_id, ctg_type = l[0:2]
                start_edge, end_node = l[2], l[3]
                length, score = int(l[4]), int(l[5])
                path = tuple(e.split("~") for e in l[6].split("|"))
                self.ctg_data[ctg_id] = (ctg_type, start_edge, end_node,
                                         length, score, path)
                for (s, v, t) in path:
                    type_, _, _, path_or_edges = self.utg_data[(s, t, v)]
                    if type_ != "compound":
                        self.utg_to_ctg[(s, t, v)] = ctg_id
                    else:
                        for svt in path_or_edges.split("|"):
                            s2, v2, t2 = svt.split("~")
                            self.utg_to_ctg[(s2, t2, v2)] = ctg_id

    def _paths_of_utg(self, utg_key):
        type_, length, score, path_or_edges = self.utg_data[utg_key]
        if type_ == "compound":
            for svt in path_or_edges.split("|"):
                s, v, t = svt.split("~")
                yield self.utg_data[(s, t, v)][3].split("~")
        else:
            yield path_or_edges.split("~")

    def get_sg_for_utg(self, utg_key):
        """Node-path edge set of one unitig as {node: set(successors)}."""
        adj = {}
        for one_path in self._paths_of_utg(utg_key):
            for a, b in zip(one_path[:-1], one_path[1:]):
                adj.setdefault(a, set()).add(b)
                adj.setdefault(b, set())
        return adj

    def get_sg_for_ctg(self, ctg_id):
        adj = {}
        for (s, v, t) in self.ctg_data[ctg_id][-1]:
            type_ = self.utg_data[(s, t, v)][0]
            if type_ in ("simple", "compound"):
                for one_path in self._paths_of_utg((s, t, v)):
                    for a, b in zip(one_path[:-1], one_path[1:]):
                        adj.setdefault(a, set()).add(b)
                        adj.setdefault(b, set())
        return adj

    def _build_node_map(self):
        for ctg_id in self.ctg_data:
            for n in self.get_sg_for_ctg(ctg_id):
                self.node_to_ctg.setdefault(n, set()).add(ctg_id)
        for u_id, data in self.utg_data.items():
            if data[0] == "compound":
                continue
            for n in self.get_sg_for_utg(u_id):
                self.node_to_utg.setdefault(n, set()).add(u_id)
