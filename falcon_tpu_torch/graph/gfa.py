"""In-memory GFA model with GFA-1 / GFA-2 writers and JSON round-trip.

Exact-output reimplementation of the reference GFA layer
(reference: falcon_kit/gfa_graph.py): S/L/P lines for GFA-1
(gfa_graph.py:158-187), S/E lines with '$' end-of-sequence markers for
GFA-2 (gfa_graph.py:189-223), JSON (de)serialization (gfa_graph.py:225-238).
"""
import json


class GFAGraph:
    def __init__(self):
        self.nodes = {}
        self.edges = {}
        self.paths = {}

    def add_node(self, name, length, seq="*", tags=None, labels=None):
        if not name:
            raise ValueError("node name must be non-empty")
        if length < 0:
            raise ValueError("node length must be >= 0")
        if not seq:
            raise ValueError("node seq must be non-empty ('*' if unknown)")
        self.nodes[name] = {
            "name": name, "len": length, "seq": seq,
            "tags": tags or {}, "labels": labels or {},
        }

    def add_edge(self, edge_name, source, source_orient, sink, sink_orient,
                 source_start, source_end, sink_start, sink_end, cigar,
                 tags=None, labels=None):
        if source_orient not in "+-" or sink_orient not in "+-":
            raise ValueError("orientation must be '+' or '-'")
        if min(source_start, source_end, sink_start, sink_end) < 0:
            raise ValueError("coordinates must be >= 0")
        if source_end < source_start or sink_end < sink_start:
            raise ValueError("end coordinate must be >= start")
        if not cigar:
            raise ValueError("cigar must be non-empty ('*' if unknown)")
        self.edges[str((source, sink))] = {
            "name": edge_name,
            "v": source, "v_orient": source_orient,
            "w": sink, "w_orient": sink_orient,
            "v_start": source_start, "v_end": source_end,
            "w_start": sink_start, "w_end": sink_end,
            "cigar": cigar, "tags": tags or {}, "labels": labels or {},
        }

    def add_path(self, name, nodes, cigars, tags=None, labels=None):
        if len(nodes) != len(cigars):
            raise ValueError("path nodes and cigars must have equal length")
        self.paths[name] = {
            "name": name, "nodes": nodes, "cigars": cigars,
            "tags": tags or {}, "labels": labels or {},
        }

    def write_gfa_v1(self, fp):
        fp.write("H\tVN:Z:1.0\n")
        for name, nd in self.nodes.items():
            fp.write("\t".join(["S", nd["name"], nd["seq"],
                                "LN:i:%d" % nd["len"]]) + "\n")
        for key, ed in self.edges.items():
            cigar = ed["cigar"]
            if cigar == "*":
                cigar = "%dM" % abs(ed["w_end"] - ed["w_start"])
            fp.write("\t".join(str(x) for x in [
                "L", ed["v"], ed["v_orient"], ed["w"], ed["w_orient"],
                cigar]) + "\n")
        for name, pd in self.paths.items():
            fp.write("\t".join(["P", pd["name"], ",".join(pd["nodes"]),
                                ",".join(pd["cigars"])]) + "\n")

    def write_gfa_v2(self, fp):
        fp.write("H\tVN:Z:2.0\n")
        for name, nd in self.nodes.items():
            fp.write("\t".join(["S", nd["name"], str(nd["len"]),
                                nd["seq"]]) + "\n")
        for key, ed in self.edges.items():
            v_len = self.nodes[ed["v"]]["len"]
            w_len = self.nodes[ed["w"]]["len"]

            def coord(val, ln):
                return str(val) + ("$" if val == ln else "")

            fp.write("\t".join(str(x) for x in [
                "E", ed["name"],
                ed["v"] + ed["v_orient"], ed["w"] + ed["w_orient"],
                coord(ed["v_start"], v_len), coord(ed["v_end"], v_len),
                coord(ed["w_start"], w_len), coord(ed["w_end"], w_len),
                ed["cigar"]]) + "\n")


def serialize_gfa(g):
    return json.dumps({"nodes": g.nodes, "edges": g.edges, "paths": g.paths})


def deserialize_gfa(fp):
    d = json.load(fp)
    g = GFAGraph()
    g.nodes = d["nodes"]
    g.edges = d["edges"]
    g.paths = d["paths"]
    return g
