"""Tiling-path model: parse, node coordinates, subpaths, a_ctg placement.

Exact reimplementation of the reference tiling-path library
(reference: falcon_kit/tiling_path.py): TilingPathEdge rows
"ctg v w wrid b e score idt", per-node contig coordinates via cumulative
|b-e| (calc_node_coords, tiling_path.py:111-136), subpath extraction
(tiling_path.py:67-109), and a_ctg-on-p_ctg placement
(tiling_path.py:182-198).
"""


class TilingPathEdge:
    __slots__ = ("ctg_id", "v", "w", "wrid", "b", "e", "score", "identity",
                 "parsed")

    def __init__(self, split_line=None):
        self.ctg_id = self.v = self.w = self.wrid = None
        self.b = self.e = self.score = self.identity = None
        self.parsed = False
        if split_line:
            self.set_from(split_line)

    def set_from(self, sl):
        assert len(sl) >= 8
        self.ctg_id, self.v, self.w, self.wrid = sl[0], sl[1], sl[2], sl[3]
        self.b = int(sl[4])
        self.e = int(sl[5])
        self.score = int(sl[6])
        self.identity = float(sl[7])
        self.parsed = True

    def get_split_line(self):
        return [str(x) for x in (self.ctg_id, self.v, self.w, self.wrid,
                                 self.b, self.e, self.score, self.identity)]


def calc_node_coords(edges, first_node_offset=0):
    """Genomic coordinate of every node in one tiling path."""
    if not edges:
        return {}, 0
    coord = {edges[0].v: first_node_offset}
    contig_len = 0
    for e in edges:
        if e.v not in coord:
            raise Exception(
                "Tiling path is not in sorted order. Node %r does not yet "
                "have an assigned coordinate." % (e.v,))
        c = coord[e.v] + abs(int(e.b) - int(e.e))
        coord[e.w] = c
        contig_len = max(contig_len, c)
    return coord, contig_len


class TilingPath:
    def __init__(self, edges, contig_sequence_len=None):
        self.edges = edges
        for i in range(1, len(edges)):
            assert edges[i - 1].w == edges[i].v
        self.first_node_offset = 0
        if contig_sequence_len is not None:
            _, tiling_len = calc_node_coords(edges)
            assert contig_sequence_len >= tiling_len
            self.first_node_offset = contig_sequence_len - tiling_len
        self.coords, self.contig_len = calc_node_coords(
            edges, self.first_node_offset)
        assert contig_sequence_len is None or \
            self.contig_len == contig_sequence_len
        self.v_to_edge = {}
        self.w_to_edge = {}
        for i, e in enumerate(self.edges):
            self.v_to_edge[e.v] = i
            self.w_to_edge[e.w] = i

    def dump_as_split_lines(self):
        return [e.get_split_line() for e in self.edges]

    def get_subpath(self, start_coord, end_coord):
        assert self.edges
        assert start_coord <= end_coord
        start_edge = None
        end_edge = None
        if start_coord < self.coords[self.edges[0].v]:
            start_edge = 0
        if end_coord <= self.coords[self.edges[0].v]:
            end_edge = 1
        for i, e in enumerate(self.edges):
            if self.coords[e.v] <= start_coord < self.coords[e.w]:
                start_edge = i
            if self.coords[e.v] < end_coord <= self.coords[e.w]:
                end_edge = i + 1
        if end_coord >= self.coords[self.edges[-1].w]:
            end_edge = len(self.edges)
        assert start_edge is not None and end_edge is not None
        new_start = start_coord - self.coords[self.edges[start_edge].v]
        new_end = end_coord - self.coords[self.edges[start_edge].v]
        new_path = [e.get_split_line()
                    for e in self.edges[start_edge:end_edge]]
        return new_path, new_start, new_end


def yield_split_line(fp):
    for line in fp:
        line = line.strip()
        if not line:
            continue
        yield line.split()


def load_tiling_paths(tp_file, contig_lens=None, whitelist_seqs=None):
    with open(tp_file) as fp:
        return load_tiling_paths_from_stream(
            fp, contig_lens=contig_lens, whitelist_seqs=whitelist_seqs)


def load_tiling_paths_from_stream(fp, contig_lens=None, whitelist_seqs=None):
    return load_tiling_paths_from_split_lines(
        list(yield_split_line(fp)), contig_lens=contig_lens,
        whitelist_seqs=whitelist_seqs)


def load_tiling_paths_from_split_lines(split_lines, contig_lens=None,
                                       whitelist_seqs=None):
    groups = {}
    for sl in split_lines:
        e = TilingPathEdge(sl)
        if whitelist_seqs is not None and e.ctg_id not in whitelist_seqs:
            continue
        groups.setdefault(e.ctg_id, []).append(e)
    paths = {}
    for ctg_id, edges in groups.items():
        ctg_len = None
        if contig_lens is not None and ctg_id in contig_lens:
            ctg_len = contig_lens[ctg_id]
        paths[ctg_id] = TilingPath(edges, ctg_len)
    return paths


def find_a_ctg_placement(p_paths, a_paths):
    """placement[p_ctg_id][a_ctg_id] =
    (start, end, p_ctg_id, a_ctg_id, first_node, last_node)"""
    placement = {}
    for a_ctg_id, a_tp in a_paths.items():
        if not a_tp.edges:
            continue
        first_node = a_tp.edges[0].v
        last_node = a_tp.edges[-1].w
        p_ctg_id = a_ctg_id.split("-")[0].split("_")[0]
        p_tp = p_paths[p_ctg_id]
        start, end = p_tp.coords[first_node], p_tp.coords[last_node]
        placement.setdefault(p_ctg_id, {})[a_ctg_id] = (
            start, end, p_ctg_id, a_ctg_id, first_node, last_node)
    return placement
