"""Unitig and contig-path construction over the string graph.

Semantically exact reimplementation of the unitig phase of the reference
assembler (reference: falcon_kit/mains/ovlp_to_graph.py:907-1551):

  * identify_simple_paths        -- ovlp_to_graph.py:1029-1140
  * identify_spurs               -- ovlp_to_graph.py:1143-1216
  * remove_dup_simple_path       -- ovlp_to_graph.py:1219-1243
  * find_bundle / compound paths -- ovlp_to_graph.py:461-651, 907-1026
  * construct_c_path_from_utgs   -- ovlp_to_graph.py:1246-1356
  * ovlp_to_graph driver         -- ovlp_to_graph.py:1359-1551 (writes
    sg_edges_list, chimers_nodes, c_path, utg_data, ctg_paths)

Determinism policy: wherever the reference pops python sets of str nodes
(order depends on PYTHONHASHSEED, so the reference is not reproducible with
itself), we use insertion-ordered structures.  All dict-order-driven
behavior is preserved exactly.

Quirk-compatibility kept on purpose (see inline notes): compound-utg
best-in test compares the bundle-edge KEY with the target node
(ovlp_to_graph.py:1320-1327); circular contigs print with "%6d" and no
F/R suffix (ovlp_to_graph.py:1547).
"""
import logging

from .sg import reverse_end, build_string_graph

LOG = logging.getLogger(__name__)


class NoPathError(Exception):
    pass


class PopSet:
    """A pop-able working set with two orderings.

    deterministic mode (default): insertion-ordered (LIFO pop) -- makes
    falcon_tpu_torch output reproducible across runs.
    compat mode: a real python set with set.pop() -- bit-compatible with
    the reference's hash-ordered traversal when run in the same
    interpreter (the reference's own output depends on PYTHONHASHSEED
    through these pops; see tests/test_stage2_parity.py).
    """

    def __init__(self, items=(), compat=False):
        self.compat = compat
        self._d = set(items) if compat else dict.fromkeys(items)

    def add(self, x):
        if self.compat:
            self._d.add(x)
        else:
            self._d[x] = None

    def pop(self):
        if self.compat:
            return self._d.pop()
        k, _ = self._d.popitem()
        return k

    def peek(self):
        """First element without removing (the reference pops and
        re-adds, ovlp_to_graph.py:1069-1070)."""
        if self.compat:
            e = self._d.pop()
            self._d.add(e)
            return e
        return next(iter(self._d))

    def remove(self, x):
        if self.compat:
            self._d.remove(x)
        else:
            del self._d[x]

    def discard(self, x):
        if self.compat:
            self._d.discard(x)
        else:
            self._d.pop(x, None)

    def __contains__(self, x):
        return x in self._d

    def __len__(self):
        return len(self._d)

    def __iter__(self):
        return iter(self._d)


def nx1_bidirectional_shortest_path(successors, predecessors, source,
                                    target):
    """Unweighted shortest path with networkx-1.x bidirectional BFS
    semantics (meet-in-the-middle, smaller fringe expanded first, first
    meeting node wins).  successors/predecessors: node -> neighbor list in
    adjacency order."""
    if source == target:
        return [source]
    pred = {source: None}
    succ = {target: None}
    forward = [source]
    reverse = [target]
    meet = None
    while forward and reverse and meet is None:
        if len(forward) <= len(reverse):
            level, forward = forward, []
            for v in level:
                for w in successors(v):
                    if w not in pred:
                        forward.append(w)
                        pred[w] = v
                    if w in succ:
                        meet = w
                        break
                if meet is not None:
                    break
        else:
            level, reverse = reverse, []
            for v in level:
                for w in predecessors(v):
                    if w not in succ:
                        succ[w] = v
                        reverse.append(w)
                    if w in pred:
                        meet = w
                        break
                if meet is not None:
                    break
    if meet is None:
        raise NoPathError("no path %s -> %s" % (source, target))
    path = []
    w = meet
    while w is not None:
        path.append(w)
        w = pred[w]
    path.reverse()
    w = succ[meet]
    while w is not None:
        path.append(w)
        w = succ[w]
    return path


class MultiDiGraph:
    """Minimal keyed multigraph: edges are (s, t, key) with insertion-order
    adjacency (what networkx 1.x gave the reference)."""

    def __init__(self):
        self._nodes = {}          # node -> None (ordered set)
        self.out = {}             # node -> list[(s, t, k)]
        self.inc = {}             # node -> list[(s, t, k)]
        self.edge_set = set()

    def add_node(self, n):
        if n not in self._nodes:
            self._nodes[n] = None
            self.out[n] = []
            self.inc[n] = []

    def add_edge(self, s, t, key):
        self.add_node(s)
        self.add_node(t)
        e = (s, t, key)
        if e in self.edge_set:
            return
        self.edge_set.add(e)
        self.out[s].append(e)
        self.inc[t].append(e)

    def remove_edge(self, s, t, key):
        e = (s, t, key)
        if e not in self.edge_set:
            raise KeyError(e)
        self.edge_set.remove(e)
        self.out[s].remove(e)
        self.inc[t].remove(e)

    def has_edge(self, s, t, key):
        return (s, t, key) in self.edge_set

    def nodes(self):
        return list(self._nodes)

    def edges(self):
        out = []
        for n in self._nodes:
            out.extend(self.out[n])
        return out

    def out_edges(self, n):
        return list(self.out.get(n, ()))

    def in_edges(self, n):
        return list(self.inc.get(n, ()))

    def out_degree(self, n):
        return len(self.out.get(n, ()))

    def in_degree(self, n):
        return len(self.inc.get(n, ()))

    def copy(self):
        g = MultiDiGraph()
        for n in self._nodes:
            g.add_node(n)
        for n in self._nodes:
            for (s, t, k) in self.out[n]:
                g.add_edge(s, t, k)
        return g

    def ego_nodes(self, start, radius):
        """Nodes reachable from start within `radius` hops following out
        edges (nx.ego_graph node set), in BFS discovery order."""
        dist = {start: 0}
        order = [start]
        frontier = [start]
        d = 0
        while frontier and d < radius:
            nxt = []
            for v in frontier:
                for (_, w, _k) in self.out.get(v, ()):
                    if w not in dist:
                        dist[w] = d + 1
                        order.append(w)
                        nxt.append(w)
            frontier = nxt
            d += 1
        return order

    def ego_subgraph(self, start, radius):
        """Induced subgraph on ego_nodes (like nx.ego_graph)."""
        nodes = self.ego_nodes(start, radius)
        nodeset = set(nodes)
        g = MultiDiGraph()
        for n in nodes:
            g.add_node(n)
        for n in nodes:
            for (s, t, k) in self.out[n]:
                if t in nodeset:
                    g.add_edge(s, t, k)
        return g

    def bfs_path(self, src, dst):
        """Unweighted shortest path with networkx-1.x bidirectional-BFS
        semantics (tie behavior identical to the reference's
        nx.shortest_path)."""
        return nx1_bidirectional_shortest_path(
            lambda v: [w for (_, w, _k) in self.out.get(v, ())],
            lambda v: [u for (u, _, _k) in self.inc.get(v, ())],
            src, dst)


class DiGraph:
    """Simple digraph with insertion-ordered adjacency (for sg2)."""

    def __init__(self):
        self._nodes = {}
        self.out = {}
        self.inc = {}

    def add_node(self, n):
        if n not in self._nodes:
            self._nodes[n] = None
            self.out[n] = []
            self.inc[n] = []

    def add_edge(self, s, t):
        self.add_node(s)
        self.add_node(t)
        if (s, t) not in set(self.out[s]):
            self.out[s].append((s, t))
            self.inc[t].append((s, t))

    def nodes(self):
        return list(self._nodes)

    def edges(self):
        out = []
        for n in self._nodes:
            out.extend(self.out[n])
        return out

    def out_edges(self, n):
        return list(self.out.get(n, ()))

    def in_edges(self, n):
        return list(self.inc.get(n, ()))


def identify_simple_paths(sg2, edge_data, compat=False):
    """Maximal simple paths of the reduced graph + their reverse duals
    (reference: identify_simple_paths, ovlp_to_graph.py:1029-1140)."""
    simple_paths = {}
    s_nodes = PopSet(compat=compat)
    simple_nodes = set()
    for n in sg2.nodes():
        ind = len(sg2.in_edges(n))
        outd = len(sg2.out_edges(n))
        if ind == 1 and outd == 1:
            simple_nodes.add(n)
        else:
            if outd != 0:
                s_nodes.add(n)

    free_edges = PopSet(sg2.edges(), compat=compat)

    while free_edges:
        if s_nodes:
            n = s_nodes.pop()
        else:
            n = free_edges.peek()[0]

        for (v, w) in sg2.out_edges(n):
            if (v, w) not in free_edges:
                continue
            rv, rw = reverse_end(v), reverse_end(w)

            path = [v, w]
            path_edges = {(v, w)}
            path_length = edge_data[(v, w)][3]
            path_score = edge_data[(v, w)][4]
            free_edges.remove((v, w))
            v0, w0 = v, w

            r_path = [rv, rw]
            r_path_edges = {(rw, rv)}
            r_path_length = edge_data[(rw, rv)][3]
            r_path_score = edge_data[(rw, rv)][4]
            free_edges.remove((rw, rv))
            rv0, rw0 = rv, rw

            while w in simple_nodes:
                w, w_ = sg2.out_edges(w)[0]
                if (w, w_) not in free_edges:
                    break
                rw_, rw = reverse_end(w_), reverse_end(w)
                if (rw_, rw) in path_edges:
                    break
                path.append(w_)
                path_edges.add((w, w_))
                path_length += edge_data[(w, w_)][3]
                path_score += edge_data[(w, w_)][4]
                free_edges.remove((w, w_))

                r_path.append(rw_)
                r_path_edges.add((rw_, rw))
                r_path_length += edge_data[(rw_, rw)][3]
                r_path_score += edge_data[(rw_, rw)][4]
                free_edges.remove((rw_, rw))
                w = w_

            simple_paths[(v0, w0, path[-1])] = (path_length, path_score, path)
            r_path.reverse()
            assert r_path[0] == reverse_end(path[-1])
            simple_paths[(r_path[0], rw0, rv0)] = (
                r_path_length, r_path_score, r_path)
    return simple_paths


def identify_spurs(ug, u_edge_data, spur_len, compat=False):
    """Remove short dead-end paths feeding into branch nodes
    (reference: identify_spurs, ovlp_to_graph.py:1143-1216).
    Side effect: marks removed utg edges "spur:2" in u_edge_data."""
    ug2 = ug.copy()
    s_candidates = PopSet((v for v in ug2.nodes() if ug2.in_degree(v) == 0),
                          compat=compat)

    while s_candidates:
        n = s_candidates.pop()
        if ug2.in_degree(n) != 0:
            continue
        ego = ug2.ego_nodes(n, 10)
        ego_set = set(ego)
        for b_node in ego:
            if ug2.in_degree(b_node) <= 1:
                continue
            b_in_nodes = [e[0] for e in ug2.in_edges(b_node)]
            if len(b_in_nodes) == 1:
                continue
            if not any(v not in ego_set for v in b_in_nodes):
                continue

            s_path = ug2.bfs_path(n, b_node)
            total_length = 0
            v1 = s_path[0]
            for v2 in s_path[1:]:
                for (s, t, v) in ug2.out_edges(v1):
                    if t != v2:
                        continue
                    total_length += u_edge_data[(s, t, v)][0]
                v1 = v2
            if total_length >= spur_len:
                continue

            v1 = s_path[0]
            for v2 in s_path[1:]:
                for (s, t, v) in ug2.out_edges(v1):
                    if t != v2:
                        continue
                    length, score, edges, type_ = u_edge_data[(s, t, v)]
                    rs, rt = reverse_end(t), reverse_end(s)
                    rv = reverse_end(v) if v != "NA" else "NA"
                    try:
                        ug2.remove_edge(s, t, v)
                        ug2.remove_edge(rs, rt, rv)
                        u_edge_data[(s, t, v)] = (length, score, edges, "spur:2")
                        u_edge_data[(rs, rt, rv)] = (length, score, edges, "spur:2")
                    except KeyError:
                        pass
                if ug2.in_degree(v2) == 0:
                    s_candidates.add(v2)
                v1 = v2
            break
    return ug2


def remove_dup_simple_path(ug, u_edge_data):
    """Keep one of several parallel short simple paths s->t
    (reference: remove_dup_simple_path, ovlp_to_graph.py:1219-1243)."""
    ug2 = ug.copy()
    simple_edges = set()
    dup_edges = {}
    for (s, t, v), (length, score, edges, type_) in u_edge_data.items():
        if len(edges) > 3:
            continue
        if type_ == "simple":
            if (s, t) in simple_edges:
                dup_edges[(s, t)].append(v)
            else:
                simple_edges.add((s, t))
                dup_edges[(s, t)] = [v]
    for (s, t), vl in dup_edges.items():
        vl.sort()
        for v in vl[1:]:
            ug2.remove_edge(s, t, v)
            length, score, edges, type_ = u_edge_data[(s, t, v)]
            u_edge_data[(s, t, v)] = (length, score, edges, "simple_dup")
    return ug2


def find_bundle(ug, u_edge_data, start_node, depth_cutoff, width_cutoff,
                length_cutoff, compat=False):
    """Grow a bubble bundle from a branch node until it reconverges
    (reference: find_bundle, ovlp_to_graph.py:461-651).  tips and bundle
    edges are kept in insertion order unless compat (then: real sets, the
    reference's hash-ordered iteration)."""
    tips = PopSet(compat=compat)
    bundle_edges = PopSet(compat=compat)
    bundle_nodes = set()

    local_graph = ug.ego_subgraph(start_node, depth_cutoff)
    length_to_node = {start_node: 0}
    score_to_node = {start_node: 0}
    end_node = start_node

    bundle_nodes.add(start_node)
    for (vv, ww, kk) in local_graph.out_edges(start_node):
        if (vv, ww, kk) not in bundle_edges and \
                reverse_end(ww) not in bundle_nodes:
            bundle_edges.add((vv, ww, kk))
            tips.add(ww)
    for v in list(tips):
        bundle_nodes.add(v)

    depth = 1
    converage = False

    while True:
        if len(tips) > 4:
            converage = False
            break
        if len(tips) == 1:
            end_node = tips.pop()
            if end_node not in length_to_node:
                v = end_node
                max_score_edge = None
                max_score = 0
                for (uu, vv, kk) in local_graph.in_edges(v):
                    if uu not in length_to_node:
                        continue
                    score = u_edge_data[(uu, vv, kk)][1]
                    if score > max_score:
                        max_score = score
                        max_score_edge = (uu, vv, kk)
                length_to_node[v] = (length_to_node[max_score_edge[0]] +
                                     u_edge_data[max_score_edge][0])
                score_to_node[v] = (score_to_node[max_score_edge[0]] +
                                    u_edge_data[max_score_edge][1])
            converage = True
            break

        depth += 1
        width = 1.0 * len(bundle_edges) / depth
        if depth > 10 and width > width_cutoff:
            converage = False
            break
        if depth > depth_cutoff:
            converage = False
            break

        tips_list = list(tips)
        tip_updated = False
        loop_detect = False
        length_limit_reached = False

        for v in tips_list:
            if len(local_graph.out_edges(v)) == 0:  # dead end route
                LOG.debug("find_bundle: no out edge %s", v)
                continue
            max_score_edge = None
            max_score = 0
            extend_tip = True
            for (uu, vv, kk) in local_graph.in_edges(v):
                if uu not in length_to_node:
                    extend_tip = False
                    break
                score = u_edge_data[(uu, vv, kk)][1]
                if score > max_score:
                    max_score = score
                    max_score_edge = (uu, vv, kk)

            if extend_tip:
                length_to_node[v] = (length_to_node[max_score_edge[0]] +
                                     u_edge_data[max_score_edge][0])
                score_to_node[v] = (score_to_node[max_score_edge[0]] +
                                    u_edge_data[max_score_edge][1])
                if length_to_node[v] > length_cutoff:
                    length_limit_reached = True
                    converage = False
                    break

                v_updated = False
                for (vv, ww, kk) in local_graph.out_edges(v):
                    if ww in length_to_node:
                        loop_detect = True
                        break
                    if (vv, ww, kk) not in bundle_edges and \
                            reverse_end(ww) not in bundle_nodes:
                        tips.add(ww)
                        bundle_edges.add((vv, ww, kk))
                        tip_updated = True
                        v_updated = True
                if v_updated:
                    tips.remove(v)
                    if len(tips) == 1:
                        break
            if loop_detect:
                converage = False
                break

        if length_limit_reached or loop_detect:
            converage = False
            break
        if not tip_updated:
            converage = False
            break
        for v in list(tips):
            bundle_nodes.add(v)

    # bundle edges kept as an insertion-ordered list (the reference uses a
    # set whose iteration order leaks into c_path/utg_data line contents)
    data = (start_node, end_node, list(bundle_edges),
            length_to_node[end_node], score_to_node[end_node], depth)
    return converage, data, None


def construct_compound_paths(ug, u_edge_data, compat=False):
    """Consistent, complement-closed bubble bundles
    (reference: construct_compound_paths, ovlp_to_graph.py:907-1026)."""
    branch_nodes = set()
    branch_order = []
    for n in ug.nodes():
        if ug.in_degree(n) > 1 or ug.out_degree(n) > 1:
            branch_nodes.add(n)
            branch_order.append(n)
    if compat:
        branch_order = list(branch_nodes)

    compound_paths_0 = []
    for p in branch_order:
        if ug.out_degree(p) > 1:
            coverage, data, _ = find_bundle(ug, u_edge_data, p, 48, 16,
                                            500000, compat=compat)
            if coverage is True:
                start_node, end_node, bundle_edges, length, score, depth = data
                compound_paths_0.append(
                    (start_node, "NA", end_node,
                     1.0 * len(bundle_edges) / depth, length, score,
                     bundle_edges))

    compound_paths_0.sort(key=lambda x: -len(x[6]))

    edge_to_cpath = {}
    compound_paths_1 = {}
    for s, v, t, width, length, score, bundle_edges in compound_paths_0:
        overlapped = False
        for (vv, ww, kk) in list(bundle_edges):
            if (vv, ww, kk) in edge_to_cpath:
                overlapped = True
                break
            rkk = reverse_end(kk) if kk != "NA" else "NA"
            if (reverse_end(ww), reverse_end(vv), rkk) in edge_to_cpath:
                overlapped = True
                break
        if overlapped:
            continue

        bundle_edges_r = []
        rs = reverse_end(t)
        rt = reverse_end(s)
        for (vv, ww, kk) in list(bundle_edges):
            edge_to_cpath.setdefault((vv, ww, kk), set()).add((s, t, v))
            rvv = reverse_end(ww)
            rww = reverse_end(vv)
            rkk = reverse_end(kk) if kk != "NA" else "NA"
            edge_to_cpath.setdefault((rvv, rww, rkk), set()).add((rs, rt, v))
            bundle_edges_r.append((rvv, rww, rkk))
        compound_paths_1[(s, v, t)] = width, length, score, bundle_edges
        compound_paths_1[(rs, v, rt)] = width, length, score, bundle_edges_r

    compound_paths_2 = {}
    edge_to_cpath = {}
    for (s, v, t) in compound_paths_1:
        rs = reverse_end(t)
        rt = reverse_end(s)
        if (rs, "NA", rt) not in compound_paths_1:
            continue
        width, length, score, bundle_edges = compound_paths_1[(s, v, t)]
        compound_paths_2[(s, v, t)] = width, length, score, bundle_edges
        for (vv, ww, kk) in list(bundle_edges):
            edge_to_cpath.setdefault((vv, ww, kk), set()).add((s, t, v))

    compound_paths_3 = {}
    for k, val in compound_paths_2.items():
        start_node, _NA, end_node = k
        assert (reverse_end(end_node), "NA",
                reverse_end(start_node)) in compound_paths_2
        contained = False
        for (vv, ww, kk) in ug.out_edges(start_node):
            if len(edge_to_cpath.get((vv, ww, kk), ())) > 1:
                contained = True
        if not contained:
            compound_paths_3[k] = val

    compound_paths = {}
    for (s, v, t) in compound_paths_3:
        rs = reverse_end(t)
        rt = reverse_end(s)
        if (rs, "NA", rt) not in compound_paths_3:
            continue
        compound_paths[(s, v, t)] = compound_paths_3[(s, v, t)]
    return compound_paths


def construct_c_path_from_utgs(ug, u_edge_data, best_in_of, compat=False):
    """Chain unitigs into contig paths, stopping at multi-in nodes unless
    the incoming path is the best-in edge (reference:
    construct_c_path_from_utgs, ovlp_to_graph.py:1246-1356)."""
    s_nodes = PopSet(compat=compat)
    simple_out = set()
    for n in ug.nodes():
        ind = ug.in_degree(n)
        outd = ug.out_degree(n)
        if not (ind == 1 and outd == 1):
            if outd != 0:
                s_nodes.add(n)
        if outd == 1:
            simple_out.add(n)

    c_path = []
    free_edges = PopSet(ug.edges(), compat=compat)

    while free_edges:
        if s_nodes:
            n = s_nodes.pop()
        else:
            n = free_edges.peek()[0]

        for (s, t, v) in ug.out_edges(n):
            path_start = n
            path_key = t
            path = []
            path_length = 0
            path_score = 0
            path_nodes = {s}
            t0 = s
            while t in simple_out:
                if t in path_nodes:
                    break
                if reverse_end(t) in path_nodes:
                    break
                length, score, path_or_edges, type_ = u_edge_data[(t0, t, v)]

                # If the next node has >1 in-edges, only extend through the
                # best-in edge (ovlp_to_graph.py:1306-1328).  In --lfc
                # mode the reference never populates best_in (only
                # mark_best_overlap does) and CRASHES with KeyError at
                # this line on any multi-in-edge junction
                # (ovlp_to_graph.py:1314); .get() makes the missing-entry
                # case terminate the extension instead -- the
                # conservative choice the surrounding reference comment
                # describes ("Otherwise, we will terminate").
                if len(ug.in_edges(t)) > 1:
                    best_in_node = best_in_of.get(t)
                    if type_ == "simple" and \
                            best_in_node != path_or_edges[-2]:
                        break
                    if type_ == "compound":
                        # quirk-compatible: compares each bundle-edge KEY
                        # (via node) to t, which practically never matches,
                        # so compound utgs stop here (ovlp_to_graph.py:1320)
                        t_in_nodes = set()
                        for (ss, vv, tt) in path_or_edges:
                            if tt != t:
                                continue
                            (length, score,
                             path_or_edges, type_) = u_edge_data[(ss, vv, tt)]
                            if path_or_edges[-1] == tt:
                                t_in_nodes.add(path_or_edges[-2])
                        if best_in_node not in t_in_nodes:
                            break

                path.append((t0, t, v))
                path_nodes.add(t)
                path_length += length
                path_score += score
                assert len(ug.out_edges(t)) == 1
                t0, t, v = ug.out_edges(t)[0]

            path.append((t0, t, v))
            length, score, path_or_edges, type_ = u_edge_data[(t0, t, v)]
            path_length += length
            path_score += score
            path_nodes.add(t)
            path_end = t

            c_path.append((path_start, path_key, path_end,
                           path_length, path_score, path, len(path)))
            for e in path:
                free_edges.discard(e)
    return c_path


def ovlp_to_graph(overlap_file, out_dir=".", min_len=4000, min_idt=96.0,
                  lfc=False, disable_chimer_bridge_removal=False,
                  set_order_compat=False):
    """Full stage-2 graph construction: preads.ovl -> sg_edges_list,
    chimers_nodes, c_path, utg_data, ctg_paths (reference: ovlp_to_graph,
    ovlp_to_graph.py:1359-1551 + CLI defaults :1554-1576)."""
    import os

    def opath(name):
        return os.path.join(out_dir, name)

    def read_lines():
        with open(overlap_file) as f:
            n = 0
            for line in f:
                if line.startswith("-"):
                    break
                yield line.strip().split()
                n += 1
            else:
                raise Exception(
                    "No end-of-file marker for overlap_file %r after %d lines."
                    % (overlap_file, n))

    chimer_f = None
    if not disable_chimer_bridge_removal:
        chimer_f = open(opath("chimers_nodes"), "w")
    sg_, edge_lines, edge_data, best_in_of = build_string_graph(
        read_lines(), min_len=min_len, min_idt=min_idt, lfc=lfc,
        disable_chimer_bridge_removal=disable_chimer_bridge_removal,
        chimer_nodes_out=chimer_f)
    if chimer_f:
        chimer_f.close()
    with open(opath("sg_edges_list"), "w") as f:
        for line in edge_lines:
            f.write(line + "\n")

    # reduced graph of G edges
    sg2 = DiGraph()
    for (v, w) in edge_data:
        assert (reverse_end(w), reverse_end(v)) in edge_data
        sg2.add_edge(v, w)

    simple_paths = identify_simple_paths(sg2, edge_data,
                                         compat=set_order_compat)

    ug = MultiDiGraph()
    u_edge_data = {}
    circular_path = PopSet(compat=set_order_compat)
    for (s, v, t), (length, score, path) in simple_paths.items():
        u_edge_data[(s, t, v)] = (length, score, path, "simple")
        if s != t:
            ug.add_edge(s, t, v)
        else:
            circular_path.add((s, t, v))

    ug2 = identify_spurs(ug, u_edge_data, 50000,
                         compat=set_order_compat)
    ug2 = remove_dup_simple_path(ug2, u_edge_data)

    compound_paths = construct_compound_paths(
        ug2, u_edge_data, compat=set_order_compat)

    ug2_edges = set(ug2.edges())
    edges_to_remove = set()
    with open(opath("c_path"), "w") as cpf:
        for (s, v, t), (width, length, score, bundle_edges) in \
                compound_paths.items():
            cpf.write("%s %s %s %s %s %s %s\n" % (
                s, v, t, width, length, score,
                "|".join(e[0] + "~" + e[2] + "~" + e[1]
                         for e in bundle_edges)))
            for (ss, tt, vv) in bundle_edges:
                if (ss, tt, vv) in ug2_edges:
                    edges_to_remove.add((ss, tt, vv))

    for (s, t, v) in edges_to_remove:
        ug2.remove_edge(s, t, v)
        length, score, edges, type_ = u_edge_data[(s, t, v)]
        if type_ != "spur":
            u_edge_data[(s, t, v)] = (length, score, edges, "contained")

    for (s, v, t), (width, length, score, bundle_edges) in \
            compound_paths.items():
        u_edge_data[(s, t, v)] = (length, score, bundle_edges, "compound")
        ug2.add_edge(s, t, v)
        assert v == "NA"
        assert (reverse_end(t), v, reverse_end(s)) in compound_paths

    # remove short repeat-bridge utgs (ovlp_to_graph.py:1452-1466)
    ug_edge_to_remove = set()
    for (s, t, v) in ug2.edges():
        if ug2.in_degree(s) == 1 and ug2.out_degree(s) == 2 and \
                ug2.in_degree(t) == 2 and ug2.out_degree(t) == 1:
            length = u_edge_data[(s, t, v)][0]
            if length < 60000:
                rs, rt = reverse_end(t), reverse_end(s)
                rv = reverse_end(v) if v != "NA" else "NA"
                ug_edge_to_remove.add((s, t, v))
                ug_edge_to_remove.add((rs, rt, rv))
    for (s, t, v) in list(ug_edge_to_remove):
        ug2.remove_edge(s, t, v)
        length, score, edges, type_ = u_edge_data[(s, t, v)]
        u_edge_data[(s, t, v)] = (length, score, edges, "repeat_bridge")

    ug = ug2
    ug2 = identify_spurs(ug, u_edge_data, 80000,
                         compat=set_order_compat)
    ug = ug2

    with open(opath("utg_data"), "w") as f:
        for (s, t, v), (length, score, path_or_edges, type_) in \
                u_edge_data.items():
            if v == "NA":
                path_str = "|".join(ss + "~" + vv + "~" + tt
                                    for (ss, tt, vv) in path_or_edges)
            else:
                path_str = "~".join(path_or_edges)
            f.write("%s %s %s %s %s %s %s\n" % (
                s, v, t, type_, length, score, path_str))

    c_path = construct_c_path_from_utgs(
        ug, u_edge_data, best_in_of, compat=set_order_compat)

    free_edges = set(ug.edges())
    ctg_id = 0
    c_path.sort(key=lambda x: -x[3])

    with open(opath("ctg_paths"), "w") as ctg_f:
        for (path_start, path_key, path_end, p_len, p_score, path,
             n_edges) in c_path:
            length = 0
            score = 0
            length_r = 0
            score_r = 0
            non_overlapped_path = []
            non_overlapped_path_r = []
            for (s, t, v) in path:
                if v != "NA":
                    rs, rt, rv = reverse_end(t), reverse_end(s), reverse_end(v)
                else:
                    rs, rt, rv = reverse_end(t), reverse_end(s), "NA"
                if (s, t, v) in free_edges and (rs, rt, rv) in free_edges:
                    non_overlapped_path.append((s, t, v))
                    non_overlapped_path_r.append((rs, rt, rv))
                    length += u_edge_data[(s, t, v)][0]
                    score += u_edge_data[(s, t, v)][1]
                    length_r += u_edge_data[(rs, rt, rv)][0]
                    score_r += u_edge_data[(rs, rt, rv)][1]
                else:
                    break
            if not non_overlapped_path:
                continue
            s0, t0, v0 = non_overlapped_path[0]
            end_node = non_overlapped_path[-1][1]
            c_type_ = "ctg_linear" if (end_node != s0) else "ctg_circular"

            ctg_f.write("%06dF %s %s %s %s %s %s\n" % (
                ctg_id, c_type_, s0 + "~" + v0 + "~" + t0, end_node,
                length, score,
                "|".join(c[0] + "~" + c[2] + "~" + c[1]
                         for c in non_overlapped_path)))
            non_overlapped_path_r.reverse()
            s0, t0, v0 = non_overlapped_path_r[0]
            end_node = non_overlapped_path_r[-1][1]
            ctg_f.write("%06dR %s %s %s %s %s %s\n" % (
                ctg_id, c_type_, s0 + "~" + v0 + "~" + t0, end_node,
                length_r, score_r,
                "|".join(c[0] + "~" + c[2] + "~" + c[1]
                         for c in non_overlapped_path_r)))
            ctg_id += 1
            for e in non_overlapped_path:
                free_edges.discard(e)
            for e in non_overlapped_path_r:
                free_edges.discard(e)

        for (s, t, v) in list(circular_path):
            length, score, path, type_ = u_edge_data[(s, t, v)]
            # quirk-compatible "%6d" (width-6, no F/R) for circular-only
            # contigs (ovlp_to_graph.py:1547)
            ctg_f.write("%6d %s %s %s %s %s %s\n" % (
                ctg_id, "ctg_circular", s + "~" + v + "~" + t, t,
                length, score, s + "~" + v + "~" + t))
            ctg_id += 1
