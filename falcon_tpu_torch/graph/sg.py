"""String graph construction and edge classification.

Semantically exact reimplementation of the string-graph phase of the
reference assembler (reference: falcon_kit/mains/ovlp_to_graph.py:17-905):
overlap records -> bidirected string graph over read-end nodes "id:B"/"id:E"
-> Myers-style transitive reduction (FUZZ=500) -> chimer removal by
flow-neighborhood BFS -> spur removal -> knot resolution by best-overlap
(or local-flow-consistency) -> sg_edges_list emission.

Determinism: the reference iterates python sets of node objects in places
(chimer candidates, ovlp_to_graph.py:154), which is address-ordered and not
reproducible even for the reference itself; we iterate in node insertion
order instead.  Everything else follows the reference's dict-insertion /
stable-sort order so emitted files match a reference run line for line.

Edge attributes are tuples: (label_rid, label_sp, label_tp, length, score,
identity).  Edge classification codes: G (graph), TR (transitive), C
(chimer), R (repeat/removed), S (spur).
"""


def reverse_end(node):
    """'123:B' <-> '123:E' (reference: ovlp_to_graph.py:48-56)."""
    if node == "NA":
        return node
    if len(node) < 2 or node[-2:] not in (":B", ":E"):
        raise ValueError("invalid node name %r" % (node,))
    return node[:-1] + ("B" if node[-1] == "E" else "E")


def reverse_edge(e):
    v, w = e
    return reverse_end(w), reverse_end(v)


class StringGraph:
    """Bidirected string graph over read-end nodes.

    nodes: dict name -> [out_edge_names, in_edge_names] (lists of edge keys
    kept in insertion order; re-sorted in place exactly where the reference
    sorts its edge-object lists, so stable-sort tie behavior matches).
    """

    def __init__(self):
        self.out_edges = {}   # node -> list of (v, w) keys
        self.in_edges = {}    # node -> list of (v, w) keys
        self.edge_attr = {}   # (v, w) -> dict(label=, length=, score=, identity=)
        self.e_reduce = {}
        self.best_out = {}
        self.best_in = {}

    # -- construction ------------------------------------------------------
    def add_node(self, name):
        if name not in self.out_edges:
            self.out_edges[name] = []
            self.in_edges[name] = []

    def add_edge(self, v, w, label, length, score, identity):
        if (v, w) not in self.edge_attr:
            self.add_node(v)
            self.add_node(w)
            self.out_edges[v].append((v, w))
            self.in_edges[w].append((v, w))
            self.edge_attr[(v, w)] = {}
        a = self.edge_attr[(v, w)]
        a["label"] = label
        a["length"] = length
        a["score"] = score
        a["identity"] = identity

    def init_reduce(self):
        for e in self.edge_attr:
            self.e_reduce[e] = False

    def nodes(self):
        return self.out_edges.keys()

    # -- transitive reduction (ovlp_to_graph.py:219-277) -------------------
    def mark_tr_edges(self):
        FUZZ = 500
        n_mark = {n: "vacant" for n in self.nodes()}
        attr = self.edge_attr
        for n in list(self.nodes()):
            oe = self.out_edges[n]
            if not oe:
                continue
            oe.sort(key=lambda e: attr[e]["length"])
            for (v, w) in oe:
                n_mark[w] = "inplay"
            max_len = attr[oe[-1]]["length"] + FUZZ

            for (v, w) in oe:
                e_len = attr[(v, w)]["length"]
                if n_mark[w] == "inplay":
                    self.out_edges[w].sort(key=lambda e: attr[e]["length"])
                    for (v2, x) in self.out_edges[w]:
                        if attr[(v2, x)]["length"] + e_len < max_len:
                            if n_mark[x] == "inplay":
                                n_mark[x] = "eliminated"

            for (v, w) in oe:
                self.out_edges[w].sort(key=lambda e: attr[e]["length"])
                woe = self.out_edges[w]
                if woe:
                    x = woe[0][1]
                    if n_mark[x] == "inplay":
                        n_mark[x] = "eliminated"
                for (v2, x) in woe:
                    if attr[(v2, x)]["length"] < FUZZ:
                        if n_mark[x] == "inplay":
                            n_mark[x] = "eliminated"

            for (v, w) in oe:
                if n_mark[w] == "eliminated":
                    self.e_reduce[(v, w)] = True
                    self.e_reduce[(reverse_end(w), reverse_end(v))] = True
                n_mark[w] = "vacant"

    # -- chimer removal (ovlp_to_graph.py:103-191) -------------------------
    def _bfs_nodes(self, n, exclude=None, depth=5):
        """Reference bfs_nodes quirk-compatible: pops ONE candidate per
        depth level (ovlp_to_graph.py:103-121).  Candidate popping from a
        set is address-ordered in the reference; we pop in insertion order
        (documented determinism deviation)."""
        all_nodes = {n}
        candidates = {n: None}  # ordered set
        dp = 1
        while dp < depth and candidates:
            v, _ = candidates.popitem()
            for (_, w) in self.out_edges[v]:
                if w == exclude:
                    continue
                if w not in all_nodes:
                    all_nodes.add(w)
                    if self.out_edges[w]:
                        candidates[w] = None
            dp += 1
        return all_nodes

    def mark_chimer_edges(self):
        multi_in = {}
        multi_out = {}
        for n in self.nodes():
            outs = [w for (v, w) in self.out_edges[n]
                    if self.e_reduce[(v, w)] is False]
            ins = [v for (v, w) in self.in_edges[n]
                   if self.e_reduce[(v, w)] is False]
            if len(outs) >= 2:
                multi_out[n] = outs
            if len(ins) >= 2:
                multi_in[n] = ins

        out_set = set()
        for n, outs in multi_out.items():
            out_set |= set(outs)
        in_set = set()
        for n, ins in multi_in.items():
            in_set |= set(ins)
        cands = out_set & in_set

        chimer_nodes = []
        chimer_edges = set()
        # deterministic candidate order: node insertion order
        for n in (x for x in self.nodes() if x in cands):
            out_nodes = set(w for (_, w) in self.out_edges[n])
            test_set = set()
            for in_node in [v for (v, _) in self.in_edges[n]]:
                test_set |= set(w for (_, w) in self.out_edges[in_node])
            test_set -= {n}
            if out_nodes & test_set:
                continue
            flow1 = set()
            for v in out_nodes:
                flow1 |= self._bfs_nodes(v, exclude=n)
            flow2 = set()
            for v in test_set:
                flow2 |= self._bfs_nodes(v, exclude=n)
            if flow1 & flow2:
                continue
            for (v, w) in list(self.out_edges[n]) + list(self.in_edges[n]):
                if self.e_reduce[(v, w)] is not True:
                    self.e_reduce[(v, w)] = True
                    chimer_edges.add((v, w))
                    rv, rw = reverse_end(w), reverse_end(v)
                    self.e_reduce[(rv, rw)] = True
                    chimer_edges.add((rv, rw))
            chimer_nodes.append(n)
            chimer_nodes.append(reverse_end(n))
        return chimer_nodes, chimer_edges

    # -- spur removal (ovlp_to_graph.py:193-217) ---------------------------
    def mark_spur_edge(self):
        removed = set()
        for v in self.nodes():
            live_out = [e for e in self.out_edges[v]
                        if self.e_reduce[e] is not True]
            if len(live_out) > 1:
                for (_, w) in self.out_edges[v]:
                    if not self.out_edges[w] and \
                            self.e_reduce[(v, w)] is not True:
                        self.e_reduce[(v, w)] = True
                        removed.add((v, w))
                        v2, w2 = reverse_end(w), reverse_end(v)
                        self.e_reduce[(v2, w2)] = True
                        removed.add((v2, w2))
            live_in = [e for e in self.in_edges[v]
                       if self.e_reduce[e] is not True]
            if len(live_in) > 1:
                for (w, _) in self.in_edges[v]:
                    if not self.in_edges[w] and \
                            self.e_reduce[(w, v)] is not True:
                        self.e_reduce[(w, v)] = True
                        removed.add((w, v))
                        v2, w2 = reverse_end(w), reverse_end(v)
                        self.e_reduce[(w2, v2)] = True
                        removed.add((w2, v2))
        return removed

    # -- best-overlap knot resolution (ovlp_to_graph.py:279-321) -----------
    def mark_best_overlap(self):
        best_edges = set()
        removed = set()
        attr = self.edge_attr
        for v in self.nodes():
            oe = self.out_edges[v]
            if oe:
                oe.sort(key=lambda e: -attr[e]["score"])
                for e in oe:
                    if self.e_reduce[e] is not True:
                        best_edges.add(e)
                        self.best_out[v] = e[1]
                        break
            ie = self.in_edges[v]
            if ie:
                ie.sort(key=lambda e: -attr[e]["score"])
                for e in ie:
                    if self.e_reduce[e] is not True:
                        best_edges.add(e)
                        self.best_in[v] = e[0]
                        break
        for e in self.edge_attr:
            if self.e_reduce[e] is not True and e not in best_edges:
                self.e_reduce[e] = True
                removed.add(e)
                re_ = (reverse_end(e[1]), reverse_end(e[0]))
                self.e_reduce[re_] = True
                removed.add(re_)
        return removed

    # -- local-flow-consistency (--lfc) (ovlp_to_graph.py:323-409) ---------
    def resolve_repeat_edges(self):
        def live_outs(n):
            return [w for (v, w) in self.out_edges[n]
                    if self.e_reduce[(v, w)] is False]

        def live_ins(n):
            return [v for (v, w) in self.in_edges[n]
                    if self.e_reduce[(v, w)] is False]

        to_reduce = []
        nodes_to_test = set()
        test_order = []
        for v in self.nodes():
            if len(live_outs(v)) == 1 and len(live_ins(v)) == 1:
                nodes_to_test.add(v)
                test_order.append(v)

        for v_n in test_order:
            in_node = live_ins(v_n)[0]
            for (vv, ww) in self.out_edges[in_node]:
                ww_out_nodes = set(w for (_, w) in self.out_edges[ww])
                v_out_nodes = set(w for (_, w) in self.out_edges[v_n])
                o_overlap = len(ww_out_nodes & v_out_nodes)
                ww_in_count = len(live_ins(ww))
                if ww != v_n and self.e_reduce[(vv, ww)] is False and \
                        ww_in_count > 1 and ww not in nodes_to_test and \
                        o_overlap == 0:
                    to_reduce.append((vv, ww))

            out_node = live_outs(v_n)[0]
            for (vv, ww) in self.in_edges[out_node]:
                vv_in_nodes = set(v for (v, _) in self.in_edges[vv])
                v_in_nodes = set(v for (v, _) in self.in_edges[v_n])
                i_overlap = len(vv_in_nodes & v_in_nodes)
                vv_out_count = len(live_outs(vv))
                if vv != v_n and self.e_reduce[(vv, ww)] is False and \
                        vv_out_count > 1 and vv not in nodes_to_test and \
                        i_overlap == 0:
                    to_reduce.append((vv, ww))

        removed = set()
        for e in to_reduce:
            self.e_reduce[e] = True
            removed.add(e)
        return removed


def parse_overlap_line(fields, min_idt, min_len, contained_reads,
                       overlap_data, overlap_count):
    """One record of the filtered overlap table -> overlap_data row
    (reference process_fields, ovlp_to_graph.py:673-730)."""
    f_id, g_id, score, identity = fields[:4]
    if f_id == g_id:
        return
    score = int(score)
    identity = float(identity)
    contained = fields[12]
    if contained == "contained":
        contained_reads.add(f_id)
        return
    if contained == "contains":
        contained_reads.add(g_id)
        return
    if contained == "none":
        return
    if identity < min_idt:
        return
    f_strain, f_start, f_end, f_len = (int(c) for c in fields[4:8])
    g_strain, g_start, g_end, g_len = (int(c) for c in fields[8:12])
    if f_len < min_len or g_len < min_len:
        return
    overlap_data.append((f_id, g_id, score, identity,
                         f_strain, f_start, f_end, f_len,
                         g_strain, g_start, g_end, g_len))
    overlap_count[f_id] = overlap_count.get(f_id, 0) + 1
    overlap_count[g_id] = overlap_count.get(g_id, 0) + 1


def build_string_graph(overlap_lines, min_len, min_idt,
                       lfc=False, disable_chimer_bridge_removal=False,
                       chimer_nodes_out=None):
    """overlap_lines: iterable of whitespace-split record field lists
    (the '---'-terminated preads.ovl contents).  Returns
    (sg, edge_lines, edge_data, chimer_nodes) where edge_lines are the
    formatted sg_edges_list rows and edge_data maps live (v, w) ->
    (rid, sp, tp, length, score, identity, 'G').
    (reference: generate_string_graph, ovlp_to_graph.py:654-904)
    """
    contained = set()
    overlap_data = []
    overlap_count = {}
    for fields in overlap_lines:
        parse_overlap_line(fields, min_idt, min_len, contained,
                           overlap_data, overlap_count)

    sg = StringGraph()
    seen_pairs = set()
    for od in overlap_data:
        f_id, g_id, score, identity = od[:4]
        if f_id in contained or g_id in contained:
            continue
        f_s, f_b, f_e, f_l = od[4:8]
        g_s, g_b, g_e, g_l = od[8:12]
        pair = tuple(sorted((f_id, g_id)))
        if pair in seen_pairs:
            continue
        seen_pairs.add(pair)
        if g_s == 1:  # reversed alignment: swap begin/end
            g_b, g_e = g_e, g_b

        # the four overlap orientations (ovlp_to_graph.py:768-837)
        if f_b > 0:
            if g_b < g_e:
                #  f  ----------->        g        ------------->
                if f_b == 0 or g_e - g_l == 0:
                    continue
                sg.add_edge("%s:B" % g_id, "%s:B" % f_id,
                            label=(f_id, f_b, 0), length=abs(f_b - 0),
                            score=-score, identity=identity)
                sg.add_edge("%s:E" % f_id, "%s:E" % g_id,
                            label=(g_id, g_e, g_l), length=abs(g_e - g_l),
                            score=-score, identity=identity)
            else:
                #  f  ----------->        g        <-------------
                if f_b == 0 or g_e == 0:
                    continue
                sg.add_edge("%s:E" % g_id, "%s:B" % f_id,
                            label=(f_id, f_b, 0), length=abs(f_b - 0),
                            score=-score, identity=identity)
                sg.add_edge("%s:E" % f_id, "%s:B" % g_id,
                            label=(g_id, g_e, 0), length=abs(g_e - 0),
                            score=-score, identity=identity)
        else:
            if g_b < g_e:
                if g_b == 0 or f_e - f_l == 0:
                    continue
                sg.add_edge("%s:B" % f_id, "%s:B" % g_id,
                            label=(g_id, g_b, 0), length=abs(g_b - 0),
                            score=-score, identity=identity)
                sg.add_edge("%s:E" % g_id, "%s:E" % f_id,
                            label=(f_id, f_e, f_l), length=abs(f_e - f_l),
                            score=-score, identity=identity)
            else:
                if g_b - g_l == 0 or f_e - f_l == 0:
                    continue
                sg.add_edge("%s:B" % f_id, "%s:E" % g_id,
                            label=(g_id, g_b, g_l), length=abs(g_b - g_l),
                            score=-score, identity=identity)
                sg.add_edge("%s:B" % g_id, "%s:E" % f_id,
                            label=(f_id, f_e, f_l), length=abs(f_e - f_l),
                            score=-score, identity=identity)

    sg.init_reduce()
    sg.mark_tr_edges()

    if not disable_chimer_bridge_removal:
        chimer_nodes, chimer_edges = sg.mark_chimer_edges()
        if chimer_nodes_out is not None:
            for n in chimer_nodes:
                chimer_nodes_out.write(n + "\n")
    else:
        chimer_nodes, chimer_edges = [], set()

    spur_edges = sg.mark_spur_edge()
    if lfc:
        removed_edges = sg.resolve_repeat_edges()
    else:
        removed_edges = sg.mark_best_overlap()
    spur_edges.update(sg.mark_spur_edge())

    edge_lines = []
    edge_data = {}
    best_in_of = {}
    for (v, w), a in sg.edge_attr.items():
        rid, sp, tp = a["label"]
        score = a["score"]
        identity = a["identity"]
        length = abs(sp - tp)
        if sg.e_reduce[(v, w)] is not True:
            type_ = "G"
            edge_data[(v, w)] = (rid, sp, tp, length, score, identity, type_)
            if w in sg.best_in:
                # quirk-compatible: the reference stores the CURRENT edge's
                # source (overwritten per live in-edge in iteration order),
                # not sg.best_in[w] (ovlp_to_graph.py:886-887)
                best_in_of[w] = v
        elif (v, w) in chimer_edges:
            type_ = "C"
        elif (v, w) in removed_edges:
            type_ = "R"
        elif (v, w) in spur_edges:
            type_ = "S"
        else:
            type_ = "TR"
        edge_lines.append("%s %s %s %5d %5d %5d %5.2f %s" % (
            v, w, rid, sp, tp, score, identity, type_))
    return sg, edge_lines, edge_data, best_in_of
