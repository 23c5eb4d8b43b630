"""falcon_sense consensus: align-tags, MSA accumulation, best-path DP.

Exact host reimplementation of the reference consensus kernel
(reference: src/c/falcon.c):

  * get_align_tags           -- falcon.c:106-162 (alignment columns ->
                                (t_pos, delta, q_base, p_*) tags; delta is
                                the insertion offset at a target position,
                                capped at 255 which truncates the tag string)
  * MSA accumulation         -- falcon.c:232-263, 350-382 (per-column
                                predecessor-link counts in FIRST-OCCURRENCE
                                order; per-t_pos coverage counted at delta=0)
  * forward scoring          -- falcon.c:405-477
                                score = prev.score + link_count - 0.5*cov,
                                strict '>' everywhere, so earlier links /
                                earlier columns win ties
  * backtrack                -- falcon.c:493-540, including the reference
                                quirk that the first emitted base uses the
                                g_best link INDEX as a base code
  * generate_consensus       -- falcon.c:562-666 (seeding gates:
                                range>=100bp both, indel balance 5%%;
                                align band 150; keep aln>500bp & <max_diff)

Validated against the compiled reference C in tests/test_consensus_oracle.py.
"""
import numpy as np

from . import align as _align
from . import kmer as _kmer

_BASE_TO_IDX = {ord("A"): 0, ord("C"): 1, ord("G"): 2, ord("T"): 3, ord("-"): 4}
_IDX_TO_UPPER = "ACGT-"
_IDX_TO_LOWER = "acgt-"


def get_align_tags(q_aln, t_aln, s1, s2, q_id, t_offset=0):
    """Tag list [(t_pos, delta, q_base, p_t_pos, p_delta, p_q_base, q_id)].

    q_aln/t_aln: bytes of the gapped alignment strings; s1/s2: the aln_range
    starts used by the reference (falcon.c:119-120)."""
    qa = np.frombuffer(q_aln, dtype=np.uint8)
    ta = np.frombuffer(t_aln, dtype=np.uint8)
    n = len(qa)
    tags = []
    i = s1 - 1
    j = s2 - 1
    jj = 0
    p_j = -1
    p_jj = 0
    p_q_base = ord(".")
    for k in range(n):
        if qa[k] != ord("-"):
            i += 1
            jj += 1
        if ta[k] != ord("-"):
            j += 1
            jj = 0
        if j + t_offset >= 0 and jj < 255 and p_jj < 255:
            tags.append((j + t_offset, jj, int(qa[k]),
                         p_j + t_offset, p_jj, p_q_base, q_id))
            p_j = j
            p_jj = jj
            p_q_base = int(qa[k])
        else:
            break
    return tags


def get_cns_from_align_tags(tag_seqs, t_len, min_cov):
    """MSA accumulation + forward DP + backtrack (falcon.c:308-558).

    tag_seqs: list of tag lists from get_align_tags.
    Returns the consensus string (uppercase where coverage>min_cov)."""
    coverage = np.zeros(t_len, dtype=np.int64)
    max_delta = np.zeros(t_len, dtype=np.int64)
    # cols[(t_pos, delta, base_idx)] = [count, links] where links is a dict
    # (p_t_pos, p_delta, p_base_idx) -> link_count, in insertion order
    # (python dicts preserve insertion order, matching update_col).
    cols = {}

    t_pos = 0
    for tags in tag_seqs:
        for (tp, delta, q_base, p_tp, p_delta, p_q_base, _qid) in tags:
            if delta == 0:
                t_pos = tp
                coverage[t_pos] += 1
            if delta > max_delta[t_pos]:
                max_delta[t_pos] = delta
            # Non-ACGT- bases (e.g. 'N') are undefined behavior in the
            # reference (falcon.c:370 "base may be -1"); we route them to
            # the gap column like the p_q_base default branch (falcon.c:437).
            base = _BASE_TO_IDX.get(q_base, 4)
            p_base = _BASE_TO_IDX.get(p_q_base, 4)
            col = cols.get((t_pos, delta, base))
            if col is None:
                col = [0, {}]
                cols[(t_pos, delta, base)] = col
            col[0] += 1
            link = (p_tp, p_delta, p_base)
            col[1][link] = col[1].get(link, 0) + 1

    # forward scoring in (t_pos, delta, base) order
    scores = {}
    best_link = {}
    g_best_score = -1.0
    g_best_key = None
    g_best_ck = -1
    g_best_t_pos = 0
    for i in range(t_len):
        cov_term = 0.5 * float(coverage[i])
        for j in range(int(max_delta[i]) + 1):
            for kk in range(5):
                key = (i, j, kk)
                col = cols.get(key)
                best_score = -1.0
                best = (-1, 0, 0)
                bck = -1
                if col is not None:
                    for ck, (link, lcount) in enumerate(col[1].items()):
                        pi, pj, pkk = link
                        if pi == -1:
                            score = float(lcount) - cov_term
                        else:
                            score = scores.get((pi, pj, pkk), -1.0) + \
                                float(lcount) - cov_term
                        if score > best_score:
                            best_score = score
                            best = (pi, pj, pkk)
                            bck = ck
                scores[key] = best_score
                best_link[key] = best
                if best_score > g_best_score:
                    g_best_score = best_score
                    g_best_key = key
                    g_best_ck = bck
                    g_best_t_pos = i

    if g_best_key is None or g_best_score == -1.0:
        # reference asserts g_best_score != -1 (falcon.c:476); callers only
        # reach here with zero tags, for which generate_consensus returns ""
        return ""

    # backtrack (falcon.c:493-540). Quirk: the first emitted base comes
    # from the link index g_best_ck used as a base code.
    out = []
    ck = g_best_ck
    i = g_best_t_pos
    cur = g_best_key
    index = 0
    while True:
        if 0 <= ck < 5:
            if coverage[i] > min_cov:
                bb = _IDX_TO_UPPER[ck]
            else:
                bb = _IDX_TO_LOWER[ck]
        else:
            bb = "$"  # C leaves previous value; initial is '$'
        link = best_link.get(cur)
        if link is None:
            # a link pointed at a never-populated column (only possible
            # with t_offset > 0; the reference walks calloc zeros here)
            break
        pi, pj, pkk = link
        i = pi
        if i == -1 or index >= t_len * 2:
            break
        ck = pkk
        cur = (pi, pj, pkk)
        if bb != "-":
            out.append(bb)
            index += 1

    return "".join(reversed(out))


def generate_utg_consensus(seqs, offsets, min_cov, K, min_idt):
    """Offset-based unitig polishing consensus (reference:
    generate_utg_consensus, src/c/falcon.c:668-773): seqs[0] is the
    unitig backbone; each support read is pre-placed at offsets[i] and
    aligned with band 500 over the overlapping window, then fed to the
    same MSA/DP with t_offset.  Deviation from the reference: its
    backtrack walks calloc'd zero links when a path reaches an
    unpopulated column (possible with t_offset > 0), which is undefined
    behavior; we stop the walk there instead."""
    if not seqs:
        return ""
    max_diff = 1.0 - min_idt
    utg = seqs[0]
    utg_len = len(utg)
    tag_seqs = []
    # the backbone aligns to itself as the first tag sequence
    tag_seqs.append(get_align_tags(utg.encode(), utg.encode(), 0, 0, 0, 0))
    for j in range(1, len(seqs)):
        r = seqs[j]
        r_len = len(r)
        off = int(offsets[j])
        if off < 0:
            if (r_len + off) < 128:
                continue
            n = min(r_len + off, utg_len)
            aln = _align.align(r[-off:-off + n], utg[:n], 500, True)
            off = 0
        else:
            if off > utg_len - 128:
                continue
            n = min(utg_len - off, r_len)
            aln = _align.align(r[:n], utg[off:off + n], 500, True)
        if aln.aln_str_size > 500 and \
                (float(aln.dist) / float(aln.aln_str_size)) < max_diff:
            tag_seqs.append(get_align_tags(
                aln.q_aln_str, aln.t_aln_str, 0, 0, j, off))
    return get_cns_from_align_tags(tag_seqs, utg_len, 0)


def generate_consensus(seqs, min_cov, K, min_idt):
    """Exact reimplementation of reference generate_consensus
    (src/c/falcon.c:562-666). seqs[0] is the seed; returns consensus str."""
    if not seqs:
        return ""
    max_diff = 1.0 - min_idt
    seed = seqs[0]
    lookup = _kmer.KmerLookup(seed, K)
    tag_seqs = []
    for j in range(1, len(seqs)):
        qp, tp = lookup.find_kmer_pos_for_seq(seqs[j])
        if len(qp) == 0:
            # C's find_best_aln_range with 0 hits is UB; gates below skip it
            continue
        r = _kmer.find_best_aln_range(qp, tp, K, K * 6, 5)
        if (r.e1 - r.s1 < 100 or r.e2 - r.s2 < 100 or
                abs((r.e1 - r.s1) - (r.e2 - r.s2)) >
                int(0.5 * 0.10 * (r.e1 - r.s1 + r.e2 - r.s2))):
            continue
        aln = _align.align(seqs[j][r.s1:r.e1], seed[r.s2:r.e2], 150, True)
        if aln.aln_str_size > 500 and \
                (float(aln.dist) / float(aln.aln_str_size)) < max_diff:
            tag_seqs.append(get_align_tags(
                aln.q_aln_str, aln.t_aln_str, r.s1, r.s2, j, 0))
    if not tag_seqs:
        return ""
    return get_cns_from_align_tags(tag_seqs, len(seed), min_cov)
