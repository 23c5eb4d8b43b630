"""Three-stage distributed overlap filter -> preads.ovl.

Exact reimplementation of the reference fc_ovlp_filter
(reference: falcon_kit/mains/ovlp_filter.py):

  stage 1 (:21-68)   mark reads with asymmetric / too-low / too-high 5'/3'
                     coverage as "ignore"
  stage 2 (:78-102)  collect contained reads (given the ignore set)
  stage 3 (:112-191) per surviving read, emit best-n overlaps per end,
                     sorted by (-overlap_len, unaligned b-range), with the
                     reference's quirky emission loop: it emits while
                     i < bestn OR the b-unaligned range <= 1000 (the break
                     fires only when both i >= bestn and m_range > 1000)

Workers take a `readlines` callable (the reference's fake-stream test seam,
falcon_kit/util/io.py:115-218) so tests can feed captured text instead of
a live overlap stream; the production path feeds per-block record arrays
from the TPU overlap engine.
"""


def filter_stage1(readlines, max_diff, max_ovlp, min_ovlp, min_len):
    """Return read ids to ignore (coverage-symmetry gate)."""
    def ignore(counts):
        left, right = counts["5p"], counts["3p"]
        return (abs(left - right) > max_diff or left > max_ovlp or
                right > max_ovlp or left < min_ovlp or right < min_ovlp)

    ignored = []
    current = None
    counts = {"5p": 0, "3p": 0}
    q_id = None
    for line in readlines():
        l = line.strip().split()
        q_id, t_id = l[:2]
        if q_id != current:
            if current is not None and ignore(counts):
                ignored.append(current)
            counts = {"5p": 0, "3p": 0}
            current = q_id
        idt = float(l[3])
        q_s, q_e, q_l = int(l[5]), int(l[6]), int(l[7])
        t_l = int(l[11])
        if idt < 90.0:
            continue
        if q_l < min_len or t_l < min_len:
            continue
        if q_s == 0:
            counts["5p"] += 1
        if q_e == q_l:
            counts["3p"] += 1
    if q_id is not None and ignore(counts):
        ignored.append(current)
    return ignored


def filter_stage2(readlines, max_diff, max_ovlp, min_ovlp, min_len,
                  ignore_set):
    """Return the set of contained read ids."""
    contained = set()
    for line in readlines():
        l = line.strip().split()
        q_id, t_id = l[:2]
        q_l = int(l[7])
        t_l = int(l[11])
        idt = float(l[3])
        if idt < 90:
            continue
        if q_l < min_len or t_l < min_len:
            continue
        if q_id in ignore_set or t_id in ignore_set:
            continue
        if l[-1] == "contained":
            contained.add(q_id)
        if l[-1] == "contains":
            contained.add(t_id)
    return contained


def filter_stage3(readlines, max_diff, max_ovlp, min_ovlp, min_len,
                  ignore_set, contained_set, bestn):
    """Return the surviving overlap field-lists (best-n per read end)."""
    out = []

    def emit(per_end):
        for key in ("5p", "3p"):
            lst = per_end[key]
            lst.sort()
            for i, (score, m_range, ovlp) in enumerate(lst):
                out.append(ovlp)
                if i >= bestn and m_range > 1000:
                    break

    per_end = {"5p": [], "3p": []}
    current = None
    for line in readlines():
        l = line.strip().split()
        q_id, t_id = l[:2]
        if current is None:
            current = q_id
            per_end = {"5p": [], "3p": []}
        elif q_id != current:
            emit(per_end)
            per_end = {"5p": [], "3p": []}
            current = q_id

        if q_id in contained_set or t_id in contained_set:
            continue
        if q_id in ignore_set or t_id in ignore_set:
            continue
        overlap_len = -int(l[2])
        idt = float(l[3])
        q_s, q_e, q_l = int(l[5]), int(l[6]), int(l[7])
        t_s, t_e, t_l = int(l[9]), int(l[10]), int(l[11])
        if idt < 90:
            continue
        if q_l < min_len or t_l < min_len:
            continue
        if q_s == 0:
            per_end["5p"].append((-overlap_len, t_l - (t_e - t_s), l))
        elif q_e == q_l:
            per_end["3p"].append((-overlap_len, t_l - (t_e - t_s), l))
    emit(per_end)
    return out


def filter_table(out_f, tbl, max_diff, max_cov, min_cov, min_len, bestn):
    """The three filter stages over a columnar overlap table
    (overlap.table structured array), vectorized.

    Stages 1-2 are pure column math over the whole table at once -- the
    scalable replacement for the reference's per-.las Pool fan-out
    (reference: ovlp_filter.py:194-232); stage 3 sorts/emits per
    surviving read group with the exact tuple semantics of the text path
    (including string-field tie comparison), so output is byte-identical
    to run_ovlp_filter fed the same records as text.
    """
    import numpy as np
    from . import table as T
    if len(tbl) == 0:
        out_f.write("---\n")
        return
    a_id = tbl["a_id"]
    b_id = tbl["b_id"]
    base = ((tbl["idt_cp"] >= 9000) & (tbl["a_len"] >= min_len) &
            (tbl["b_len"] >= min_len))
    max_id = int(max(a_id.max(), b_id.max())) + 1

    # stage 1: per-read 5'/3' coverage symmetry -> ignore set
    starts = np.flatnonzero(np.r_[True, a_id[1:] != a_id[:-1]])
    gids = a_id[starts]
    left = np.add.reduceat(
        (base & (tbl["a_start"] == 0)).astype(np.int64), starts)
    right = np.add.reduceat(
        (base & (tbl["a_end"] == tbl["a_len"])).astype(np.int64), starts)
    ign = ((np.abs(left - right) > max_diff) | (left > max_cov) |
           (right > max_cov) | (left < min_cov) | (right < min_cov))
    ignore = np.zeros(max_id, dtype=bool)
    ignore[gids[ign]] = True

    # stage 2: contained reads (given the ignore set)
    ok2 = base & ~ignore[a_id] & ~ignore[b_id]
    contained = np.zeros(max_id, dtype=bool)
    contained[a_id[ok2 & (tbl["klass"] == T.CONTAINED)]] = True
    contained[b_id[ok2 & (tbl["klass"] == T.CONTAINS)]] = True

    # stage 3: best-n per read end, quirky emission loop preserved
    live = (base & ~ignore[a_id] & ~ignore[b_id] &
            ~contained[a_id] & ~contained[b_id])
    is5 = live & (tbl["a_start"] == 0)
    is3 = live & ~is5 & (tbl["a_end"] == tbl["a_len"])
    idxs = np.flatnonzero(is5 | is3)
    if len(idxs) == 0:
        out_f.write("---\n")
        return
    ga = a_id[idxs]
    gstarts = np.flatnonzero(np.r_[True, ga[1:] != ga[:-1]]).tolist()
    gstarts.append(len(idxs))
    score = tbl["score"][idxs]
    m_range = (tbl["b_len"].astype(np.int64) -
               (tbl["b_end"].astype(np.int64) -
                tbl["b_start"].astype(np.int64)))[idxs]
    five = is5[idxs]

    def emit(cands):
        # cands: [(score, m_range, fields)] -- same tuples as the text
        # path's stage 3, so sort order (incl. string-field ties) and the
        # emit-then-break quirk are identical
        cands.sort()
        for i, (s, m, fields) in enumerate(cands):
            out_f.write(" ".join(fields) + "\n")
            if i >= bestn and m > 1000:
                break

    for g in range(len(gstarts) - 1):
        lo, hi = gstarts[g], gstarts[g + 1]
        for end_is_5 in (True, False):
            cands = []
            for k in range(lo, hi):
                if bool(five[k]) is not end_is_5:
                    continue
                cands.append((int(score[k]), int(m_range[k]),
                              T.format_line(tbl[idxs[k]]).split()))
            emit(cands)
    out_f.write("---\n")


def run_ovlp_filter(out_f, block_streams, max_diff, max_cov, min_cov,
                    min_len, bestn):
    """Run all three stages over per-block overlap streams and write the
    filtered table + '---' terminator (reference: run_ovlp_filter
    ovlp_filter.py:194-232 / try_run_ovlp_filter :235-252).

    block_streams: list of `readlines` callables, one per overlap block
    (each must be re-iterable: called once per stage).
    """
    ignore_all = []
    for rl in block_streams:
        ignore_all.extend(filter_stage1(rl, max_diff, max_cov, min_cov,
                                        min_len))
    ignore_all = set(ignore_all)

    contained = set()
    for rl in block_streams:
        contained.update(filter_stage2(rl, max_diff, max_cov, min_cov,
                                       min_len, ignore_all))

    for rl in block_streams:
        for l in filter_stage3(rl, max_diff, max_cov, min_cov, min_len,
                               ignore_all, contained, bestn):
            out_f.write(" ".join(l) + "\n")
    out_f.write("---\n")
