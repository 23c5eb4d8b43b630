"""Columnar overlap table: the in-RAM data plane for overlap records.

The reference keeps overlap tables on disk as sorted `.las` files merged
through the LAmerge tree (reference: falcon_kit/mains/dazzler.py:559-574)
because they outgrow RAM as Python objects.  falcon_tpu_torch keeps the table in
RAM as ONE numpy structured array -- ~46 bytes/record instead of ~500 for
a dataclass of strings -- and does every whole-table operation (mirror
emission, canonical sort, filter stages) as vectorized column math.  Text
(the `LA4Falcon -mo` 13-column schema, overlap.records) exists only at
file boundaries.

Read ids are dense ints here; they become %09d strings only when a line
is formatted.  idt is stored in centipercent (idt_cp = round(idt*100)) so
a record round-tripped through text is bit-identical to one that never
left RAM.
"""
import numpy as np

from . import records as R

# klass codes
OVERLAP, CONTAINS, CONTAINED, NONE = 0, 1, 2, 3
KLASS_STR = ("overlap", "contains", "contained", "none")
KLASS_CODE = {s: i for i, s in enumerate(KLASS_STR)}
# rank of each code under STRING comparison ("contained" < "contains" <
# "none" < "overlap") -- keeps full-field sort ties identical to the
# record-object sort
_KLASS_SORT = np.array([3, 1, 0, 2], dtype=np.int8)
_KLASS_FLIP = np.array([OVERLAP, CONTAINED, CONTAINS, NONE], dtype=np.int8)

DTYPE = np.dtype([
    ("a_id", np.int64), ("b_id", np.int64), ("score", np.int32),
    ("idt_cp", np.int32), ("a_start", np.int32), ("a_end", np.int32),
    ("a_len", np.int32), ("b_strand", np.int8), ("b_start", np.int32),
    ("b_end", np.int32), ("b_len", np.int32), ("klass", np.int8)])


def empty(n=0):
    return np.zeros(n, dtype=DTYPE)


def classify_arr(strand, a_start, a_end, a_len, b_start, b_end, b_len):
    """Vectorized overlap.records.classify over forward-strand coords."""
    a_left = a_start == 0
    a_right = a_end == a_len
    b_left = b_start == 0
    b_right = b_end == b_len
    a_full = a_left & a_right
    b_full = b_left & b_right
    out = np.full(len(a_start), NONE, dtype=np.int8)
    fwd = strand == 0
    ovl = np.where(fwd, (a_left & b_right) | (a_right & b_left),
                   (a_left & b_left) | (a_right & b_right))
    out[ovl] = OVERLAP
    out[b_full] = CONTAINS
    out[a_full] = CONTAINED
    out[a_full & b_full & (a_len > b_len)] = CONTAINS
    return out


def finalize(a_id, b_id, strand, a_s, a_e, a_len, b_s, b_e, b_len, dist,
             min_overlap, min_idt):
    """Raw extension results -> filtered table rows (vectorized).

    b coords must already be on b's FORWARD strand.  Applies the
    min_overlap / min_idt gates and drops class-NONE rows (same gates as
    the per-record path; reference semantics per overlap.records).
    """
    a_id = np.asarray(a_id, np.int64)
    n = len(a_id)
    if n == 0:
        return empty(0)
    a_s = np.asarray(a_s, np.int64)
    a_e = np.asarray(a_e, np.int64)
    b_s = np.asarray(b_s, np.int64)
    b_e = np.asarray(b_e, np.int64)
    dist = np.asarray(dist, np.int64)
    aln_len = ((a_e - a_s) + (b_e - b_s)) // 2
    idt = 100.0 * (1.0 - dist / np.maximum(1, aln_len))
    idt_cp = np.rint(np.round(idt, 2) * 100).astype(np.int64)
    keep = (aln_len >= min_overlap) & (idt_cp >= 10000.0 * min_idt)
    if not keep.any():
        return empty(0)
    idx = np.nonzero(keep)[0]
    klass = classify_arr(np.asarray(strand)[idx], a_s[idx], a_e[idx],
                         np.asarray(a_len, np.int64)[idx], b_s[idx],
                         b_e[idx], np.asarray(b_len, np.int64)[idx])
    idx = idx[klass != NONE]
    klass = klass[klass != NONE]
    t = empty(len(idx))
    t["a_id"] = a_id[idx]
    t["b_id"] = np.asarray(b_id, np.int64)[idx]
    t["score"] = -(a_e[idx] - a_s[idx])
    t["idt_cp"] = idt_cp[idx]
    t["a_start"] = a_s[idx]
    t["a_end"] = a_e[idx]
    t["a_len"] = np.asarray(a_len, np.int64)[idx]
    t["b_strand"] = np.asarray(strand, np.int64)[idx]
    t["b_start"] = b_s[idx]
    t["b_end"] = b_e[idx]
    t["b_len"] = np.asarray(b_len, np.int64)[idx]
    t["klass"] = klass
    return t


def sort_full(tbl):
    """Canonical full-field order: identical table no matter how rows
    arrived (single-host plan order or multi-host gather order).  Matches
    the record-object sort key (a_id, b_id, score, idt, a_start, a_end,
    b_strand, b_start, b_end, klass-as-string)."""
    order = np.lexsort((_KLASS_SORT[tbl["klass"]], tbl["b_end"],
                        tbl["b_start"], tbl["b_strand"], tbl["a_end"],
                        tbl["a_start"], tbl["idt_cp"], tbl["score"],
                        tbl["b_id"], tbl["a_id"]))
    return tbl[order]


def emit_symmetric(tbl):
    """Mirror every row into its (b, a) record and return the canonical
    sorted table (the engine.emit_symmetric contract, columnar)."""
    m = empty(len(tbl))
    m["a_id"] = tbl["b_id"]
    m["b_id"] = tbl["a_id"]
    m["score"] = tbl["score"]
    m["idt_cp"] = tbl["idt_cp"]
    m["a_start"] = tbl["b_start"]
    m["a_end"] = tbl["b_end"]
    m["a_len"] = tbl["b_len"]
    m["b_strand"] = tbl["b_strand"]
    m["b_start"] = tbl["a_start"]
    m["b_end"] = tbl["a_end"]
    m["b_len"] = tbl["a_len"]
    m["klass"] = _KLASS_FLIP[tbl["klass"]]
    return sort_full(np.concatenate([tbl, m]))


def concat(tables):
    tables = [t for t in tables if len(t)]
    if not tables:
        return empty(0)
    return np.concatenate(tables)


# -- text boundary ---------------------------------------------------------

def format_line(row):
    """One row -> the 13-column text line (== records.Overlap.to_line)."""
    cp = int(row["idt_cp"])
    return "%09d %09d %d %d.%02d 0 %d %d %d %d %d %d %d %s" % (
        row["a_id"], row["b_id"], row["score"], cp // 100, cp % 100,
        row["a_start"], row["a_end"], row["a_len"], row["b_strand"],
        row["b_start"], row["b_end"], row["b_len"],
        KLASS_STR[row["klass"]])


def to_lines(tbl):
    """All rows as text lines (vectorized field formatting)."""
    if len(tbl) == 0:
        return []
    cp = tbl["idt_cp"].astype(np.int64)
    cols = [
        np.char.zfill(tbl["a_id"].astype("U9"), 9),
        np.char.zfill(tbl["b_id"].astype("U9"), 9),
        tbl["score"].astype("U12"),
        np.char.add(np.char.add((cp // 100).astype("U4"), "."),
                    np.char.zfill((cp % 100).astype("U2"), 2)),
        np.full(len(tbl), "0", dtype="U1"),
        tbl["a_start"].astype("U10"), tbl["a_end"].astype("U10"),
        tbl["a_len"].astype("U10"), tbl["b_strand"].astype("U1"),
        tbl["b_start"].astype("U10"), tbl["b_end"].astype("U10"),
        tbl["b_len"].astype("U10"),
        np.asarray(KLASS_STR, dtype="U9")[tbl["klass"]],
    ]
    out = cols[0]
    for c in cols[1:]:
        out = np.char.add(np.char.add(out, " "), c)
    return out.tolist()


def write_table(path_or_file, tbl, terminator=False):
    import os
    own = isinstance(path_or_file, (str, os.PathLike))
    f = open(path_or_file, "w") if own else path_or_file
    try:
        CH = 1 << 18
        for ofs in range(0, len(tbl), CH):
            f.write("\n".join(to_lines(tbl[ofs:ofs + CH])))
            f.write("\n")
        if terminator:
            f.write("---\n")
    finally:
        if own:
            f.close()


def from_fields_iter(field_lists):
    """Parse split 13-column field lists into a table."""
    rows = []
    for f in field_lists:
        d, _, c = f[3].partition(".")
        rows.append((int(f[0]), int(f[1]), int(f[2]),
                     int(d) * 100 + int((c + "00")[:2]), int(f[5]),
                     int(f[6]), int(f[7]), int(f[8]), int(f[9]),
                     int(f[10]), int(f[11]), KLASS_CODE[f[12]]))
    t = empty(len(rows))
    for i, r in enumerate(rows):
        (t["a_id"][i], t["b_id"][i], t["score"][i], t["idt_cp"][i],
         t["a_start"][i], t["a_end"][i], t["a_len"][i], t["b_strand"][i],
         t["b_start"][i], t["b_end"][i], t["b_len"][i],
         t["klass"][i]) = r
    return t


def read_table(path):
    """Parse an overlap text file (stops at the '---' terminator)."""
    return from_fields_iter(R.read_overlap_lines(path))


def to_records(tbl):
    """Table -> list of records.Overlap (tests / interop)."""
    out = []
    for row in tbl:
        cp = int(row["idt_cp"])
        out.append(R.Overlap(
            "%09d" % row["a_id"], "%09d" % row["b_id"], int(row["score"]),
            cp / 100.0, 0, int(row["a_start"]), int(row["a_end"]),
            int(row["a_len"]), int(row["b_strand"]), int(row["b_start"]),
            int(row["b_end"]), int(row["b_len"]), KLASS_STR[row["klass"]]))
    return out


def from_records(recs):
    t = empty(len(recs))
    for i, o in enumerate(recs):
        t["a_id"][i] = int(o.a_id)
        t["b_id"][i] = int(o.b_id)
        t["score"][i] = o.score
        t["idt_cp"][i] = int(round(o.idt * 100))
        t["a_start"][i] = o.a_start
        t["a_end"][i] = o.a_end
        t["a_len"][i] = o.a_len
        t["b_strand"][i] = o.b_strand
        t["b_start"][i] = o.b_start
        t["b_end"][i] = o.b_end
        t["b_len"][i] = o.b_len
        t["klass"][i] = KLASS_CODE[o.klass]
    return t
