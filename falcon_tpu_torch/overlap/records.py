"""Overlap record schema: the 13-column `LA4Falcon -mo` table.

This is the interchange format between the overlap engine and everything
downstream (filter, stats, string graph), matching the reference's
external-tool text schema so reference artifacts interoperate
(reference: falcon_kit/mains/ovlp_filter.py epilog, e.g.
"000000047 000000550 -206 100.00 0 0 206 603 1 0 206 741 overlap"):

  a_id b_id score idt a_strand a_start a_end a_len b_strand b_start b_end
  b_len class

score is the negated overlap length; idt is percent with 2 decimals;
a_strand is always 0; b_strand 1 means b maps reverse-complemented, with
b_start/b_end reported ASCENDING ON B'S FORWARD STRAND (b_start < b_end
always).  This is the convention the reference consumer requires: its
ovlp_to_graph swaps begin/end for strand-1 rows
(ovlp_to_graph.py:764) and graph_to_contig then slices the
forward-stored pread with s>t => reverse-complement
(graph_to_contig.py:171-179); pinned against the reference's real-run
artifact in tests/test_interop.py.  class is one of overlap / contains /
contained / none.
"""
from dataclasses import dataclass

def canonical_idt(dist, aln_len):
    """Percent identity, pre-rounded to the 2-decimal form `%.2f` emits.

    Records carry idt in canonical form from creation so that a record
    round-tripped through its text line (e.g. the multi-host gather)
    compares equal to one that never left RAM -- min_idt filter decisions
    and sort keys cannot diverge between the two paths.
    """
    return round(100.0 * (1.0 - dist / max(1, aln_len)), 2)


OVERLAP = "overlap"
CONTAINS = "contains"
CONTAINED = "contained"
NONE = "none"


@dataclass
class Overlap:
    a_id: str
    b_id: str
    score: int
    idt: float
    a_strand: int
    a_start: int
    a_end: int
    a_len: int
    b_strand: int
    b_start: int
    b_end: int
    b_len: int
    klass: str

    def to_fields(self):
        return [self.a_id, self.b_id, str(self.score),
                "%.2f" % self.idt, str(self.a_strand), str(self.a_start),
                str(self.a_end), str(self.a_len), str(self.b_strand),
                str(self.b_start), str(self.b_end), str(self.b_len),
                self.klass]

    def to_line(self):
        return " ".join(self.to_fields())

    @classmethod
    def from_fields(cls, f):
        return cls(f[0], f[1], int(f[2]), float(f[3]), int(f[4]), int(f[5]),
                   int(f[6]), int(f[7]), int(f[8]), int(f[9]), int(f[10]),
                   int(f[11]), f[12])

    @classmethod
    def from_line(cls, line):
        return cls.from_fields(line.split())


def classify(strand, a_start, a_end, a_len, b_start, b_end, b_len):
    """Overlap class from FORWARD-strand coordinates.

    The b interval is always given on b's forward strand (b_start < b_end);
    `strand`=1 means b aligns reverse-complemented.  This is the convention
    ovlp_to_graph's 4-case edge construction + graph_to_contig's sequence
    slicing require (reference: ovlp_to_graph.py:764-837 swaps b begin/end
    for strand-1 records then uses them as forward coordinates;
    graph_to_contig.py:171-179 slices/RCs accordingly).
    """
    a_full = a_start == 0 and a_end == a_len
    b_full = b_start == 0 and b_end == b_len
    if a_full and b_full:
        # mutual containment: the shorter is contained
        return CONTAINED if a_len <= b_len else CONTAINS
    if a_full:
        return CONTAINED
    if b_full:
        return CONTAINS
    a_left, a_right = a_start == 0, a_end == a_len
    b_left, b_right = b_start == 0, b_end == b_len
    if strand == 0:
        if (a_left and b_right) or (a_right and b_left):
            return OVERLAP
    else:
        if (a_left and b_left) or (a_right and b_right):
            return OVERLAP
    return NONE


def write_overlaps(path_or_file, overlaps, terminator=False):
    import os
    own = isinstance(path_or_file, (str, os.PathLike))
    f = open(path_or_file, "w") if own else path_or_file
    try:
        for o in overlaps:
            f.write(o.to_line() + "\n")
        if terminator:
            f.write("---\n")
    finally:
        if own:
            f.close()


def read_overlap_lines(path):
    """Yield split field lists until the '---' terminator."""
    with open(path) as f:
        for line in f:
            if line.startswith("-"):
                break
            fields = line.split()
            if fields:
                yield fields
