"""Streaming FASTA IO.

Replaces the reference's falcon_kit/FastaReader.py (reference:
falcon_kit/FastaReader.py:180-212) with a minimal, fast reader that
supports plain and gzip files, plus a writer helper used by every stage
that emits sequence artifacts (preads, p_ctg, a_ctg, ...).
"""
import gzip
import hashlib
import os


class FastaRecord:
    __slots__ = ("name", "comment", "sequence")

    def __init__(self, header, sequence):
        parts = header.split(None, 1)
        self.name = parts[0] if parts else ""
        self.comment = parts[1] if len(parts) > 1 else ""
        self.sequence = sequence

    @property
    def header(self):
        return self.name + ((" " + self.comment) if self.comment else "")

    @property
    def md5(self):
        return hashlib.md5(self.sequence.encode()).hexdigest()


def _open_text(path):
    if str(path).endswith(".gz"):
        return gzip.open(path, "rt")
    return open(path, "r")


def read_fasta(path):
    """Yield FastaRecord from a (possibly gzipped) FASTA file."""
    with _open_text(path) as f:
        yield from parse_fasta_stream(f)


def parse_fasta_stream(f):
    header = None
    chunks = []
    for line in f:
        line = line.strip()
        if not line:
            continue
        if line.startswith(">"):
            if header is not None:
                yield FastaRecord(header, "".join(chunks))
            header = line[1:]
            chunks = []
        else:
            chunks.append(line)
    if header is not None:
        yield FastaRecord(header, "".join(chunks))


def read_fasta_files(paths):
    for p in paths:
        yield from read_fasta(p)


def read_fofn(fofn_path):
    """Read a file-of-filenames; relative paths resolve against the fofn dir.

    (reference: falcon_kit/util/io.py:229-253 validated_fns)
    """
    base = os.path.dirname(os.path.abspath(fofn_path))
    out = []
    with open(fofn_path) as f:
        for line in f:
            line = line.strip()
            if not line:
                continue
            if not os.path.isabs(line):
                line = os.path.join(base, line)
            out.append(line)
    return out


def write_fasta(path_or_file, records, width=0):
    """Write (name, seq) pairs; width=0 means single-line sequences."""
    own = isinstance(path_or_file, (str, os.PathLike))
    f = open(path_or_file, "w") if own else path_or_file
    try:
        for name, seq in records:
            f.write(">%s\n" % name)
            if width and width > 0:
                for i in range(0, len(seq), width):
                    f.write(seq[i:i + width] + "\n")
            else:
                f.write(seq + "\n")
    finally:
        if own:
            f.close()


def format_seq(seq, col):
    """Hard-wrap a sequence at col chars (reference: consensus.py:212-213)."""
    return "\n".join([seq[i:(i + col)] for i in range(0, len(seq), col)])
