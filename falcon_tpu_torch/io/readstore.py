"""ReadStore: packed 2-bit read database with fixed-size blocks.

TPU-native replacement for the external DAZZ_DB suite (fasta2DB, DBsplit,
DBdust, DBstats, DBdump -- invoked by the reference through generated bash,
reference: falcon_kit/bash.py:164-236, falcon_kit/mains/dazzler.py:76-168).

Design:
  * all reads concatenated into one flat uint8 code array (A=0 C=1 G=2 T=3,
    other=255), plus int64 offsets / int32 lengths / names.
  * block partition ("DBsplit -s<MB>" analog): greedy fill by cumulative
    bases; "-x<len>" minimum-length filter applied at build time.
  * device view: a block can be exported as a dense [n_reads, pad_len] int8
    tensor (padded with 4 = sentinel) plus a packed 2-bit uint32 tensor
    [n_reads, pad_len/16] for HBM-resident residency.
  * persistence: .npz of flat arrays + a sidecar text file of read names;
    memory-mapped reload.

Read ids are dense ints 0..n-1 in store order; formatted as %09d strings at
the text-artifact boundary (matching the reference's DB id convention used
in overlap tables, reference: falcon_kit/mains/ovlp_filter.py epilog).
"""
import os

import numpy as np

from . import fasta

# base codes
CODE = np.full(256, 255, dtype=np.uint8)
for i, c in enumerate("ACGT"):
    CODE[ord(c)] = i
    CODE[ord(c.lower())] = i
DECODE = np.frombuffer(b"ACGT", dtype=np.uint8)
PAD = 4  # padding sentinel in dense int8 views (never matches any base)


def encode_seq(seq):
    """ASCII sequence -> uint8 codes (A0 C1 G2 T3, other 255)."""
    a = np.frombuffer(seq.encode() if isinstance(seq, str) else seq,
                      dtype=np.uint8)
    return CODE[a]


def decode_seq(codes):
    """uint8 codes -> ASCII string. Codes >3 become 'N'."""
    codes = np.asarray(codes, dtype=np.uint8)
    out = np.full(codes.shape, ord("N"), dtype=np.uint8)
    ok = codes < 4
    out[ok] = DECODE[codes[ok]]
    return out.tobytes().decode()


def revcomp_codes(codes):
    """Reverse complement in code space (A<->T, C<->G), pads map to pads."""
    codes = np.asarray(codes, dtype=np.uint8)
    out = np.where(codes < 4, 3 - codes, codes)
    return out[::-1].copy()


class ReadStore:
    def __init__(self, names, lengths, offsets, data):
        self.names = list(names)
        self.lengths = np.asarray(lengths, dtype=np.int64)
        self.offsets = np.asarray(offsets, dtype=np.int64)
        self.data = np.asarray(data, dtype=np.uint8)
        self.blocks = []  # list of np.ndarray of read ids
        self.mask = None  # per-base soft-mask track (io.masking), flat bool

    # -- construction ------------------------------------------------------
    @classmethod
    def from_fasta_files(cls, paths, min_len=0):
        names, lens, chunks = [], [], []
        for rec in fasta.read_fasta_files(paths):
            if len(rec.sequence) < min_len:
                continue
            names.append(rec.name)
            codes = encode_seq(rec.sequence)
            lens.append(len(codes))
            chunks.append(codes)
        if chunks:
            data = np.concatenate(chunks)
        else:
            data = np.zeros(0, dtype=np.uint8)
        lens = np.asarray(lens, dtype=np.int64)
        offsets = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        return cls(names, lens, offsets, data)

    @classmethod
    def from_seqs(cls, seqs, names=None):
        if names is None:
            names = ["%09d" % i for i in range(len(seqs))]
        lens = np.asarray([len(s) for s in seqs], dtype=np.int64)
        offsets = np.zeros(len(lens) + 1, dtype=np.int64)
        np.cumsum(lens, out=offsets[1:])
        data = (np.concatenate([encode_seq(s) for s in seqs])
                if len(seqs) else np.zeros(0, dtype=np.uint8))
        return cls(names, lens, offsets, data)

    # -- basic access ------------------------------------------------------
    def __len__(self):
        return len(self.lengths)

    @property
    def total_bases(self):
        return int(self.lengths.sum())

    def get_codes(self, rid):
        o = self.offsets[rid]
        return self.data[o:o + self.lengths[rid]]

    def get_seq(self, rid):
        return decode_seq(self.get_codes(rid))

    def rid_name(self, rid):
        return self.names[rid]

    # -- block partition (DBsplit analog) ----------------------------------
    def split_blocks(self, block_bases=200_000_000):
        """Greedy partition of reads (in store order) into blocks of at most
        block_bases total bases (a block always holds >=1 read).
        Reference default: DBsplit -s200 (MB) (run_support.py:357,362)."""
        blocks = []
        cur, cur_bases = [], 0
        for rid in range(len(self)):
            ln = int(self.lengths[rid])
            if cur and cur_bases + ln > block_bases:
                blocks.append(np.asarray(cur, dtype=np.int32))
                cur, cur_bases = [], 0
            cur.append(rid)
            cur_bases += ln
        if cur:
            blocks.append(np.asarray(cur, dtype=np.int32))
        self.blocks = blocks
        return blocks

    # -- device views ------------------------------------------------------
    def dense_block(self, rids, pad_to=None, pad_multiple=128):
        """Return (codes[n, L] int8 padded with PAD, lengths[n] int32).

        L is max read length rounded up to pad_multiple (TPU lane width).
        """
        rids = np.asarray(rids, dtype=np.int64)
        lens = self.lengths[rids].astype(np.int32)
        L = int(pad_to if pad_to is not None else (lens.max() if len(lens) else 0))
        L = ((L + pad_multiple - 1) // pad_multiple) * pad_multiple
        out = np.full((len(rids), max(L, pad_multiple)), PAD, dtype=np.int8)
        for i, rid in enumerate(rids):
            c = self.get_codes(rid)
            out[i, :len(c)] = c
        return out, lens

    # 2-bit packing of block codes lives in ops.align_device
    # (pack_flat_2bit + the on-device unpacking gather): the overlap
    # engine's spec path ships every block to HBM 2-bit packed.

    # -- soft-mask tracks (DBdust / TANmask analog) ------------------------
    def build_masks(self, dust=True, tandem=True):
        """Per-base low-complexity + tandem soft-mask track (the
        DBdust + datander/TANmask/Catrack roles, reference:
        falcon_kit/bash.py:164-213, mains/dazzler.py:220-338).  Masks
        only suppress seed k-mers; see io.masking."""
        from . import masking
        self.mask = masking.build_mask(self.data, self.offsets,
                                       dust=dust, tandem=tandem)
        return self.mask

    def get_mask(self, rid):
        if self.mask is None:
            return None
        o = self.offsets[rid]
        return self.mask[o:o + self.lengths[rid]]

    # -- stats / cutoff ----------------------------------------------------
    def length_histogram(self, bin_size=1000):
        """(bin_start, count, cum_bases_from_top) rows, like DBstats output
        consumed by functional.calc_cutoff (reference: functional.py:225-283)."""
        lens = np.sort(self.lengths)[::-1]
        bins = (lens // bin_size) * bin_size
        rows = []
        for b in np.unique(bins)[::-1]:
            sel = bins == b
            rows.append((int(b), int(sel.sum()), int(lens[sel].sum())))
        return rows

    def calc_length_cutoff(self, target_coverage, genome_size, min_cutoff=0):
        """Smallest length L such that reads of length >= L total at least
        coverage*genome_size bases (the reference's seed auto-cutoff,
        reference: falcon_kit/functional.py:225-283, run_support.py:369).
        Raises if even all reads cannot reach the target (the reference
        errors in that case too)."""
        target = int(target_coverage) * int(genome_size)
        lens = np.sort(self.lengths)[::-1]
        csum = np.cumsum(lens)
        if len(lens) == 0 or csum[-1] < target:
            raise ValueError(
                "Not enough reads available for desired genome coverage "
                "(bases=%d < target=%d)" % (int(csum[-1]) if len(lens) else 0, target))
        idx = int(np.searchsorted(csum, target))
        cutoff = int(lens[idx]) if idx < len(lens) else int(lens[-1])
        return max(cutoff, min_cutoff)

    # -- persistence -------------------------------------------------------
    def save(self, path):
        np.savez(path if str(path).endswith(".npz") else str(path) + ".npz",
                 lengths=self.lengths, offsets=self.offsets, data=self.data,
                 blocks_flat=(np.concatenate(self.blocks)
                              if self.blocks else np.zeros(0, np.int32)),
                 blocks_sizes=np.asarray([len(b) for b in self.blocks],
                                         dtype=np.int64),
                 mask_bits=(np.packbits(self.mask)
                            if self.mask is not None
                            else np.zeros(0, np.uint8)))
        names_path = str(path)
        if names_path.endswith(".npz"):
            names_path = names_path[:-4]
        with open(names_path + ".names", "w") as f:
            for n in self.names:
                f.write(n + "\n")

    @classmethod
    def load(cls, path):
        npz_path = path if str(path).endswith(".npz") else str(path) + ".npz"
        z = np.load(npz_path, mmap_mode="r")
        names_path = str(npz_path)[:-4] + ".names"
        with open(names_path) as f:
            names = [l.strip() for l in f if l.strip()]
        rs = cls(names, z["lengths"], z["offsets"], z["data"])
        if "mask_bits" in z and len(z["mask_bits"]):
            rs.mask = np.unpackbits(
                z["mask_bits"])[:len(rs.data)].astype(bool)
        sizes = z["blocks_sizes"]
        flat = z["blocks_flat"]
        blocks, pos = [], 0
        for s in sizes:
            blocks.append(np.asarray(flat[pos:pos + int(s)], dtype=np.int32))
            pos += int(s)
        rs.blocks = blocks
        return rs
