"""Consensus driver: seed-grouped error correction -> preads.

Exact reimplementation of the reference fc_consensus front-end
(reference: falcon_kit/mains/consensus.py): group gating
(min_n_read / min_cov_aln, 100kb clip, dedup of support ids,
get_seq_data :161-209), longest-read capping by max_cov_aln
(get_longest_reads :26-45), and the output rules (>=500bp, [ACGT]+ good
regions, --output-multi "prolog/<seed>N/0_len" naming, 80-col wrap,
consensus.py:276-299).

The compute itself (per-group generate_consensus) runs through
falcon_tpu_torch.ops -- host-exact kernels now, device batching via
ops.align_device when available.
"""
import re
import logging

from ..io import fasta
from ..ops import consensus_dp

LOG = logging.getLogger(__name__)

GOOD_REGION = re.compile("[ACGT]+")
MAX_SEQ_LEN = 100000  # the reference clips all reads at 100kb


class ConsensusConfig:
    def __init__(self, min_cov=6, K=8, max_n_read=500, min_idt=0.70,
                 edge_tolerance=1000, trim_size=50, min_cov_aln=10,
                 max_cov_aln=0, min_n_read=10, min_len_aln=0,
                 output_full=False, output_multi=False, trim=False,
                 n_core=None):
        # n_core: None = unset (callers pick a default); 0 = EXPLICIT
        # in-process FakePool (the reference's --n-core 0 determinism
        # mode, multiproc.py:10-26) -- the two must stay distinct: the
        # driver once treated 0 as unset and forked a pool inside
        # jax.distributed workers, deadlocking on inherited locks.
        self.min_cov = min_cov
        self.K = K
        self.max_n_read = max_n_read
        self.min_idt = min_idt
        self.edge_tolerance = edge_tolerance
        self.trim_size = trim_size
        self.min_cov_aln = min_cov_aln
        self.max_cov_aln = max_cov_aln
        self.min_n_read = min_n_read
        self.min_len_aln = min_len_aln
        self.output_full = output_full
        self.output_multi = output_multi
        self.trim = trim
        self.n_core = n_core

    @classmethod
    def from_option_string(cls, opts):
        """Parse a falcon_sense_option string, e.g.
        '--output-multi --min-idt 0.70 --min-cov 4 --max-n-read 200'."""
        cfg = cls()
        toks = opts.replace("_", "-").split()
        i = 0
        while i < len(toks):
            t = toks[i]
            if t == "--output-multi":
                cfg.output_multi = True
            elif t == "--output-full":
                cfg.output_full = True
            elif t == "--trim":
                cfg.trim = True
            elif t in ("--min-idt",):
                i += 1
                cfg.min_idt = float(toks[i])
            elif t in ("--min-cov",):
                i += 1
                cfg.min_cov = int(toks[i])
            elif t == "--min-cov-aln":
                i += 1
                cfg.min_cov_aln = int(toks[i])
            elif t == "--max-cov-aln":
                i += 1
                cfg.max_cov_aln = int(toks[i])
            elif t == "--max-n-read":
                i += 1
                cfg.max_n_read = int(toks[i])
            elif t == "--min-n-read":
                i += 1
                cfg.min_n_read = int(toks[i])
            elif t == "--min-len-aln":
                i += 1
                cfg.min_len_aln = int(toks[i])
            elif t == "--edge-tolerance":
                i += 1
                cfg.edge_tolerance = int(toks[i])
            elif t == "--trim-size":
                i += 1
                cfg.trim_size = int(toks[i])
            elif t == "--n-core":
                i += 1
                cfg.n_core = int(toks[i])
            i += 1
        return cfg


def get_longest_reads(seqs, max_n_read, max_cov_aln, sort=True):
    """Cap support reads by count and by coverage of the seed
    (reference: consensus.py:26-45)."""
    if sort:
        seqs = seqs[:1] + sorted(seqs[1:], key=lambda x: -len(x))
    longest_n_reads = max_n_read
    if max_cov_aln > 0:
        longest_n_reads = 1
        seed_len = len(seqs[0])
        read_cov = 0
        for seq in seqs[1:]:
            if read_cov // seed_len > max_cov_aln:
                break
            longest_n_reads += 1
            read_cov += len(seq)
        longest_n_reads = min(longest_n_reads, max_n_read)
    return seqs[:longest_n_reads]


def gate_group(seed_id, seqs_with_ids, cfg):
    """Apply the get_seq_data gates to one seed group.

    seqs_with_ids: [(read_id, seq)] with the seed first.  Returns the gated
    seq list (seed duplicated at [0] and [1], as fc_consensus feeds the
    kernel) or None if the group is dropped.
    (reference: get_seq_data, consensus.py:161-209)"""
    seqs = []
    seed_len = 0
    read_ids = set()
    read_cov = 0
    for read_id, seq in seqs_with_ids:
        if len(seq) > MAX_SEQ_LEN:
            seq = seq[:MAX_SEQ_LEN - 1]
        if len(seq) < cfg.min_len_aln:
            continue
        if not seqs:
            seqs.append(seq)  # the seed
            seed_len = len(seq)
        if read_id not in read_ids:  # seed is re-added here by design
            seqs.append(seq)
            read_ids.add(read_id)
            read_cov += len(seq)
    if not seqs:
        return None
    if len(seqs) >= cfg.min_n_read and read_cov // seed_len >= cfg.min_cov_aln:
        return get_longest_reads(seqs, cfg.max_n_read, cfg.max_cov_aln,
                                 sort=True)
    return None


def _generate(seqs, cfg):
    from ..ops import native
    if native.available():
        return native.generate_consensus(seqs, cfg.min_cov, cfg.K,
                                         cfg.min_idt)
    return consensus_dp.generate_consensus(
        seqs, min_cov=cfg.min_cov, K=cfg.K, min_idt=cfg.min_idt)


def consensus_for_group(seed_id, seqs, cfg):
    """(consensus_str, seed_id) for one gated group.  Uses the native C++
    kernel when available (identical output; see ops.native)."""
    if len(seqs) > cfg.max_n_read:
        seqs = get_longest_reads(seqs, cfg.max_n_read, cfg.max_cov_aln,
                                 sort=True)
    return _generate(seqs, cfg), seed_id


def get_alignment_for_trim(seq, seed, edge_tolerance=1000):
    """Support/seed k-mer chain used by the --trim pre-alignment pass.

    Bit-exact reimplementation of the reference's module-level
    get_alignment (falcon_kit/mains/consensus.py:48-99): K=8 lookup over
    the seed masked at freq 16, find_best_aln_range2(K*50, 25), ends
    padded by K + K//2 and clamped, then edge-tolerance gating.  Returns
    (s1, e1, s0, e0, aln_size, aln_score, "aln"|"none") where s1/e1 are
    coords on `seq` and s0/e0 on `seed`."""
    from ..ops import kmer
    K = 8
    lk = kmer.KmerLookup(seed, K)
    lk.mask(16)
    qp, tp = lk.find_kmer_pos_for_seq(seq)
    r = kmer.find_best_aln_range2(qp, tp, K, K * 50, 25)
    s1, e1, s0, e0, km_score = r.s1, r.e1, r.s2, r.e2, r.score
    e1 = min(e1 + K + K // 2, len(seq))
    e0 = min(e0 + K + K // 2, len(seed))
    aln_size = 1
    aln_score = 0
    if e1 - s1 > 500:
        aln_size = max(e1 - s1, e0 - s0)
        aln_score = int(km_score * 48)
    if s1 > edge_tolerance and s0 > edge_tolerance:
        return 0, 0, 0, 0, 0, 0, "none"
    if len(seq) - e1 > edge_tolerance and len(seed) - e0 > edge_tolerance:
        return 0, 0, 0, 0, 0, 0, "none"
    if e1 - s1 > 500 and aln_size > 500:
        return s1, e1, s0, e0, aln_size, aln_score, "aln"
    return 0, 0, 0, 0, 0, 0, "none"


def consensus_with_trim_for_group(seed_id, seqs, cfg):
    """--trim variant: pre-align each support to the seed with the k-mer
    chain, drop non-aligning supports, cut trim_size off both ends of
    each aligned span, sort longest-span first, re-cap, then run the
    consensus kernel (reference: get_consensus_with_trim,
    falcon_kit/mains/consensus.py:123-158; the duplicated seed at
    seqs[1] goes through the same trim pass by design)."""
    seed = seqs[0]
    trim_seqs = []
    for seq in seqs[1:]:
        (s1, e1, _s0, _e0, _aln_size, aln_score,
         c_status) = get_alignment_for_trim(seq, seed, cfg.edge_tolerance)
        if c_status == "none":
            continue
        if aln_score > 1000 and e1 - s1 > 500:
            e1 -= cfg.trim_size
            s1 += cfg.trim_size
            trim_seqs.append((e1 - s1, seq[s1:e1]))
    trim_seqs.sort(key=lambda x: -x[0])  # longest alignment first
    trim_seqs = [seed] + [x[1] for x in trim_seqs]
    if len(trim_seqs[1:]) > cfg.max_n_read:
        # already sorted; don't sort again
        trim_seqs = get_longest_reads(trim_seqs, cfg.max_n_read,
                                      cfg.max_cov_aln, sort=False)
    return _generate(trim_seqs, cfg), seed_id


def format_output(cns, seed_id, cfg, out):
    """Emit one group's consensus in the reference's output format
    (reference: consensus.py:276-299)."""
    if len(cns) < 500:
        return 0
    n = 0
    if cfg.output_full:
        out.write(">" + seed_id + "_f\n")
        out.write(cns + "\n")
        return 1
    regions = GOOD_REGION.findall(cns)
    if not regions:
        return 0
    if cfg.output_multi:
        seq_i = 0
        for cns_seq in regions:
            if len(cns_seq) < 500:
                continue
            if seq_i >= 10:
                break
            out.write(">prolog/%s%01d/%d_%d\n" % (seed_id, seq_i, 0,
                                                  len(cns_seq)))
            out.write(fasta.format_seq(cns_seq, 80) + "\n")
            seq_i += 1
            n += 1
    else:
        regions.sort(key=len)
        out.write(">" + seed_id + "\n")
        out.write(regions[-1] + "\n")
        n = 1
    return n


def _pool_worker(task):
    seed_id, seqs, cfg, mark = task
    if cfg.trim:
        cns, sid = consensus_with_trim_for_group(seed_id, seqs, cfg)
    else:
        cns, sid = consensus_for_group(seed_id, seqs, cfg)
    return cns, sid, mark


def run_consensus(groups, cfg, out, n_core=None, progress_cb=None,
                  progress_every=200):
    """groups: iterable of (seed_id, [(read_id, seq), ...]).  Writes pread
    FASTA to `out`; returns number of sequences emitted.  n_core > 0 fans
    the per-group kernel out over a process pool (reference:
    consensus.py:264-274 Pool.imap; FakePool determinism mode at 0).

    progress_cb(k): called with k = input groups completely processed
    and durably emitted, every `progress_every` emitted groups -- same
    checkpoint contract as cns.device.run_consensus_device (emission
    order == task order under imap, so when the task pulled as group m
    is emitted, every group up to m is finished; gated-out groups
    between tasks count at the next emission)."""
    import multiprocessing
    from ..utils.pool import Pool
    if n_core is None:
        n_core = cfg.n_core if cfg.n_core is not None else 0
    n_core = min(n_core, multiprocessing.cpu_count())

    n_pulled = [0]

    def gated_tasks():
        for seed_id, seqs_with_ids in groups:
            n_pulled[0] += 1
            gated = gate_group(seed_id, seqs_with_ids, cfg)
            if gated is None:
                continue
            yield seed_id, gated, cfg, n_pulled[0]

    emitted = 0
    since = 0
    pool = Pool(n_core)
    try:
        for cns, sid, mark in pool.imap(_pool_worker, gated_tasks()):
            emitted += format_output(cns, sid, cfg, out)
            since += 1
            if progress_cb is not None and since >= progress_every:
                progress_cb(mark)
                since = 0
    finally:
        pool.terminate()
    if progress_cb is not None:
        # all tasks drained: every pulled group (incl. trailing
        # gated-out ones) is final
        progress_cb(n_pulled[0])
    return emitted
