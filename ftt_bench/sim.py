"""The benchmark's frozen copy of the port's read simulator
(falcon_tpu_torch/utils/sim.py: random_genome, mutate, mutate_fast,
simulate_reads), so that later changes to the port's copy leave the
traffic as it is.

The draws are the original's, in the original's order: for one seed this
gives the same genome and the same reads.  What it adds is the truth that
the original throws away: with_maps=True also returns, for each read, the
map `pre` from an index f of the genome fragment the read was drawn from
(on the read's strand) to the index in the read where base f landed, or
where it would have landed had it not been deleted; pre[len(frag)] is the
read's length.  A genome interval thus maps to a read interval exactly.
"""
import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)
# np.searchsorted(BASES, x) for x in ACGT, as a table
_CODE = np.zeros(256, np.int64)
_CODE[BASES] = np.arange(4)

_RC_TABLE = np.zeros(256, dtype=np.uint8)
for _a, _b in ((65, 84), (67, 71), (71, 67), (84, 65)):
    _RC_TABLE[_a] = _b


def rc(arr):
    """Reverse complement of an ASCII uint8 array."""
    return _RC_TABLE[arr[::-1]]


def random_genome(size, seed=1234567):
    rng = np.random.RandomState(seed)
    return BASES[rng.randint(0, 4, size=size)]


def _ops(n, rng, sub, ins, dele):
    r = rng.rand(n)
    ops = np.zeros(n, dtype=np.int8)  # 0=match 1=sub 2=ins 3=del
    ops[r < sub + ins + dele] = 1
    ops[r < ins + dele] = 2
    ops[r < dele] = 3
    return ops


def _pre_map(ops, kept_upto=None):
    """pre[f]: index in the read of fragment base f (kept bases; an
    inserted base goes before base f), or where a deleted one would be.
    kept_upto: np.cumsum(ops != 3), where the caller has it."""
    if kept_upto is None:
        kept_upto = np.cumsum(ops != 3)
    ins_upto = np.cumsum(ops == 2)
    pre = np.empty(len(ops) + 1, np.int64)
    pre[0] = 0
    pre[1:] = kept_upto
    pre[:-1] += ins_upto
    pre[-1] += ins_upto[-1] if len(ops) else 0
    return pre.astype(np.int32)


def mutate(seq_arr, rng, sub=0.005, ins=0.005, dele=0.005):
    """Per-base substitutions/insertions/deletions, drawn base by base
    (the original's slow mutator, kept for equal reads)."""
    out = []
    ops = _ops(len(seq_arr), rng, sub, ins, dele)
    for i in range(len(seq_arr)):
        op = ops[i]
        if op == 0:
            out.append(seq_arr[i])
        elif op == 1:
            out.append(BASES[(np.searchsorted(BASES, seq_arr[i]) +
                              rng.randint(1, 4)) % 4])
        elif op == 2:
            out.append(BASES[rng.randint(0, 4)])
            out.append(seq_arr[i])
    return np.asarray(out, dtype=np.uint8), ops


def mutate_fast(seq_arr, rng, sub=0.005, ins=0.005, dele=0.005,
                with_map=False):
    """Vectorized mutator: the same op model and rates as mutate, one
    vector draw per op class.  Returns (read, ops), or (read, pre map)
    with with_map."""
    n = len(seq_arr)
    ops = _ops(n, rng, sub, ins, dele)
    code = _CODE[seq_arr]
    main = seq_arr
    subm = ops == 1
    nsub = int(subm.sum())
    if nsub:
        main = main.copy()
        main[subm] = BASES[(code[subm] + rng.randint(1, 4, nsub)) % 4]
    keep = ops != 3
    kept = main[keep]
    kept_upto = np.cumsum(keep)
    insm = np.nonzero(ops == 2)[0]
    if len(insm):
        at = kept_upto[insm] - 1
        kept = np.insert(kept, at, BASES[rng.randint(0, 4, len(insm))])
    return kept, (_pre_map(ops, kept_upto) if with_map else ops)


def simulate_reads(genome, coverage=20.0, mean_len=8000, min_len=1000,
                   error=0.01, seed=42, fast=True, with_maps=False):
    """Noisy linear reads of an ASCII uint8 genome.  Returns (reads, truth)
    or, with with_maps, (reads, truth, maps): reads a list of ASCII uint8
    arrays; truth an int64 [n, 3] array of (start, end, strand) on the
    genome; maps the per-read `pre` arrays (module docstring)."""
    G = len(genome)
    rng = np.random.RandomState(seed)
    target = int(coverage * G)
    reads, truth, maps = [], [], []
    total = 0
    e = error / 3.0
    while total < target:
        ln = int(rng.gamma(4.0, mean_len / 4.0))
        ln = max(min_len, min(ln, G))
        start = rng.randint(0, max(1, G - ln + 1))
        frag = genome[start:start + ln]
        ln = len(frag)
        strand = int(rng.randint(0, 2))
        if strand:
            frag = rc(frag)
        if fast:
            read, pre = mutate_fast(frag, rng, e, e, e, with_map=True)
        else:
            read, ops = mutate(frag, rng, e, e, e)
            pre = _pre_map(ops)
        reads.append(read)
        truth.append((start, start + ln, strand))
        if with_maps:
            maps.append(pre)
        total += len(read)
    truth = np.asarray(truth, np.int64).reshape(-1, 3)
    return (reads, truth, maps) if with_maps else (reads, truth)
