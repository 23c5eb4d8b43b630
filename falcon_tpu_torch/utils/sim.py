"""Synthetic long-read simulator for tests and benchmarks.

The reference ships a 2-block synthetic workload ("synth0") as checked-in
daligner job plans only (reference: test/HPCdaligner_synth0.sh) -- the actual
read generator is not in-repo.  We provide a deterministic simulator so the
full pipeline (overlap -> consensus -> graph -> contigs) can be exercised
end-to-end and scored against ground truth.
"""
import numpy as np

BASES = np.frombuffer(b"ACGT", dtype=np.uint8)


def random_genome(size, seed=1234567, circular=False):
    rng = np.random.RandomState(seed)
    g = BASES[rng.randint(0, 4, size=size)]
    return g.tobytes().decode()


def mutate(seq_arr, rng, sub=0.005, ins=0.005, dele=0.005):
    """Apply random substitutions/insertions/deletions to a uint8 base array."""
    out = []
    n = len(seq_arr)
    r = rng.rand(n)
    ops = np.full(n, 0, dtype=np.int8)  # 0=match 1=sub 2=ins 3=del
    ops[r < sub + ins + dele] = 1
    ops[r < ins + dele] = 2
    ops[r < dele] = 3
    for i in range(n):
        op = ops[i]
        if op == 0:
            out.append(seq_arr[i])
        elif op == 1:
            out.append(BASES[(np.searchsorted(BASES, seq_arr[i]) + rng.randint(1, 4)) % 4])
        elif op == 2:
            out.append(BASES[rng.randint(0, 4)])
            out.append(seq_arr[i])
        # op == 3: deletion, emit nothing
    return np.asarray(out, dtype=np.uint8)


_RC_TABLE = np.zeros(256, dtype=np.uint8)
for _a, _b in ((65, 84), (67, 71), (71, 67), (84, 65)):
    _RC_TABLE[_a] = _b


def _rc(arr):
    # table lookup (bit-identical to the old per-base dict loop, which
    # cost ~1us/base -- an hour of pure python at Dmel-sim scale)
    return _RC_TABLE[arr[::-1]]


def mutate_fast(seq_arr, rng, sub=0.005, ins=0.005, dele=0.005):
    """Vectorized mutate: same op model and rates, different RNG draw
    ORDER than mutate() (one vector draw per op class instead of
    per-base interleaved draws), so it yields different-but-equivalent
    reads for the same seed.  Use for large-scale benches; tests keep
    mutate() so their pinned datasets stay stable."""
    n = len(seq_arr)
    r = rng.rand(n)
    ops = np.zeros(n, dtype=np.int8)  # 0=match 1=sub 2=ins 3=del
    ops[r < sub + ins + dele] = 1
    ops[r < ins + dele] = 2
    ops[r < dele] = 3
    code = np.searchsorted(BASES, seq_arr)
    main = BASES[code]
    subm = ops == 1
    nsub = int(subm.sum())
    if nsub:
        main = main.copy()
        main[subm] = BASES[(code[subm] +
                            rng.randint(1, 4, nsub)) % 4]
    keep = ops != 3
    kept = main[keep]
    insm = np.nonzero(ops == 2)[0]
    if len(insm):
        # inserted base goes BEFORE the original base at i (mutate())
        at = np.cumsum(keep)[insm] - 1      # index of base i in `kept`
        kept = np.insert(kept, at, BASES[rng.randint(0, 4, len(insm))])
    return kept


def simulate_reads(genome, coverage=20.0, mean_len=8000, min_len=1000,
                   error=0.01, seed=42, circular=False, with_truth=False,
                   fast=False):
    """Sample noisy reads from a genome string.

    error is the total per-base error rate, split equally between
    substitution, insertion and deletion.  Returns list of (name, seq)
    or, with with_truth, (name, seq, (start, end, strand)).
    fast=True uses the vectorized mutator (equivalent error model,
    different RNG draw order -- for >100 Mbase benches)."""
    g = np.frombuffer(genome.encode(), dtype=np.uint8)
    G = len(g)
    rng = np.random.RandomState(seed)
    target = int(coverage * G)
    out = []
    total = 0
    i = 0
    while total < target:
        ln = int(rng.gamma(4.0, mean_len / 4.0))
        ln = max(min_len, min(ln, G if not circular else 4 * mean_len))
        if circular:
            start = rng.randint(0, G)
            idx = (start + np.arange(ln)) % G
            frag = g[idx]
        else:
            start = rng.randint(0, max(1, G - ln + 1))
            frag = g[start:start + ln]
            ln = len(frag)
        strand = int(rng.randint(0, 2))
        if strand:
            frag = _rc(frag)
        e = error / 3.0
        read = (mutate_fast if fast else mutate)(
            frag, rng, sub=e, ins=e, dele=e)
        name = "%09d" % i
        if with_truth:
            out.append((name, read.tobytes().decode(), (int(start), int(start + ln), strand)))
        else:
            out.append((name, read.tobytes().decode()))
        total += len(read)
        i += 1
    return out
