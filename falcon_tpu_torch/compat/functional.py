"""Pure parsing functions over reference-FALCON tool output.

Behavior-compatible re-implementations of falcon_kit/functional.py (the
reference's "purely functional code"): HPC.daligner job-plan parsing
(reference functional.py:56-188), DBstats-based length-cutoff calculation
(:225-283), pread fragmentation/truncation metrics (:311-378), FOFN cat
selection (:381-400) and flag/config normalization (:403-512).

These exist for migration tooling: falcon_tpu_torch itself never generates or
consumes HPC.daligner plans (the overlap engine plans block pairs
in-process), but an existing FALCON run tree contains them, and
`fc_hgap_adapt` plus users' own scripts may need to read them.
"""
import re


# ---------------------------------------------------------------------------
# HPC.daligner job-plan parsing (reference functional.py:56-188)

def get_daligner_job_descriptions(run_jobs_stream, db_prefix, single=False):
    """Parse HPC.daligner output into {block-suffix-tuple: bash script}.

    Each daligner line becomes one job; the key is the tuple of block
    suffixes ('.1', '.2', ... or '' for a single-block DB) in the order
    they appear on the line; the script is the daligner line followed by
    an LAcheck over the scratch .las files.

    >>> plan = '''# Daligner jobs (2)
    ... daligner -v -t16 raw.1 raw.1
    ... daligner -v -t16 raw.2 raw.1 raw.2
    ... '''
    >>> d = get_daligner_job_descriptions(plan.splitlines(True), 'raw')
    >>> sorted(d.keys())
    [('.1', '.1'), ('.2', '.1', '.2')]
    >>> print(d[('.1', '.1')], end='')
    daligner -v -t16 raw.1 raw.1
    LAcheck -v raw *.las
    """
    blocks_re = re.compile(re.escape(db_prefix) + r"(\.\d+|)")
    lines = [ln.strip() for ln in run_jobs_stream]
    assert any(len(ln) > 1 for ln in lines), repr("\n".join(lines))
    jobs = {}
    for ln in lines:
        if not ln.startswith("daligner"):
            continue
        key = tuple(m.group(1) for m in blocks_re.finditer(ln))
        jobs[key] = "%s\nLAcheck -v %s *.las\n" % (ln, db_prefix)
    return jobs


def skip_LAcheck(bash):
    """Soften LAcheck failures: wrap each LAcheck line in set +e / set -e.

    >>> print(skip_LAcheck('a\\nLAcheck -v db *.las\\nb\\n'), end='')
    a
    set +e
    LAcheck -v db *.las
    set -e
    b
    """
    out = []
    for ln in bash.splitlines(True):
        if "LAcheck" in ln:
            out.append("set +e\n")
            out.append(ln)
            out.append("set -e\n")
        else:
            out.append(ln)
    return "".join(out)


_FIRST_BLOCK_RE = re.compile(r"^(?:\S+)(?:\s+-\S+)*\s+[^.]+\.(\d+|)")


def first_block_las(line):
    """Block id of the first non-flag .las argument of an LA* line.

    >>> first_block_las('LAsort -v -a foo.1.foo.1.C0')
    1
    >>> first_block_las('LAmerge -v raw_reads.2 L1.2.1 L1.2.2')
    2
    """
    mo = _FIRST_BLOCK_RE.search(line)
    try:
        return int(mo.group(1))
    except Exception as exc:
        raise Exception(
            "Pattern %r does not match line %r: %s"
            % (_FIRST_BLOCK_RE.pattern, line, exc))


def get_mjob_data(run_jobs_stream):
    """Parse HPC.daligner merge-level lines into {block id: [bash lines]}.

    Only LAmerge/rm lines participate (initial LAsorts run with the
    daligner jobs in the reference flow and must not appear here).

    >>> plan = '''daligner -v raw.1 raw.1
    ... LAmerge -v raw_reads.1 L1.1.1 L1.1.2 && rm L1.1.1.las L1.1.2.las
    ... LAmerge -v raw_reads.2 L1.2.1 L1.2.2 ; rm L1.2.1.las L1.2.2.las
    ... '''
    >>> d = get_mjob_data(plan.splitlines(True))
    >>> sorted(d.keys())
    [1, 2]
    >>> d[2]
    ['LAmerge -v raw_reads.2 L1.2.1 L1.2.2 ; rm L1.2.1.las L1.2.2.las']
    """
    jobs = {}
    for ln in run_jobs_stream:
        ln = ln.strip()
        if not ln:
            continue
        word = ln.split()[0]
        if word == "LAsort":
            raise Exception("We do not expect to see LAsort at all anymore.")
        if word in ("LAmerge", "rm"):
            jobs.setdefault(first_block_las(ln), []).append(ln)
    return jobs


_LAMERGE_OUT_RE = re.compile(r"^LAmerge\s+(?:-\S+\s+)(\S+)")
_LACHECK_OUT_RE = re.compile(r"^LAcheck\s+(?:-\S+\s+)\S+\s+(\S+)")


def get_las_filenames(mjob_data, db_prefix):
    """Final merged .las filename per block, from get_mjob_data() output.

    Blocks with no merge lines keep the daligner-produced name
    '<db_prefix>.<block>.las'; otherwise the last LAmerge/LAcheck line
    names the output.

    >>> get_las_filenames({1: [], 2: ['LAmerge -v raw.2 L1.2.1']}, 'raw')
    {1: 'raw.1.las', 2: 'raw.2.las'}
    """
    out = {}
    for p_id, bash_lines in mjob_data.items():
        if not bash_lines:
            out[p_id] = "%s.%s.las" % (db_prefix, p_id)
            continue
        i = len(bash_lines) - 1
        while bash_lines[i].split()[0] not in ("LAmerge", "LAcheck"):
            i -= 1
        word = bash_lines[i].split()[0]
        rx = _LAMERGE_OUT_RE if word == "LAmerge" else _LACHECK_OUT_RE
        mo = rx.search(bash_lines[i])
        if not mo:
            raise Exception("Regex %r failed on %r"
                            % (rx.pattern, bash_lines[i]))
        out[p_id] = mo.group(1) + ".las"
    return out


def yield_args_from_line(bash_line):
    """Positional (non-flag) arguments of an LAsort/LAmerge/LAcheck line.

    >>> list(yield_args_from_line('LAmerge -v out.las in1.las in2.las'))
    ['out.las', 'in1.las', 'in2.las']
    """
    for word in bash_line.split():
        if word.startswith("-") or word in ("LAcheck", "LAmerge", "LAsort"):
            continue
        yield word


_DALIGNER_WORD_RE = re.compile(r"^daligner\b", re.MULTILINE)


def xform_script_for_preads(script):
    """Swap daligner for daligner_p (the pread overlap variant).

    >>> xform_script_for_preads('daligner -v a b\\nLAcheck a')
    'daligner_p -v a b\\nLAcheck a'
    """
    return _DALIGNER_WORD_RE.sub("daligner_p", script)


def xform_script_for_raw_reads(script):
    return script


def get_script_xformer(pread_aln):
    return xform_script_for_preads if pread_aln \
        else xform_script_for_raw_reads


# ---------------------------------------------------------------------------
# DBstats -> length cutoff (reference functional.py:225-283; the in-store
# equivalent is io.readstore.ReadStore.calc_length_cutoff)

class GenomeCoverageError(Exception):
    pass


def num2int(num):
    """
    >>> num2int('1,000,000')
    1000000
    """
    return int(num.replace(",", ""))


_DBSTATS_BIN_RE = re.compile(
    r"^\s*(?P<bin>\S+):\s+(?P<count>\S+)\s+\S+\s+\S+\s+\S+\s*$")


def get_reverse_sorted_readlength_counts_from_DBstats(DBstats_output):
    """[(read_length, count)] rows of a 'DBstats -b1' histogram, longest
    first (the order DBstats prints them)."""
    rows = []
    for line in DBstats_output.splitlines():
        mo = _DBSTATS_BIN_RE.search(line)
        if mo:
            rows.append((num2int(mo.group("bin")),
                         num2int(mo.group("count"))))
    return rows


def calc_cutoff_from_reverse_sorted_readlength_counts(rl_counts, target):
    """Smallest read length such that all reads >= it total >= target bases.

    >>> calc_cutoff_from_reverse_sorted_readlength_counts(
    ...     [(10, 2), (5, 2)], 25)
    5
    """
    total = sum(rl * cnt for rl, cnt in rl_counts)
    if target > total:
        raise GenomeCoverageError(
            "Not enough reads available for desired genome coverage "
            "(bases needed=%s > actual=%s)" % (target, total))
    acc = 0
    for rl, cnt in rl_counts:
        acc += rl * cnt
        if acc >= target:
            return rl
    raise Exception("Impossible target: target=%s, total=%s"
                    % (target, total))


def calc_cutoff(target, DBstats_output):
    """Length cutoff capturing at least `target` bases, from DBstats text."""
    return calc_cutoff_from_reverse_sorted_readlength_counts(
        get_reverse_sorted_readlength_counts_from_DBstats(DBstats_output),
        target)


# ---------------------------------------------------------------------------
# fragmentation / truncation metrics from captured tool output
# (reference functional.py:286-378; the in-store equivalent is
# pipeline.stats.fragmentation_truncation)

def parse_2columns_of_ints(data):
    r"""
    >>> tuple(parse_2columns_of_ints("1 2\n3 4"))
    ((1, 2), (3, 4))
    """
    for line in data.splitlines():
        line = line.strip()
        if line:
            yield tuple(int(x) for x in line.split())


def weighted_average(cols):
    """
    >>> weighted_average(((100, 1), (200, 2), (100, 5)))
    2.5
    """
    return sum(w * v for w, v in cols) / sum(w for w, _ in cols)


def calc_metric_fragmentation(perl_counts_output):
    """Mean preads per corrected seed, from '<count> <preads-per-seed>'
    histogram rows."""
    return weighted_average(tuple(parse_2columns_of_ints(
        perl_counts_output)))


_DBDUMP_R_RE = re.compile(r"^R\s+(\d+)$")
_DBDUMP_L_RE = re.compile(r"^L\s+(\d+)\s+(\d+)\s+(\d+)$")


def mapped_readlengths_from_dbdump_output(output):
    """{read id: length} from DBdump R/L line pairs."""
    lengths = {}
    rid = None
    for line in output.splitlines():
        mo = _DBDUMP_R_RE.search(line)
        if mo:
            rid = int(mo.group(1))
            continue
        mo = _DBDUMP_L_RE.search(line)
        if mo:
            lengths[rid] = int(mo.group(3)) - int(mo.group(2))
    return lengths


def average_difference(dictA, dictB):
    """Mean of (dictA[k] - dictB[k]) over dictA's keys; KeyError if any
    key is missing from dictB."""
    return sum(va - dictB[k] for k, va in dictA.items()) / len(dictA)


def calc_metric_truncation(dbdump_output, length_pairs_output):
    """Mean bases lost per corrected seed: original DBdump lengths minus
    summed pread span per seed ('<seed id> <pread bases>' rows)."""
    pread_lengths = dict(parse_2columns_of_ints(length_pairs_output))
    orig_lengths = mapped_readlengths_from_dbdump_output(dbdump_output)
    return -average_difference(pread_lengths, orig_lengths)


# ---------------------------------------------------------------------------
# misc normalization (reference functional.py:381-512)

def choose_cat_fasta(fofn):
    """Shell prefix that streams the FOFN's (uniform) fasta type to stdout.

    >>> choose_cat_fasta('abc.gz')
    'zcat '
    >>> choose_cat_fasta('abc.dexta')
    'undexta -vkU -w60 -i < '
    >>> choose_cat_fasta('abc')
    'cat '
    """
    first = fofn.splitlines()[0]
    if first.endswith(".gz"):
        return "zcat "
    if first.endswith(".dexta"):
        return "undexta -vkU -w60 -i < "
    return "cat "


_UNDERSCORE_FLAG_RE = re.compile(r"(--[\w-]+)_")


def dash_flags(val):
    """Underscores inside long flags become dashes.

    >>> dash_flags('--foo_bar --one_two_three')
    '--foo-bar --one-two-three'
    >>> dash_flags('')
    ''
    """
    while True:
        new = _UNDERSCORE_FLAG_RE.sub(r"\1-", val)
        if new == val:
            return new
        val = new


def cfg_tobool(v):
    """
    >>> [cfg_tobool(x) for x in ('yes', 'T', '1', 'no', 'F', '0', '')]
    [True, True, True, False, False, False, False]
    """
    if v in (True, False, None):
        return v
    if not v:
        return False
    head = v.upper()[0]
    if head in ("T", "Y"):
        return True
    if head in ("F", "N"):
        return False
    return bool(int(v))


class LowerDict(dict):
    """dict with case-insensitive (lower-cased) string keys."""
    __slots__ = ()

    def __init__(self):
        super().__init__()

    def __getitem__(self, k):
        return super().__getitem__(k.lower())

    def __setitem__(self, k, v):
        super().__setitem__(k.lower(), v)

    def __delitem__(self, k):
        super().__delitem__(k.lower())

    def __contains__(self, k):
        return super().__contains__(k.lower())

    def get(self, k, default=None):
        return super().get(k.lower(), default)

    def setdefault(self, k, default=None):
        return super().setdefault(k.lower(), default)

    def pop(self, k, *default):
        return super().pop(k.lower(), *default)

    @classmethod
    def fromkeys(cls, keys, v=None):
        return super().fromkeys((k.lower() for k in keys), v)

    def __repr__(self):
        return "%s(%s)" % (type(self).__name__, super().__repr__())


def toLowerDict(cfg):
    """Recursively convert a nested dict to LowerDicts; raises on key
    collisions with differing values.

    >>> d = toLowerDict({'Foo': {'BAR': 1}})
    >>> d['foo']['bar']
    1
    """
    if isinstance(cfg, LowerDict):
        return cfg
    low = LowerDict()
    for k, v in cfg.items():
        if isinstance(v, dict):
            v = toLowerDict(v)
        if k in low and v != low[k]:
            raise Exception("Collision for %r in dict:\n%s" % (k, cfg))
        low[k] = v
    return low
