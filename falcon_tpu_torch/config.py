"""Configuration: [General]-style cfg parsing with reference-compatible keys.

Accepts the reference's ini-with-sections or JSON configs
(reference: falcon_kit/run_support.py:146-163 parse_cfg_file, defaults
:347-430), so existing fc_run cfgs (e.g. examples/fc_run_ecoli.cfg) drive
this pipeline unmodified.  Option strings meant for external Dazzler tools
(pa_HPCdaligner_option, DBsplit options) are parsed into the native overlap
engine's parameters instead of being shelled out.
"""
import configparser
import json
import logging
import re

LOG = logging.getLogger(__name__)

DEFAULTS = {
    # reference defaults (run_support.py:347-430)
    "input_fofn": "input.fofn",
    "input_type": "raw",
    "genome_size": "0",
    "seed_coverage": "20",
    "length_cutoff": "-1",
    "length_cutoff_pr": "0",
    "pa_DBsplit_option": "-x500 -s200",
    "ovlp_DBsplit_option": "-x500 -s200",
    "pa_HPCdaligner_option": "-v -D24 -t16 -e.70 -l1000 -s100",
    "ovlp_HPCdaligner_option": "-v -D24 -t32 -h60 -e.96 -l500 -s1000",
    "falcon_sense_option":
        "--output-multi --min-idt 0.70 --min-cov 2 --max-n-read 1800",
    "falcon_sense_greedy": "False",
    "falcon_sense_skip_contained": "False",
    "overlap_filtering_setting": "--max-diff 1000 --max-cov 1000 --min-cov 2",
    "fc_ovlp_to_graph_option": "",
    "bestn": "12",
    "target": "assembly",
    "skip_checks": "False",
    # accepted for reference-cfg compatibility; the external Dazzler tools
    # they parameterize do not exist here (run_support.py:358-366)
    "pa_DBdust_option": "",
    "dazcon": "False",
    "pa_dazcon_option": "-j 4 -x -l 500",
    "LA4Falcon_preload": "",
    # TPU-native additions
    "overlap_k": "14",
    "overlap_min_hits": "4",
    "overlap_band": "250",
    "overlap_stride": "4",
    "overlap_stride_pr": "16",
    "use_device": "true",
    # soft-mask tracks built into the raw ReadStore before overlapping
    # (the DBdust + TANmask roles; reference bash.py:164-213 runs both on
    # every raw DB).  Comma list of {dust, tan}; empty disables.
    "masking": "dust,tan",
}


def _coerce_bool(v):
    return str(v).strip().lower() in ("1", "true", "yes", "on")


# legacy [General] keys the reference migrates into [job.*] sections with a
# warning (run_support.py:411-430); accepted and folded into the job dict
_LEGACY_JOB_KEYS = (
    ["sge_option", "default_concurrent_jobs", "pwatcher_type",
     "pwatcher_directory", "job_type", "job_queue", "job_name_style",
     "use_tmpdir", "stop_all_jobs_on_failure"] +
    ["sge_option_%s" % s for s in
     ("da", "la", "pda", "pla", "fc", "cns", "asm")] +
    ["%s_concurrent_jobs" % s for s in
     ("da", "la", "pda", "pla", "fc", "cns", "asm")])


def parse_cfg_file(path):
    """ini-with-[General] or JSON -> flat dict of [General] keys, plus the
    scheduler sections under cfg['job'] ({'defaults': {...},
    'step.cns': {...}, ...}; reference run_support.py:146-163,311-320).
    Only concurrency hints (NPROC/njobs) are consumed here -- there is no
    cluster submission; the device mesh is the scale-out axis."""
    text = open(path).read()
    job = {}
    if path.endswith(".json") or text.lstrip().startswith("{"):
        data = json.loads(text)
        general = dict(data.get("General", data))
        for sec, vals in data.items():
            if sec.startswith("job.") and isinstance(vals, dict):
                job[sec[4:]] = {k.lower(): str(v) for k, v in vals.items()}
    else:
        cp = configparser.ConfigParser(strict=False)
        cp.read_string(text)
        if "General" not in cp:
            raise ValueError("cfg %r has no [General] section" % path)
        general = {k: v for k, v in cp["General"].items()}
        for sec in cp.sections():
            if sec.startswith("job."):
                job[sec[4:]] = {k.lower(): str(v)
                                for k, v in cp[sec].items()}
    cfg = dict(DEFAULTS)
    unknown = []
    known = {k.lower() for k in DEFAULTS}
    known.update(k.lower() for k in _LEGACY_JOB_KEYS)
    for k, v in general.items():
        kl = k.lower()
        if kl not in known and not kl.startswith("overlap_") \
                and kl not in ("use_device", "dust"):
            unknown.append(k)
        cfg[kl] = str(v)
    if "dust" in cfg:
        LOG.warning("The 'dust' option is deprecated and ignored.")
    if unknown:
        # reference check_unexpected_keys (run_support.py:436-460)
        LOG.warning("Unexpected keys in input config: %s", sorted(unknown))
    # legacy concurrency keys fold into job sections
    # (reference update_job_sections, run_support.py:256-276)
    defaults = job.setdefault("defaults", {})
    if cfg.get("default_concurrent_jobs") and "njobs" not in defaults:
        defaults["njobs"] = cfg["default_concurrent_jobs"]
    for step in ("da", "la", "pda", "pla", "fc", "cns", "asm"):
        key = "%s_concurrent_jobs" % step
        if cfg.get(key):
            job.setdefault("step.%s" % step, {}).setdefault(
                "njobs", cfg[key])
    cfg["job"] = job
    _validate(cfg)
    return cfg


def _validate(cfg):
    """Reference update_defaults validation (run_support.py:388-410)."""
    if cfg["input_type"] not in ("raw", "preads"):
        # reference run1.py:189-190 asserts exactly this at startup;
        # failing at parse time keeps a bad cfg from running stage 0
        raise Exception("Invalid input_type==%r" % (cfg["input_type"],))
    fso = cfg["falcon_sense_option"]
    if "local_match_count" in fso or "output_dformat" in fso:
        raise Exception(
            'Please remove obsolete "--local_match_count_*" or '
            '"--output_dformat" from "falcon_sense_option" in your cfg: %r'
            % fso)
    if int(cfg["length_cutoff"]) < 0 and int(float(cfg["genome_size"])) < 1:
        raise Exception(
            "Must specify either length_cutoff>0 or genome_size>0")
    if cfg["target"] not in ("overlapping", "pre-assembly", "assembly"):
        raise Exception("Unknown target %r in the configuration file."
                        % cfg["target"])


def _opt_val(opts, flag, default=None, conv=str):
    """Extract '-x500'-style or '--min-cov 2'-style values."""
    m = re.search(r"%s\s*(\.?[\d.]+)" % re.escape(flag), opts)
    if not m:
        return default
    return conv(m.group(1))


class StageParams:
    """Per-stage engine/consensus/filter parameters derived from the
    reference option strings."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.input_fofn = cfg["input_fofn"]
        self.input_type = cfg["input_type"]
        self.genome_size = int(float(cfg["genome_size"]))
        self.seed_coverage = int(float(cfg["seed_coverage"]))
        self.length_cutoff = int(cfg["length_cutoff"])
        self.length_cutoff_pr = int(cfg["length_cutoff_pr"])

        # DBsplit: -x min read len, -s block size (MB of bases)
        self.raw_min_len = _opt_val(cfg["pa_dbsplit_option"]
                                    if "pa_dbsplit_option" in cfg
                                    else cfg["pa_DBsplit_option"],
                                    "-x", 500, int)
        self.raw_block_mb = _opt_val(cfg.get("pa_dbsplit_option",
                                             cfg["pa_DBsplit_option"]),
                                     "-s", 200, float)
        self.pr_min_len = _opt_val(cfg.get("ovlp_dbsplit_option",
                                           cfg["ovlp_DBsplit_option"]),
                                   "-x", 500, int)
        self.pr_block_mb = _opt_val(cfg.get("ovlp_dbsplit_option",
                                            cfg["ovlp_DBsplit_option"]),
                                    "-s", 200, float)

        # daligner opts: -e identity, -l min overlap
        raw_opts = cfg.get("pa_hpcdaligner_option",
                           cfg["pa_HPCdaligner_option"])
        pr_opts = cfg.get("ovlp_hpcdaligner_option",
                          cfg["ovlp_HPCdaligner_option"])
        self.raw_ovl_idt = _opt_val(raw_opts, "-e", 0.70, float)
        self.raw_ovl_minlen = _opt_val(raw_opts, "-l", 1000, int)
        self.pr_ovl_idt = _opt_val(pr_opts, "-e", 0.96, float)
        self.pr_ovl_minlen = _opt_val(pr_opts, "-l", 500, int)

        self.falcon_sense_option = cfg["falcon_sense_option"]
        self.overlap_filtering_setting = cfg["overlap_filtering_setting"]
        ofs = self.overlap_filtering_setting.replace("_", "-")
        self.filt_max_diff = _opt_val(ofs, "--max-diff", 1000, int)
        self.filt_max_cov = _opt_val(ofs, "--max-cov", 1000, int)
        self.filt_min_cov = _opt_val(ofs, "--min-cov", 2, int)
        self.filt_min_len = _opt_val(ofs, "--min-len", 2500, int)
        self.filt_bestn = _opt_val(ofs, "--bestn",
                                   int(cfg.get("bestn", 12)), int)

        g_opts = cfg.get("fc_ovlp_to_graph_option", "") or ""
        # fc_run defaults --min_len to length_cutoff_pr when absent
        # (reference run_support.py:400-405), NOT to the ovlp_to_graph
        # CLI default of 4000
        if "--min_len" in g_opts or "--min-len" in g_opts:
            self.graph_min_len = _opt_val(
                g_opts.replace("--min-len", "--min_len"), "--min_len",
                4000, int)
        else:
            self.graph_min_len = self.length_cutoff_pr
        self.graph_min_idt = _opt_val(g_opts, "--min_idt", 96.0, float)
        self.graph_lfc = "--lfc" in g_opts

        self.target = cfg.get("target", "assembly")
        self.skip_contained = _coerce_bool(
            cfg.get("falcon_sense_skip_contained", "false"))

        # [job.*] concurrency hints (reference run_support.py:311-320):
        # NPROC/njobs of job.step.cns bound the consensus worker pool;
        # everything else is in-process / on-device here
        job = cfg.get("job", {}) if isinstance(cfg.get("job"), dict) else {}
        self.job = job

        def _job_int(step, key, default=0):
            sec = job.get("step.%s" % step, {})
            v = sec.get(key, job.get("defaults", {}).get(key))
            try:
                return int(v)
            except (TypeError, ValueError):
                return default

        self.cns_nproc = _job_int("cns", "nproc")
        self.cns_njobs = _job_int("cns", "njobs")

        self.overlap_k = int(cfg["overlap_k"])
        self.overlap_min_hits = int(cfg["overlap_min_hits"])
        self.overlap_band = int(cfg["overlap_band"])
        self.overlap_stride = int(cfg["overlap_stride"])
        self.overlap_stride_pr = int(cfg["overlap_stride_pr"])
        self.use_device = _coerce_bool(cfg["use_device"])
        masking = {t.strip() for t in cfg.get("masking", "").split(",")
                   if t.strip()}
        self.mask_dust = "dust" in masking
        self.mask_tandem = "tan" in masking or "tandem" in masking
