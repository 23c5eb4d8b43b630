"""Snakemake export: write a Snakefile that drives the falcon_tpu_torch
pipeline as three artifact-gated rules.

Reference: falcon_kit/snakemake.py:25-231 (SnakemakeRuleWriter) emits a
Snakefile mirroring the whole pypeflow task DAG (static + dynamic
split/merge rules) so users can run FALCON under Snakemake instead of
pypeFLOW.  falcon_tpu_torch has no file-task DAG -- the driver runs three
in-process phases and resumes by artifact presence + integrity sidecars
(pipeline.driver) -- so the faithful export is three rules whose
outputs are the phase checkpoint artifacts and whose bodies invoke the
(idempotent) driver: Snakemake supplies the orchestration/retry/cluster
submission the reference got from pypeflow, and each rule run skips
straight to its own phase because earlier artifacts exist.

Everything is rendered literally (no Snakefile-global substitution:
snakemake only formats input/output/params/wildcards in shell strings).
"""
import os

HEADER = """\
# Generated by falcon_tpu_torch (fc_snakemake) -- reference analog:
# falcon_kit/snakemake.py writes an equivalent Snakefile for the
# pypeflow DAG.  Rules are artifact-gated: the driver resumes past any
# phase whose products (with valid integrity sidecars) already exist,
# so re-running a rule never redoes finished work.

rule all:
    input:
        {p_ctg!r}
"""

PHASE0 = """
# stage 0: raw reads -> error-corrected preads
rule phase0_preads:
    input:
        {cfg!r}
    output:
        {preads!r}
    shell:
        {cmd!r}
"""

PHASE1 = """
# stage 1: pread all-vs-all overlap + filtered overlap table
rule phase1_overlaps:
    input:
        {dep!r}
    output:
        {povl!r},
        {p4f!r}
    shell:
        {cmd!r}
"""

PHASE2 = """
# stage 2: string graph -> contigs + GFA
rule phase2_assembly:
    input:
        {povl!r},
        {p4f!r}
    output:
        {p_ctg!r}
    shell:
        {cmd!r}
"""


def write_snakefile(cfg_path, out_path, run_dir="."):
    """Render the Snakefile; validates the cfg parses first (a broken
    cfg should fail at export, not inside a cluster job)."""
    from .. import config as config_mod
    cfg = config_mod.parse_cfg_file(cfg_path)
    cfg_abs = os.path.abspath(cfg_path)
    j = lambda *p: os.path.join(run_dir, *p)
    preads = j("0-rawreads", "preads.fasta")
    povl = j("1-preads_ovl", "preads.ovl")
    p4f = j("2-asm-falcon", "preads4falcon.fasta")
    p_ctg = j("2-asm-falcon", "p_ctg.fa")
    cmd = "python -m falcon_tpu_torch.pipeline.driver %s %s" % (cfg_abs,
                                                          run_dir)
    text = HEADER.format(p_ctg=p_ctg)
    if cfg["input_type"] == "preads":
        # stage 0 never runs; phase1 depends on the cfg directly
        text += PHASE1.format(dep=cfg_abs, povl=povl, p4f=p4f, cmd=cmd)
    else:
        text += PHASE0.format(cfg=cfg_abs, preads=preads, cmd=cmd)
        text += PHASE1.format(dep=preads, povl=povl, p4f=p4f, cmd=cmd)
    text += PHASE2.format(povl=povl, p4f=p4f, p_ctg=p_ctg, cmd=cmd)
    with open(out_path, "w") as f:
        f.write(text)
    return out_path
