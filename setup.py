from setuptools import setup, find_packages

setup(
    name="falcon_tpu",
    version="0.1.0",
    description="TPU-native hierarchical genome assembler "
                "(JAX/XLA/Pallas re-design of the FALCON/HGAP engine)",
    packages=find_packages(include=["falcon_tpu", "falcon_tpu.*",
                                    "falcon_tpu_torch", "falcon_tpu_torch.*"]),
    package_data={"falcon_tpu_torch": ["csrc/*.cu", "csrc/*.cuh",
                                       "native/*.cpp"]},
    python_requires=">=3.10",
    install_requires=["numpy", "jax"],
    entry_points={
        "console_scripts": [
            "ftpu-run = falcon_tpu.pipeline.driver:main",
            "ftpu-torch-run = falcon_tpu_torch.pipeline.driver:main",
            "fc_run = falcon_tpu.pipeline.driver:main",
            "ftpu-supervise = falcon_tpu.pipeline.supervise:main",
            "fc_consensus = falcon_tpu.mains.consensus:main",
            "fc_ovlp_filter = falcon_tpu.mains.ovlp_filter:main",
            "fc_ovlp_stats = falcon_tpu.mains.ovlp_stats:main",
            "fc_ovlp_to_graph = falcon_tpu.mains.ovlp_to_graph:main",
            "fc_graph_to_contig = falcon_tpu.mains.graph_to_contig:main",
            "fc_graph_to_utgs = falcon_tpu.mains.graph_to_utgs:main",
            "fc_dedup_a_tigs = falcon_tpu.mains.dedup_a_tigs:main",
            "fc_calc_cutoff = falcon_tpu.mains.calc_cutoff:main",
            "fc_gen_gfa_v1 = falcon_tpu.mains.gen_gfa_v1:main",
            "fc_gen_gfa_v2 = falcon_tpu.mains.gen_gfa_v2:main",
            "fc_collect_pread_gfa = "
            "falcon_tpu.mains.collect_pread_gfa:main",
            "fc_collect_contig_gfa = "
            "falcon_tpu.mains.collect_contig_gfa:main",
            "fc_track_reads = falcon_tpu.mains.track_reads:main",
            "fc_fetch_reads = falcon_tpu.mains.fetch_reads:main",
            "fc_actg_coordinate = falcon_tpu.mains.actg_coordinate:main",
            "fc_contig_annotate = falcon_tpu.mains.contig_annotate:main",
            "fc_ctg_link_analysis = "
            "falcon_tpu.mains.ctg_link_analysis:main",
            "fc_report_pre_assembly = "
            "falcon_tpu.mains.report_pre_assembly:main",
            "falcon-task = falcon_tpu.mains.tasks:main",
            "fc_hgap_adapt = falcon_tpu.mains.hgap_adapt:main",
            "fc_snakemake = falcon_tpu.mains.gen_snakemake:main",
            # the port's tools, one for each of falcon_tpu's above
            "ftpu-torch-supervise = falcon_tpu_torch.pipeline.supervise:main",
            "ftpu-torch-consensus = falcon_tpu_torch.mains.consensus:main",
            "ftpu-torch-ovlp-filter = falcon_tpu_torch.mains.ovlp_filter:main",
            "ftpu-torch-ovlp-stats = falcon_tpu_torch.mains.ovlp_stats:main",
            "ftpu-torch-ovlp-to-graph = "
            "falcon_tpu_torch.mains.ovlp_to_graph:main",
            "ftpu-torch-graph-to-contig = "
            "falcon_tpu_torch.mains.graph_to_contig:main",
            "ftpu-torch-graph-to-utgs = "
            "falcon_tpu_torch.mains.graph_to_utgs:main",
            "ftpu-torch-dedup-a-tigs = "
            "falcon_tpu_torch.mains.dedup_a_tigs:main",
            "ftpu-torch-calc-cutoff = falcon_tpu_torch.mains.calc_cutoff:main",
            "ftpu-torch-gen-gfa-v1 = falcon_tpu_torch.mains.gen_gfa_v1:main",
            "ftpu-torch-gen-gfa-v2 = falcon_tpu_torch.mains.gen_gfa_v2:main",
            "ftpu-torch-collect-pread-gfa = "
            "falcon_tpu_torch.mains.collect_pread_gfa:main",
            "ftpu-torch-collect-contig-gfa = "
            "falcon_tpu_torch.mains.collect_contig_gfa:main",
            "ftpu-torch-track-reads = falcon_tpu_torch.mains.track_reads:main",
            "ftpu-torch-fetch-reads = falcon_tpu_torch.mains.fetch_reads:main",
            "ftpu-torch-actg-coordinate = "
            "falcon_tpu_torch.mains.actg_coordinate:main",
            "ftpu-torch-contig-annotate = "
            "falcon_tpu_torch.mains.contig_annotate:main",
            "ftpu-torch-ctg-link-analysis = "
            "falcon_tpu_torch.mains.ctg_link_analysis:main",
            "ftpu-torch-report-pre-assembly = "
            "falcon_tpu_torch.mains.report_pre_assembly:main",
            "ftpu-torch-task = falcon_tpu_torch.mains.tasks:main",
            "ftpu-torch-hgap-adapt = falcon_tpu_torch.mains.hgap_adapt:main",
            "ftpu-torch-snakemake = falcon_tpu_torch.mains.gen_snakemake:main",
            # the port's assembly check and quick verify (tools/*.py's);
            # its profiles run as python -m falcon_tpu_torch.tools.<name>
            "ftpu-torch-check-assembly = "
            "falcon_tpu_torch.tools.check_assembly:main",
            "ftpu-torch-verify-quick = falcon_tpu_torch.tools.verify_quick:main",
        ],
    },
)
