"""The benchmark of falcon_tpu_torch on one H100 (see run.py)."""
