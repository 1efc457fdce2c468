"""The benchmark of alacnet_tpu_torch (see run.py and PERF.md)."""
