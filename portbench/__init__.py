"""The benchmark of igmc_torch on one NVIDIA H100: run.py runs one cell."""
