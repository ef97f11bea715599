"""The benchmark of swimm_tpu_torch (the PyTorch/CUDA port): a data-driven
harness that runs one cell of BENCHMARK.json per call. See README.md.

Importing this package loads nothing heavy; torch is imported by the run.
"""
