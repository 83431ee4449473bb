"""Benchmark of the PyTorch and CUDA codec (``lz77_tpu_torch``) on one card.

``python3 codec_bench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>``; see ``README.md``.  Nothing in this package imports the
program at import time, and nothing here imports ``jax`` or ``lz77_tpu``.
"""
