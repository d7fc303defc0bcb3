"""The benchmark of ``speech_tpu_torch``: ``python3 bench_port/run.py``."""
