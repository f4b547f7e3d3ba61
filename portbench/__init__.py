"""The benchmark of the PyTorch and CUDA port (``repro_torch``) on one
H100: ``run.py`` runs one cell once (see ``BENCHMARK.json``)."""
