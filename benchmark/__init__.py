"""The benchmark of pathtracerpython_tpu_torch on NVIDIA H100 cards.

``python -m benchmark.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Cells, configurations, traffic mixes, drivers and per-layer metrics
are files found by name (``harness``); ``reference`` is the plain PyTorch
path tracer that decides whether the outputs are correct.
"""
