"""The benchmark of ``radler_tpu_torch`` on NVIDIA GPUs.

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``README.md`` says how.
Nothing here imports JAX or the ``radler_tpu`` package, and nothing under
``reference/`` imports ``radler_tpu_torch``.
"""
