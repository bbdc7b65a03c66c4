"""The benchmark of ``pygraphblas_tpu_torch`` on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json`` once; ``harness.py`` is
the run; the configurations, traffic mixes, trial kinds, graph families
and metric readers are files of their own that the harness finds by the
names the manifest gives (see README.md).  Nothing here imports JAX or
the JAX package.
"""
