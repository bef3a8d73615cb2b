"""The benchmark of the PyTorch/CUDA port (``convex_mpc_tpu_torch``) on one NVIDIA H100.

``run.py`` runs one cell of ``BENCHMARK.json``; ``configs/``, ``traffic/``,
``limits/`` and ``metrics/`` hold what belongs to one configuration, traffic
mix, cell or per-layer metric, found by its name; ``reference/`` is the plain
PyTorch copy of the controller that decides ``correct``.
"""
