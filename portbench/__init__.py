"""The benchmark of ``colvo_torch`` on an NVIDIA H100.

``python -m portbench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything that belongs to one configuration (``configs/``), one
traffic mix (``traffic/``), one per-layer metric (``metrics/``) or one
cell's output limits (``limits/``) is a file of its own, found by the name
that ``BENCHMARK.json`` gives it. ``reference/`` is the plain float32
arithmetic that decides ``correct``; it imports nothing of the program.
"""
