"""The benchmark of the PyTorch and CUDA port (``src/repro_torch``).

``python portbench/run.py --workload <config>.<traffic> --seed N
--seconds S --trace 0|1`` runs one cell of ``BENCHMARK.json`` and prints
one JSON line; see ``portbench/README.md``.
"""
