"""The benchmark of ``framefusion_tpu_torch`` on one NVIDIA H100.

One command runs one cell of ``BENCHMARK.json`` once::

    python3 -m ffbench.run --workload llava7b.qa --seed 7 --seconds 45 --trace 0

Everything a cell needs is found by name: its configuration in
``configs/<name>.json`` (whose ``kind`` names ``families/<kind>.py``, the
program's builder, and ``reference/<kind>.py``, the plain tower), its
traffic mix in ``traffic/<mix>.json`` (read by the one generator,
``generator.py``), its fixed rate and correctness limits in
``cells/<workload>.json``, and each metric in ``metrics/<name>.py`` (or,
one reader for a quantity split by cells, ``metrics/<stem>.py``, the name
before its first dot).
"""
