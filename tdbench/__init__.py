"""TokenDance benchmark of the PyTorch port (``repro_torch``) on one H100.

Run one cell once: ``python3 tdbench/run.py --workload <cell> --seed <n>
--seconds <s> --trace <0|1>``. Cells, metrics and bounds are in the
repository's ``BENCHMARK.json``; everything a cell names is found by name
under this folder (``configs/``, ``traffic/``, ``limits/``, ``metrics/``).
"""
