"""The benchmark of ``repro_torch``, the PyTorch and CUDA port.

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` once on the card and
prints one JSON result line.  Everything a cell needs is found by name:
its configuration in ``configs/<name>.json``, its traffic mix in
``traffic/<name>.json``, the configuration's runner in
``runners/<runner>.py`` and plain reference in ``reference/<name>.py``,
and each per-layer metric's reader in ``metrics/<metric>.py``.  Nothing
here imports JAX or the JAX package.
"""
