"""The benchmark of the PyTorch/CUDA port (``src/repro_torch``).

One command runs one cell once::

    python3 portbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Everything a cell is made of is data, found by name: the cells, metrics
and configurations are listed in ``BENCHMARK.json`` at the root of the
checkout; a configuration's sizes are ``portbench/configs/<config>.json``,
a traffic mix's parameters ``portbench/mixes/<traffic>.json``, a cell's
correctness limits ``portbench/cells/<workload>.json``,
and each metric is a reader of its own, ``portbench/metrics/<metric>.py``.
The plain float32 references that decide ``correct`` are in
``portbench/reference/`` and import nothing of the port.
"""
