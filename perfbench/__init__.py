"""The benchmark of the PyTorch and CUDA port (`repro_torch`).

``python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of the root ``BENCHMARK.json`` once and
prints one JSON line. Everything that belongs to one configuration, cell
or per-layer metric sits in a file of its own, found by its name:
``configs/<config>.json``, ``workloads/<cell>.json``,
``reference/<config>.py``, ``metrics/<metric>.py`` and
``drivers/<driver>.py`` (the general generator a cell's file names).
"""
