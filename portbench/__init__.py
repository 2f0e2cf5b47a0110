"""The benchmark of ``pkr_tpu_torch`` on one NVIDIA H100.

One command runs one cell of ``BENCHMARK.json`` once:

    python3 portbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Everything a cell needs is found by name: its configuration in
``configs/<config>.json``, its traffic mix in ``traffic/<mix>.json`` (which
names its driver, ``drivers/<driver>.py``), the reader of each per-layer
metric in ``layer_metrics/<metric>.py`` and the limits of its correctness
check in ``limits/<cell>.json``.  The plain reference that decides
``correct`` is under ``reference/``; the operation and byte counts and the
table of peaks under ``arith/``.  Nothing here imports JAX or ``pkr_tpu``.
"""
