"""The benchmark of ``hyperpocket_tpu_torch`` on an NVIDIA H100.

``python benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
runs one cell and prints one JSON line (README.md). Everything a cell needs
is found by name: ``workloads/<cell>.json`` names its configuration
(``configs/<config>.json``) and its traffic driver
(``traffic/<driver>.py``); each per-layer metric is read by
``metrics/<metric>.py``. The yardstick (counts, peaks, the plain reference
and the comparison that decides ``correct``) lives here and imports nothing
of the program.
"""
