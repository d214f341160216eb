"""The benchmark of ``repro_torch`` on one NVIDIA H100: cold invocations of
deployed functions through the port's ``Gateway`` under fixed traffic.

``python3 portbench/run.py --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
object as its last line. Everything that belongs to one configuration, one
traffic mix or one metric is a file of its own that the harness finds by the
name ``BENCHMARK.json`` gives it: ``configs/<config>.json``,
``workloads/<cell>.json`` (read by ``traffic/<kind>.py``) and
``metrics/<metric>.py``.
"""
