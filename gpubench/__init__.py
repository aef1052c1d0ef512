"""The benchmark of ``ray_tpu_torch`` on NVIDIA H100 cards.

``python3 -m gpubench.run --workload <cell> --seed <n> --seconds <s>
--trace <0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON
line. Everything that belongs to one configuration, traffic mix, driver or
per-layer metric is a file of its own, found by name:

- ``configs/<config>.json``: the published configuration as it is run;
- ``traffic/<traffic>.json``: the parameters of one traffic mix, which
  ``traffic.py`` turns into requests;
- ``workloads/<cell>.json``: the configuration, the traffic, the driver,
  the engine or trainer settings and the limits of the comparison;
- ``drivers/<kind>.py``: how a cell drives the program (``run(ctx)``);
- ``metrics/<metric>.py``: one per-layer metric (``read(records)``).

The yardstick is frozen here and imports nothing of the program:
the traffic generator, the FLOP and byte arithmetic (``flops.py``), the
peaks (``peaks.json``), the window statistics (``stats.py``), the trace
reduction (``trace.py``) and the plain float32 reference
(``reference/``) with the comparison that decides ``correct``
(``check.py``).
"""
