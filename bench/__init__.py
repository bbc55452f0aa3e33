"""The port's benchmark: one cell of ``BENCHMARK.json`` run once.

``python3 bench/run.py --workload <name> --seed <n> --seconds <s> --trace
<0|1>`` trains ``repro_torch`` on the cell's configuration
(``bench/configs/<config>.json``) under its traffic mix
(``bench/traffic/<mix>.json``), times whole steps for ``--seconds``, checks
the first steps against the plain reference (``bench/reference/``) under
the cell's limits (``bench/limits/<cell>.json``) and prints one JSON line.
Per-layer metrics are read by ``bench/metrics/<metric>.py``. Every piece
is found by its name, so a configuration, a mix, a metric or a cell is
added as files and entries, never by an edit.

Nothing here imports ``jax`` or the JAX package ``repro``: the harness
checks ``sys.modules`` by top-level name before it prints a result.
"""
