"""Per-layer metric readers, one file per metric named as in
``BENCHMARK.json``. Each gives ``LAYER``, the metric it ``MOVES`` and
``read(readings)``, which returns None where the run holds nothing to read
(a traced stretch without the op, a run without a trace)."""
