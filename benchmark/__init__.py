"""The benchmark of ``xpretrain_tpu_torch`` on NVIDIA H100 cards.

``python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>``
from the repository root runs one cell of ``BENCHMARK.json``; see ``run.py``.
"""
