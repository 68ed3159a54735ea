"""The published peaks of one NVIDIA H100 SXM and the least time a piece of
work could take on it.

Frozen copy of ``HBM_BYTES_PER_S``, ``PEAK_FLOPS`` and ``bound_ms`` from
``chip_smoke.py`` at commit 7fcd34c (here in seconds). The peaks assume the
card's full 700 W power limit; a run prints the limit it found beside every
share of them.
"""

from __future__ import annotations

HBM_BYTES_PER_S = 3.35e12  # HBM3, NVIDIA's data sheet
PEAK_FLOPS = 989e12  # dense bf16 on the tensor cores


def bound_s(flops: float, nbytes: float) -> float:
    """The least time the card could take for ``flops`` bf16 operations and
    ``nbytes`` moved: the larger of the two bounds."""
    return max(flops / PEAK_FLOPS, nbytes / HBM_BYTES_PER_S)
