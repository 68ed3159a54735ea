"""Profiling and step-time instrumentation (``xpretrain_tpu/utils/profiling.py``).

The reference's only instrumentation is a one-off thop FLOPs count
(``hd-vila/src/modeling/e2e_model.py:262-268``) and wall-clock prints; this
module provides:

- :func:`trace`: a ``torch.profiler`` trace (host and, on a card, device
  activity) written as a Chrome trace, ``<log_dir>/trace.json``;
- :class:`StepTimer`: steady-state step-time/throughput meter with warm-up
  exclusion and percentile summary (host clock; a caller timing a card
  synchronizes before each tick);
- :func:`flops_estimate`: the operations of one call, counted by
  ``torch.utils.flop_counter`` (GEMMs, convolutions, attention; forward and,
  when the call runs one, backward).

The training loop's op-class tables are ``train/profiling.py``'s.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Callable

import numpy as np
import torch


@contextlib.contextmanager
def trace(log_dir: str):
    """Profile the body; write its Chrome trace to ``log_dir/trace.json``."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
        if torch.cuda.is_available():
            torch.cuda.synchronize()
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))


class StepTimer:
    """Track per-step wall time; first ``skip`` steps (warm-up) excluded."""

    def __init__(self, skip: int = 2):
        self.skip = skip
        self.times: list[float] = []
        self._last: float | None = None
        self._count = 0

    def tick(self) -> None:
        now = time.perf_counter()
        if self._last is not None:
            self._count += 1
            if self._count > self.skip:
                self.times.append(now - self._last)
        self._last = now

    def summary(self, items_per_step: int = 1) -> dict[str, float]:
        if not self.times:
            return {}
        arr = np.asarray(self.times)
        return {
            "mean_s": float(arr.mean()),
            "p50_s": float(np.percentile(arr, 50)),
            "p90_s": float(np.percentile(arr, 90)),
            "steps_per_s": float(1.0 / arr.mean()),
            "items_per_s": float(items_per_step / arr.mean()),
        }


def flops_estimate(fn: Callable, *args, **kwargs) -> float:
    """Operations of one ``fn(*args, **kwargs)`` call, as
    ``torch.utils.flop_counter`` counts them (0 if the call fails, as JAX's
    returns 0 where XLA has no cost analysis)."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
        return float(counter.get_total_flops())
    except Exception:  # noqa: BLE001 - the estimate is optional, as in JAX
        return 0.0
