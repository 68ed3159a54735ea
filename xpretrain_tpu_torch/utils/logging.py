"""Process-0 logging, EMA meters, and a dependency-free scalar writer (the
port's copy of ``xpretrain_tpu/utils/logging.py``).

Capability parity with the reference's ``logger.py``
(``CLIP-ViP/src/utils/logger.py:15-91``): a global logger silenced off
process 0, an EMA ``RunningMeter``, and step-keyed scalar logging. Instead of
TensorBoard we write a JSONL scalar stream (`ScalarWriter`) that any plotting
tool can consume; TB is not a baked-in dependency of this image.
"""

from __future__ import annotations

import json
import logging
import os
import sys
import time
from typing import Mapping

_LOG_FMT = "%(asctime)s [%(levelname)s] %(name)s: %(message)s"
_DATE_FMT = "%m/%d %H:%M:%S"

LOGGER = logging.getLogger("xpretrain_tpu_torch")


def setup_logging(
    log_dir: str | None = None,
    process_index: int = 0,
    level: int = logging.INFO,
) -> logging.Logger:
    """Configure the global logger; non-zero processes are silenced."""
    LOGGER.handlers.clear()
    LOGGER.setLevel(level)
    if process_index != 0:
        LOGGER.disabled = True
        return LOGGER
    LOGGER.disabled = False
    handler = logging.StreamHandler(sys.stdout)
    handler.setFormatter(logging.Formatter(_LOG_FMT, datefmt=_DATE_FMT))
    LOGGER.addHandler(handler)
    if log_dir is not None:
        os.makedirs(log_dir, exist_ok=True)
        fh = logging.FileHandler(os.path.join(log_dir, "log.txt"))
        fh.setFormatter(logging.Formatter(_LOG_FMT, datefmt=_DATE_FMT))
        LOGGER.addHandler(fh)
    return LOGGER


class RunningMeter:
    """Exponential-moving-average meter for a scalar loss stream."""

    def __init__(self, name: str, val: float | None = None, smooth: float = 0.99):
        self._name = name
        self._smooth = smooth
        self._val = val

    def __call__(self, value: float) -> None:
        value = float(value)
        if value != value:  # NaN guard: keep the previous value
            return
        if self._val is None:
            self._val = value
        else:
            self._val = self._val * self._smooth + value * (1.0 - self._smooth)

    def __repr__(self) -> str:
        return f"{self._name}: {self._val:.4f}" if self._val is not None else f"{self._name}: n/a"

    @property
    def val(self) -> float | None:
        return self._val

    @property
    def name(self) -> str:
        return self._name


class ScalarWriter:
    """Step-keyed scalar logger writing JSONL; no-op off process 0."""

    def __init__(self, log_dir: str | None, process_index: int = 0, flush_every: int = 50):
        self._enabled = log_dir is not None and process_index == 0
        self._global_step = 0
        self._buffer: list[dict] = []
        self._flush_every = flush_every
        if self._enabled:
            os.makedirs(log_dir, exist_ok=True)
            self._path = os.path.join(log_dir, "scalars.jsonl")
        else:
            self._path = None

    def set_step(self, step: int) -> None:
        self._global_step = int(step)

    def log_scalar(self, tag: str, value: float, step: int | None = None) -> None:
        if not self._enabled:
            return
        self._buffer.append(
            {
                "tag": tag,
                "value": float(value),
                "step": int(step if step is not None else self._global_step),
                "time": time.time(),
            }
        )
        if len(self._buffer) >= self._flush_every:
            self.flush()

    def log_scalar_dict(self, scalars: Mapping[str, float], prefix: str = "", step: int | None = None) -> None:
        for tag, value in scalars.items():
            name = f"{prefix}/{tag}" if prefix else tag
            self.log_scalar(name, value, step)

    def flush(self) -> None:
        if not self._enabled or not self._buffer:
            return
        with open(self._path, "a") as f:
            for row in self._buffer:
                f.write(json.dumps(row) + "\n")
        self._buffer.clear()

    def close(self) -> None:
        self.flush()


class NoOp:
    """Object that swallows every method call; handed to non-zero processes."""

    def __getattr__(self, _name):
        def _noop(*args, **kwargs):
            return None

        return _noop
