"""Checkpoints: periodic saves with rotation, best-model tracking, resume
(``xpretrain_tpu/train/checkpoints.py``, ref ``CLIP-ViP/src/utils/load_save.py``).

A checkpoint is one ``torch.save`` file per step, ``<directory>/<step>.pt``,
holding whatever dict of tensors and numbers the trainer hands over (model
state, optimizer state, step). A save writes a temporary file and renames it
into place, so a crash never leaves half a checkpoint under a step's name;
an I/O error is retried with bounded backoff as in the reference; the newest
``max_to_keep`` steps are kept. Async saves (orbax's in JAX) are not ported.
"""

from __future__ import annotations

import os
import re
import time
from typing import Any, Optional

import torch

from xpretrain_tpu_torch.utils.basic import save_json
from xpretrain_tpu_torch.utils.logging import LOGGER

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    """Step-numbered ``torch.save`` checkpoints in one directory."""

    def __init__(self, directory: str, max_to_keep: int = 2, retries: int = 10,
                 async_save: bool = False):
        if async_save:
            raise NotImplementedError("async checkpoints are not ported yet (ROADMAP Queue 1)")
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.max_to_keep = max_to_keep
        self.retries = retries

    def steps(self) -> list[int]:
        found = (_STEP_FILE.match(name) for name in os.listdir(self.directory))
        return sorted(int(m.group(1)) for m in found if m)

    def latest_step(self) -> Optional[int]:
        steps = self.steps()
        return steps[-1] if steps else None

    def _path(self, step: int) -> str:
        return os.path.join(self.directory, f"{step}.pt")

    def save(self, step: int, state: dict) -> None:
        """Write ``state`` as step ``step`` (replacing one of that step), then
        drop all but the newest ``max_to_keep`` steps."""
        path = self._path(step)
        tmp = f"{path}.tmp.{os.getpid()}"
        for attempt in range(self.retries):
            try:
                torch.save(state, tmp)
                os.replace(tmp, path)
                break
            except OSError as e:  # storage flakiness: bounded retry like the reference
                LOGGER.warning("checkpoint save attempt %d failed: %s", attempt, e)
                if os.path.exists(tmp):
                    os.remove(tmp)
                time.sleep(min(2**attempt, 30))
        else:
            raise RuntimeError(f"checkpoint save failed after {self.retries} retries")
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        """The saved dict of ``step`` (default: the latest) on the CPU, or
        None when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        state = torch.load(self._path(step), map_location="cpu", weights_only=True)
        LOGGER.info("restored checkpoint at step %d from %s", step, self.directory)
        return state


class BestModelSaver:
    """Keep the best-metric parameters (ref ``BestModelSaver`` ``:65-83``)."""

    def __init__(self, directory: str):
        self.mgr = CheckpointManager(os.path.join(directory, "best"), max_to_keep=1)
        self.best_score = -float("inf")
        self.best_step = -1

    def maybe_save(self, step: int, score: float, params: Any) -> bool:
        if score <= self.best_score:
            return False
        self.best_score = score
        self.best_step = step
        self.mgr.save(step, {"params": params, "score": float(score)})
        LOGGER.info("new best score %.4f at step %d", score, step)
        return True


def save_training_meta(output_dir: str, config: Any) -> None:
    """The run's config as ``log/args.json`` beside the checkpoints (the
    JAX version's optional code.zip has no caller)."""
    log_dir = os.path.join(output_dir, "log")
    os.makedirs(log_dir, exist_ok=True)
    cfg = config.to_dict() if hasattr(config, "to_dict") else dict(config)
    save_json(cfg, os.path.join(log_dir, "args.json"), pretty=True)
