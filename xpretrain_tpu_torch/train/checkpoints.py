"""Checkpoints: periodic saves with rotation, best-model tracking, resume
(``xpretrain_tpu/train/checkpoints.py``, ref ``CLIP-ViP/src/utils/load_save.py``).

A checkpoint is one ``torch.save`` file per step, ``<directory>/<step>.pt``,
holding whatever dict of tensors and numbers the trainer hands over (model
state, optimizer state, step). A save writes a temporary file and renames it
into place, so a crash never leaves half a checkpoint under a step's name;
an I/O error is retried with bounded backoff as in the reference; the newest
``max_to_keep`` steps are kept.

Async saves (orbax's in JAX, ``async_save=True``) snapshot the state and
write it from a background thread. The port updates parameters and moments
in place, so the snapshot is taken before the next step can write them:
CUDA tensors are copied into pinned host buffers on a side stream, and the
caller's stream waits on that copy's event before its next kernel (the host
does not wait); CPU tensors are cloned. The file written at step s is the
synchronous save's at step s. A save first waits for the previous write (a
failure there is a warning: the newer save supersedes it); :meth:`poll`
releases the host copy once its write has landed and :meth:`wait` drains,
each retrying a failed write synchronously.

In a data-parallel group every rank builds the state to save (the
optimizer's ``state_dict`` gathers its shards, a collective) and rank 0
alone writes it (``write=False`` elsewhere); every rank restores from the
files.
"""

from __future__ import annotations

import os
import re
import threading
import time
from typing import Any, Optional

import torch

from xpretrain_tpu_torch.utils.basic import save_json
from xpretrain_tpu_torch.utils.logging import LOGGER

_STEP_FILE = re.compile(r"^(\d+)\.pt$")


class CheckpointManager:
    """Step-numbered ``torch.save`` checkpoints in one directory."""

    def __init__(self, directory: str, max_to_keep: int = 2, retries: int = 10,
                 async_save: bool = False, write: bool = True):
        self.directory = os.path.abspath(directory)
        os.makedirs(self.directory, exist_ok=True)
        self.write = write  # False: this rank saves nothing (it is not rank 0)
        self.max_to_keep = max_to_keep
        self.retries = retries
        self.async_save = async_save
        # the in-flight async write: its thread, (step, host copy) and error
        self._thread: Optional[threading.Thread] = None
        self._last_async: Optional[tuple[int, dict]] = None
        self._error: Optional[Exception] = None

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
        drop all but the newest ``max_to_keep`` steps. Synchronous by
        default; with ``async_save`` it returns once the state is
        snapshotted (see the module's docstring). A no-op off rank 0."""
        if not self.write:
            return
        if not self.async_save:
            self._save_with_retry(step, state)
            return
        self._join()
        if self._error is not None:  # superseded by this newer save
            LOGGER.warning("previous async checkpoint failed: %s", self._error)
            self._error = None
        host = _snapshot(state)
        self._last_async = (step, host)
        self._thread = threading.Thread(target=self._write_async, args=(step, host), daemon=True)
        self._thread.start()

    def _write_async(self, step: int, host: dict) -> None:
        try:
            event = host.pop(_EVENT, None)
            if event is not None:
                event.synchronize()
            self._write_once(step, host)
        except Exception as e:  # noqa: BLE001 - reported by poll() / wait()
            self._error = e

    def _write_once(self, step: int, state: dict) -> None:
        """One attempt: a temporary file renamed into place, then rotation."""
        path = self._path(step)
        tmp = f"{path}.tmp.{os.getpid()}"
        try:
            torch.save(state, tmp)
            os.replace(tmp, path)
        finally:
            if os.path.exists(tmp):
                os.remove(tmp)
        for old in self.steps()[: -self.max_to_keep]:
            os.remove(self._path(old))

    def _save_with_retry(self, step: int, state: dict) -> None:
        for attempt in range(self.retries):
            try:
                self._write_once(step, state)
                return
            except OSError as e:  # storage flakiness: bounded retry like the reference
                LOGGER.warning("checkpoint save attempt %d failed: %s", attempt, e)
                time.sleep(min(2**attempt, 30))
        raise RuntimeError(f"checkpoint save failed after {self.retries} retries")

    def _join(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None

    def _retry_failed(self) -> None:
        step, host = self._last_async
        self._last_async = None
        if self._error is not None:
            LOGGER.warning("async checkpoint at step %d failed (%s); retrying synchronously", step, self._error)
            self._error = None
            self._save_with_retry(step, host)

    def poll(self) -> None:
        """Non-blocking, per chunk: once the in-flight write has landed,
        release its host copy (parameters and both moments); retry it
        synchronously now if it failed."""
        if self._last_async is None or (self._thread is not None and self._thread.is_alive()):
            return
        self._join()
        self._retry_failed()

    def wait(self) -> None:
        """Drain the in-flight write; retry it synchronously if it failed."""
        self._join()
        if self._last_async is not None:
            self._retry_failed()

    def restore(self, step: Optional[int] = None) -> Optional[dict]:
        """The saved dict of ``step`` (default: the latest) on the CPU, or
        None when there is no checkpoint."""
        step = step if step is not None else self.latest_step()
        if step is None:
            return None
        state = torch.load(self._path(step), map_location="cpu", weights_only=True)
        LOGGER.info("restored checkpoint at step %d from %s", step, self.directory)
        return state


_EVENT = "__copy_event__"  # where _snapshot leaves the copies' CUDA event


def _snapshot(state: dict) -> dict:
    """A host copy of ``state`` (nested dicts of tensors and numbers) that the
    next in-place update cannot change: CUDA tensors copied into pinned
    buffers on a side stream, which the current stream then waits on (its
    event is under ``_EVENT``, for the writer to wait on); CPU tensors cloned."""
    copies: list[tuple[torch.Tensor, torch.Tensor]] = []

    def visit(value):
        if isinstance(value, dict):
            return {k: visit(v) for k, v in value.items()}
        if isinstance(value, torch.Tensor):
            if value.is_cuda:
                host = torch.empty(value.shape, dtype=value.dtype, pin_memory=True)
                copies.append((host, value.detach()))
                return host
            return value.detach().clone()
        return value

    host = visit(state)
    if copies:
        device = copies[0][1].device
        main = torch.cuda.current_stream(device)
        side = torch.cuda.Stream(device)
        side.wait_stream(main)
        with torch.cuda.stream(side):
            for dst, src in copies:
                src.record_stream(side)
                dst.copy_(src, non_blocking=True)
            event = torch.cuda.Event()
            event.record(side)
        main.wait_event(event)
        host[_EVENT] = event
    return host


class BestModelSaver:
    """Keep the best-metric parameters (ref ``BestModelSaver`` ``:65-83``)."""

    def __init__(self, directory: str, write: bool = True):
        self.mgr = CheckpointManager(os.path.join(directory, "best"), max_to_keep=1, write=write)
        self.best_score = -float("inf")
        self.best_step = -1

    def maybe_save(self, step: int, score: float, params: Any) -> bool:
        """Save ``params`` (a state dict, or a module whose state dict is
        copied to the host) when ``score`` beats the best so far. Every rank
        calls it with the same score: a laid-out module's ``state_dict``
        gathers its parameters (``parallel/fsdp.py``), a collective."""
        if score <= self.best_score:
            return False
        self.best_score = score
        self.best_step = step
        if isinstance(params, torch.nn.Module) and (self.mgr.write or params.__dict__.get("param_layouts")):
            params = {k: v.detach().cpu() for k, v in params.state_dict().items()}
        if self.mgr.write:
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
