"""The host-side training loop (``xpretrain_tpu/train/loop.py``).

Per-step dispatch, or ``steps_per_call`` stacked dispatch: K host batches
stacked on a leading axis (:func:`stack_batches`), moved to the device in
one upload, and run by the train step in one call (on a card, K replays of
one captured CUDA graph; ``parallel/train_step.py``). The log, validate and
save cadences keep their density: when a chunk crosses several
``log_every`` boundaries, each is logged from that sub-step's row of the
stacked metrics, and validate and save fire after the chunk that holds their
boundary. A run whose length is not a multiple of K ends on a shorter chunk.
``profile_num_steps > 0`` takes a ``torch.profiler`` trace (host and, on a
card, device activity) where JAX takes ``jax.profiler``, with its device
time by op class (``train/profiling.py``); its host rows show the spans of
``utils/profiling.py`` (here ``xpt.loop.next_batch``, the wait for the
loader, and ``xpt.ingest.stack``).

Step ``s`` draws from ``seed + s`` whatever K is, so a run at K = 4 equals a
run at K = 1 and a resumed run equals an unbroken one; JAX splits a PRNG key
per chunk instead (a deliberate difference, ROADMAP Queue 3).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

import numpy as np

from xpretrain_tpu_torch.train.profiling import start_profiler, stop_profiler
from xpretrain_tpu_torch.utils.profiling import span


def _batch_schema(batch: dict) -> tuple:
    return tuple(
        (k, getattr(batch[k], "shape", None), str(getattr(batch[k], "dtype", type(batch[k]))))
        for k in sorted(batch)
    )


def stack_batches(batches: list) -> dict:
    """Stack host batches on a leading axis, with a clear schema error; the
    stacking is the span ``xpt.ingest.stack``."""
    if not all(isinstance(b, dict) for b in batches):
        raise ValueError(
            "steps_per_call > 1 requires dict batches (got "
            f"{[type(b).__name__ for b in batches]})"
        )
    schemas = {_batch_schema(b) for b in batches}
    if len(schemas) > 1:
        raise ValueError(
            "steps_per_call > 1 needs structurally identical batches (same keys, "
            "shapes, dtypes) across consecutive steps; a multi-task MetaLoader "
            "mixes batch schemas — use steps_per_call=1 for multi-task training. "
            f"Got schemas: {sorted(schemas)}"
        )
    scalar_keys = [
        k for k, shape, _ in next(iter(schemas)) if shape is not None and len(shape) == 0
    ] + [k for k, shape, _ in next(iter(schemas)) if shape is None]
    if scalar_keys:
        # a 0-d leaf would stack to rank 1 and then be indexed per step as a
        # scalar; fail here, at the cause
        raise ValueError(
            "steps_per_call > 1 requires every batch leaf to be an array of "
            f"rank >= 1; got scalar/non-array leaves for keys {scalar_keys}. "
            "Reshape scalars to shape (1,) or use steps_per_call=1."
        )
    with span("xpt.ingest.stack"):
        return {k: np.stack([b[k] for b in batches]) for k in batches[0]}


def drive_train_loop(
    *,
    train_step: Callable,
    loader,
    state,
    place_batch: Callable[[dict], dict],
    seed: int,
    num_train_steps: int,
    steps_per_call: int = 1,
    log_every: int = 20,
    valid_every: int = 500,
    save_every: int = 500,
    on_log: Optional[Callable[[int, dict, float], None]] = None,
    on_validate: Optional[Callable[[int, Any], None]] = None,
    on_save: Optional[Callable[[int, Any], None]] = None,
    on_step: Optional[Callable[[int], None]] = None,
    profile_dir: Optional[str] = None,
    profile_start_step: int = 3,
    profile_num_steps: int = 0,
):
    """Drive ``train_step`` from ``state.step`` to ``num_train_steps``.

    With ``steps_per_call`` 1, ``train_step(state, batch, seed + step)``
    takes one batch; above 1, ``train_step(state, stacked, seed + step)``
    takes a chunk of up to ``steps_per_call`` batches stacked on a leading
    axis and returns metrics with that axis. ``place_batch`` moves a host
    batch (or a stacked chunk) to the device. ``on_log(step, metrics,
    steps_per_sec)`` fires at every ``log_every`` boundary with that step's
    metrics, ``on_validate(step, state)`` and ``on_save(step, state)`` after
    the chunk that holds their boundary, and ``on_step(step)`` after every
    chunk (cheap housekeeping, such as releasing an async checkpoint's host
    copy once it has landed)."""
    step = int(state.step)
    it = iter(loader)
    k = max(1, int(steps_per_call))

    def next_batch():
        with span("xpt.loop.next_batch"):  # the wait for the loader
            batch = next(it)
        if isinstance(batch, tuple):  # MetaLoader yields (task, batch)
            _task, batch = batch
        return batch

    def crossed(before: int, after: int, every: int) -> bool:
        return after // every > before // every

    last_log_step = step
    t0 = time.time()
    prof, prof_start = None, step
    prof_end = profile_start_step + profile_num_steps
    while step < num_train_steps:
        if profile_dir and profile_num_steps > 0 and prof is None and profile_start_step <= step < prof_end:
            prof, prof_start = start_profiler(), step
        chunk = min(k, num_train_steps - step)
        if k == 1:
            state, metrics = train_step(state, place_batch(next_batch()), seed + step)
            at = lambda i: metrics  # noqa: E731
        else:
            stacked = stack_batches([next_batch() for _ in range(chunk)])
            state, metrics = train_step(state, place_batch(stacked), seed + step)
            at = lambda i: {key: value[i] for key, value in metrics.items()}  # noqa: E731
        prev, step = step, step + chunk
        if prof is not None and step >= prof_end:
            stop_profiler(prof, profile_dir, step - prof_start)
            prof = None
        if on_log is not None and crossed(prev, step, log_every):
            # log every boundary the chunk crossed, from that sub-step's row
            elapsed = max(time.time() - t0, 1e-9)
            sps = (step - last_log_step) / elapsed
            for s in range(prev + 1, step + 1):
                if s % log_every == 0:
                    on_log(s, at(s - prev - 1), sps)
            last_log_step = step
            t0 = time.time()
        if on_validate is not None and crossed(prev, step, valid_every):
            on_validate(step, state)
        if on_save is not None and crossed(prev, step, save_every):
            on_save(step, state)
        if on_step is not None:
            on_step(step)
    if prof is not None:  # num_train_steps ended inside the profiled window
        stop_profiler(prof, profile_dir, step - prof_start)
    return state
