"""The host-side training loop (``xpretrain_tpu/train/loop.py``).

One step per call: the JAX loop's chunked dispatch (``steps_per_call``)
has no port (``make_train_step`` rejects it). Log, validate and save fire
at the same boundaries as in JAX. ``profile_num_steps > 0`` takes a
``torch.profiler`` trace (host and, on a card, device activity) where JAX
takes ``jax.profiler``, with its device time by op class
(``train/profiling.py``).
"""

from __future__ import annotations

import time
from typing import Any, Callable, Optional

from xpretrain_tpu_torch.train.profiling import start_profiler, stop_profiler


def drive_train_loop(
    *,
    train_step: Callable,
    loader,
    state,
    place_batch: Callable[[dict], dict],
    seed: int,
    num_train_steps: int,
    log_every: int = 20,
    valid_every: int = 500,
    save_every: int = 500,
    on_log: Optional[Callable[[int, dict, float], None]] = None,
    on_validate: Optional[Callable[[int, Any], None]] = None,
    on_save: Optional[Callable[[int, Any], None]] = None,
    profile_dir: Optional[str] = None,
    profile_start_step: int = 3,
    profile_num_steps: int = 0,
):
    """Drive ``train_step(state, batch, seed + step)`` from ``state.step`` to
    ``num_train_steps``.

    ``place_batch`` moves a host batch to the device. ``on_log(step, metrics,
    steps_per_sec)`` fires at every ``log_every`` boundary, ``on_validate(step,
    state)`` and ``on_save(step, state)`` at theirs, after the step. The
    dropout seed of a step depends on its index alone, so a resumed run draws
    what an unbroken one would."""
    step = int(state.step)
    it = iter(loader)
    last_log_step = step
    t0 = time.time()
    prof, prof_start = None, step
    prof_end = profile_start_step + profile_num_steps
    while step < num_train_steps:
        if profile_dir and profile_num_steps > 0 and prof is None and profile_start_step <= step < prof_end:
            prof, prof_start = start_profiler(), step
        batch = next(it)
        if isinstance(batch, tuple):  # MetaLoader yields (task, batch)
            _task, batch = batch
        state, metrics = train_step(state, place_batch(batch), seed + step)
        step += 1
        if prof is not None and step >= prof_end:
            stop_profiler(prof, profile_dir, step - prof_start)
            prof = None
        if on_log is not None and step % log_every == 0:
            elapsed = max(time.time() - t0, 1e-9)
            on_log(step, metrics, (step - last_log_step) / elapsed)
            last_log_step = step
            t0 = time.time()
        if on_validate is not None and step % valid_every == 0:
            on_validate(step, state)
        if on_save is not None and step % save_every == 0:
            on_save(step, state)
    if prof is not None:  # num_train_steps ended inside the profiled window
        stop_profiler(prof, profile_dir, step - prof_start)
    return state
