"""The timed path broken on purpose: a program module whose builders return
the real trainer or towers with one fault planted underneath, for the
control readings (``controls.py``) and the tests that see ``correct`` come
out false."""

from __future__ import annotations

import types

import numpy as np


def unchanged_state(program):
    """Every step returns its state unchanged: the optimizer applies nothing."""

    def build_trainer(*args, **kwargs):
        trainer, state = program.build_trainer(*args, **kwargs)
        trainer.optimizer.apply = lambda grads, grad_norm=None: None
        return trainer, state

    return types.SimpleNamespace(**{**vars(program), "build_trainer": build_trainer})


def half_batch(program):
    """The step sees the first half of each batch only, so its loss is the
    mean over the rest."""

    def build_trainer(*args, **kwargs):
        trainer, state = program.build_trainer(*args, **kwargs)
        place = trainer.place_batch
        rows = 1 if trainer.steps_per_call > 1 else 0  # a chunk stacks its steps on a leading axis
        trainer.place_batch = lambda batch: place(
            {k: v.take(np.arange(v.shape[rows] // 2), axis=rows) for k, v in batch.items()})
        return trainer, state

    return types.SimpleNamespace(**{**vars(program), "build_trainer": build_trainer})


def altered_answer(program):
    """One served feature row comes back altered: the first clip's is negated."""

    def serve(towers, batch):
        video, text = program.serve(towers, batch)
        video = video.copy()
        video[0] = -video[0]
        return video, np.asarray(text)

    return types.SimpleNamespace(**{**vars(program), "serve": serve})


FAULTS = {"train": {"unchanged_state": unchanged_state, "half_batch": half_batch},
          "serve": {"altered_answer": altered_answer}}
