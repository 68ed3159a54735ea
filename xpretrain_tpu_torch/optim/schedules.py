"""LR schedules with the reference's step-wise semantics
(``xpretrain_tpu/optim/schedules.py``; ref ``CLIP-ViP/src/optimization/sched.py:9-84``).

Each schedule is a plain ``step -> lr`` function of an int step, evaluated on
the host: warmup linear/cosine, noam/invsqrt, multi-step, constant, the 1e-8
floor, and the plateau-driven ``AutoStep``.
"""

from __future__ import annotations

import math
from typing import Callable, Sequence

Schedule = Callable[[int], float]

LR_FLOOR = 1e-8


def warmup_linear(learning_rate: float, warmup_steps: int, total_steps: int) -> Schedule:
    def fn(step: int) -> float:
        if step < warmup_steps:
            frac = step / max(warmup_steps, 1)
        else:
            frac = max(0.0, (total_steps - step) / max(total_steps - warmup_steps, 1))
        return max(learning_rate * frac, LR_FLOOR)

    return fn


def warmup_cosine(learning_rate: float, warmup_steps: int, total_steps: int) -> Schedule:
    def fn(step: int) -> float:
        if step < warmup_steps:
            frac = step / max(warmup_steps, 1)
        else:
            progress = (step - warmup_steps) / max(total_steps - warmup_steps, 1)
            frac = 0.5 * (1.0 + math.cos(math.pi * progress))
        return max(learning_rate * frac, LR_FLOOR)

    return fn


def noam(learning_rate: float, warmup_steps: int) -> Schedule:
    def fn(step: int) -> float:
        if step <= warmup_steps:
            frac = step / max(warmup_steps, 1)
        else:
            frac = warmup_steps**0.5 * max(step, 1) ** -0.5
        return max(learning_rate * frac, LR_FLOOR)

    return fn


def constant(learning_rate: float) -> Schedule:
    def fn(step: int) -> float:
        return learning_rate

    return fn


def multi_step(
    learning_rate: float,
    warmup_steps: int,
    steps_per_epoch: int,
    milestones: Sequence[int],
    gamma: float = 0.5,
) -> Schedule:
    """Epoch-milestone decay; epoch derived from step. Past the final
    milestone the reference returns ``gamma**(len(milestones)+1)``, and so
    does this (``CLIP-ViP/src/optimization/sched.py:26-34``)."""
    ms = sorted(milestones)

    def fn(step: int) -> float:
        if step <= warmup_steps:
            frac = step / max(warmup_steps, 1)
        else:
            epoch = step / max(steps_per_epoch, 1)
            power = sum(epoch >= m for m in ms)
            if power >= len(ms):
                power += 1
            frac = gamma**power
        return max(learning_rate * frac, LR_FLOOR)

    return fn


def get_schedule(
    decay: str,
    learning_rate: float,
    num_train_steps: int,
    warmup_ratio: float = 0.1,
    steps_per_epoch: int = 1,
    decay_epochs: Sequence[int] = (),
    gamma: float = 0.5,
) -> Schedule:
    """Dispatcher matching ``get_lr_sched`` (ref ``sched.py:62-84``)."""
    warmup_steps = int(warmup_ratio * num_train_steps)
    if decay == "linear":
        return warmup_linear(learning_rate, warmup_steps, num_train_steps)
    if decay == "cosine":
        return warmup_cosine(learning_rate, warmup_steps, num_train_steps)
    if decay == "invsqrt":
        return noam(learning_rate, warmup_steps)
    if decay == "constant":
        return constant(learning_rate)
    if decay == "multi_step":
        return multi_step(learning_rate, warmup_steps, steps_per_epoch, decay_epochs, gamma)
    raise ValueError(f"unknown decay {decay!r}")


class AutoStep:
    """Plateau-driven LR decay (host-side, ref ``sched.py:37-58``).

    Call :meth:`step` with the eval score after each validation; the decay
    coefficient multiplies after ``tolerance`` consecutive non-improvements.
    """

    def __init__(self, tolerance: int, gamma: float):
        self.tolerance = tolerance
        self.gamma = gamma
        self.coeff = 1.0
        self.best_score = 0.0
        self.count = 0

    def step(self, score: float) -> None:
        if score <= self.best_score:
            self.count += 1
        else:
            self.count = 0
        self.best_score = score
        if self.count > self.tolerance:
            self.count = 0
            self.coeff *= self.gamma

    def get_lr(
        self,
        global_step: int,
        learning_rate: float,
        num_train_steps: int,
        warmup_ratio: float = 0.1,
    ) -> float:
        warmup_steps = int(warmup_ratio * num_train_steps)
        if warmup_steps and global_step <= warmup_steps:
            return learning_rate * global_step / warmup_steps
        return max(self.coeff * learning_rate, LR_FLOOR)
