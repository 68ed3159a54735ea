"""Seed discipline (``xpretrain_tpu/utils/prng.py``) in ``torch.Generator`` form.

JAX folds the step into a PRNG key; the port seeds step ``s`` with ``seed +
s`` (``train/loop.py``), so a run's draws do not depend on how many steps a
call takes. Under data parallelism every rank draws its own dropout masks,
MTC clips and pixel subsets: its generator's seed is a fixed function of
(``seed + s``, rank), :func:`rank_seed`, which is ``seed + s`` itself at rank
0, so a one-rank group draws what one process draws. JAX draws one global
mask over the global batch; the per-rank draws are a deliberate difference
(ROADMAP Queue 3).
"""

from __future__ import annotations

import random
from typing import Optional

import numpy as np
import torch

_GOLDEN = 0x9E3779B9  # 2**32 / the golden ratio: rank r's seeds lie far from rank 0's


def set_host_seed(seed: int) -> None:
    """Seed host-side RNGs (python, numpy) used by data pipelines."""
    random.seed(seed)
    np.random.seed(seed % (2**32))


def rank_seed(seed: int, rank: int = 0) -> int:
    """The generator seed of ``rank`` for the step seeded ``seed``: ``seed``
    itself at rank 0, else shifted by ``rank`` golden-ratio steps, within the
    32 bits the CPU generator reads (it draws alike from seeds that differ
    above them)."""
    return (int(seed) + int(rank) * _GOLDEN) % (1 << 32)


def key_for_step(seed: int, step: int, rank: int = 0, device: Optional[torch.device | str] = None
                 ) -> torch.Generator:
    """The generator of step ``step`` on ``rank``: seeded ``seed + step``
    (then :func:`rank_seed`)."""
    return torch.Generator(device=device or "cpu").manual_seed(rank_seed(int(seed) + int(step), rank))


def split_dict(seed: int, names: tuple[str, ...], device: Optional[torch.device | str] = None
               ) -> dict[str, torch.Generator]:
    """One independent generator per name, each a fixed function of
    (``seed``, position): JAX's ``split`` of a key into named keys."""
    base = np.random.SeedSequence(int(seed) % (1 << 32))
    seeds = [int(s.generate_state(1)[0]) for s in base.spawn(len(names))]
    return {name: torch.Generator(device=device or "cpu").manual_seed(s) for name, s in zip(names, seeds)}
