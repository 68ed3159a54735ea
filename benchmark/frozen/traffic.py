"""CLIP-style captions.

Frozen copy of ``captions`` from
``xpretrain_tpu_torch/tools/profile_train_step.py`` at commit 7fcd34c.
"""

from __future__ import annotations

import numpy as np


def captions(rng: np.random.Generator, batch: int, seq: int = 70) -> tuple[np.ndarray, np.ndarray]:
    """CLIP-style token ids: BOS, random ids, EOT (the highest id, where the
    text tower pools); mask = ids > 0."""
    ids = np.zeros((batch, seq), np.int64)
    ids[:, 0] = 49406
    for i, n in enumerate(rng.integers(3, seq - 1, size=batch)):
        ids[i, 1:n] = rng.integers(10, 49406, size=n - 1)
        ids[i, n] = 49407
    return ids, (ids > 0).astype(np.int64)
