"""Frame-index samplers (host-side, numpy, explicitly seeded; the port's copy
of the parts of ``xpretrain_tpu/data/sample_frames.py`` it uses).

The uniform sampling-with-jitter path used when ``sample_rate == 0``
(``CLIP-ViP/src/datasets/dataset_video_retrieval.py:78-95``) and the LF-VILA
multi-clip splitter (``LF-VILA/src/datasets/pretrain_dataset.py:80-136``).

Both take an explicit ``np.random.Generator`` so data pipelines are
reproducible per (seed, epoch, index).
"""

from __future__ import annotations

import numpy as np


def uniform_sample_with_jitter(
    total_frames: int,
    num_frames: int,
    rng: np.random.Generator | None = None,
    test_mode: bool = False,
) -> np.ndarray:
    """Uniformly spaced frames; train mode jitters within each segment.

    The ``sample_rate == 0`` path of the CLIP-ViP retrieval dataset: the
    video is split into ``num_frames`` equal segments; test picks each
    segment's midpoint, train picks a uniform random frame per segment.
    """
    bounds = np.linspace(0, total_frames, num_frames + 1)
    if test_mode or rng is None:
        idx = (bounds[:-1] + bounds[1:]) / 2.0
    else:
        lo = bounds[:-1]
        hi = np.maximum(bounds[1:], lo + 1.0)
        idx = rng.uniform(lo, hi)
    return np.clip(idx.astype(np.int64), 0, total_frames - 1)


def multi_clip_sample(
    clip_frame_counts: list[int],
    total_frames_out: int,
    rng: np.random.Generator | None = None,
    test_mode: bool = False,
) -> list[np.ndarray]:
    """LF-VILA-style long-form sampling: split a frame budget across clips.

    ``total_frames_out`` frames are divided evenly over the clips of a
    multi-clip sequence; each clip is sampled uniformly (with per-segment
    jitter at train time). Returns one index array per clip.
    """
    n_clips = len(clip_frame_counts)
    per_clip = total_frames_out // n_clips
    counts = [per_clip] * n_clips
    counts[-1] += total_frames_out - per_clip * n_clips
    return [
        uniform_sample_with_jitter(max(n, 1), c, rng=rng, test_mode=test_mode)
        for n, c in zip(clip_frame_counts, counts)
    ]
