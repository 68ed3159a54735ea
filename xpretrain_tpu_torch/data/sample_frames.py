"""Frame-index samplers (host-side, numpy, explicitly seeded; the port's copy
of ``xpretrain_tpu/data/sample_frames.py``).

The mmaction2-style ``SampleFrames`` (``CLIP-ViP/src/datasets/sample_frames.py:11-188``,
:class:`FrameSampler`), the uniform sampling-with-jitter path used when ``sample_rate == 0``
(``CLIP-ViP/src/datasets/dataset_video_retrieval.py:78-95``), the HD-VILA
center-frame neighborhood samplers (``hd-vila/src/datasets/dataset_pretrain.py:66-80``,
``dataset_video_qa.py:79-100``), the LF-VILA multi-clip splitter
(``LF-VILA/src/datasets/pretrain_dataset.py:80-136``) and the LF-VILA
downstream tasks' jittered linspace (``how2qa_dataset.py:57-66``).

All take an explicit ``np.random.Generator`` so data pipelines are
reproducible per (seed, epoch, index).
"""

from __future__ import annotations

import numpy as np


class FrameSampler:
    """clip_len / frame_interval / num_clips sampling.

    Train mode: each clip's window is placed at a random offset inside its
    evenly-divided span. Test mode: windows are centered (avg_interval / 2
    shift), with optional ``twice_sample`` adding the non-shifted set.
    Out-of-bound indices either wrap (``loop``) or clamp to the last valid
    frame of the clip (``repeat_last``).
    """

    def __init__(
        self,
        clip_len: int,
        frame_interval: int = 1,
        num_clips: int = 1,
        temporal_jitter: bool = False,
        twice_sample: bool = False,
        out_of_bound_opt: str = "loop",
        test_mode: bool = False,
        keep_tail_frames: bool = False,
    ):
        if out_of_bound_opt not in ("loop", "repeat_last"):
            raise ValueError(f"bad out_of_bound_opt {out_of_bound_opt!r}")
        self.clip_len = clip_len
        self.frame_interval = frame_interval
        self.num_clips = num_clips
        self.temporal_jitter = temporal_jitter
        self.twice_sample = twice_sample
        self.out_of_bound_opt = out_of_bound_opt
        self.test_mode = test_mode
        self.keep_tail_frames = keep_tail_frames

    # -- clip offset selection ------------------------------------------------

    def _train_offsets(self, num_frames: int, rng: np.random.Generator) -> np.ndarray:
        span = self.clip_len * self.frame_interval
        if self.keep_tail_frames:
            avg = (num_frames - span + 1) / float(self.num_clips)
            if num_frames > span - 1:
                base = np.arange(self.num_clips) * avg
                return (base + rng.uniform(0, avg, self.num_clips)).astype(np.int64)
            return np.zeros((self.num_clips,), dtype=np.int64)
        avg = (num_frames - span + 1) // self.num_clips
        if avg > 0:
            base = np.arange(self.num_clips) * avg
            return base + rng.integers(0, avg, size=self.num_clips)
        if num_frames > max(self.num_clips, span):
            return np.sort(rng.integers(0, num_frames - span + 1, size=self.num_clips))
        if avg == 0:
            ratio = (num_frames - span + 1.0) / self.num_clips
            return np.around(np.arange(self.num_clips) * ratio).astype(np.int64)
        return np.zeros((self.num_clips,), dtype=np.int64)

    def _test_offsets(self, num_frames: int) -> np.ndarray:
        span = self.clip_len * self.frame_interval
        avg = (num_frames - span + 1) / float(self.num_clips)
        if num_frames > span - 1:
            base = np.arange(self.num_clips) * avg
            offsets = (base + avg / 2.0).astype(np.int64)
            if self.twice_sample:
                offsets = np.concatenate([offsets, base.astype(np.int64)])
            return offsets
        return np.zeros((self.num_clips,), dtype=np.int64)

    # -- public API -----------------------------------------------------------

    def __call__(
        self,
        total_frames: int,
        rng: np.random.Generator | None = None,
        start_index: int = 0,
    ) -> np.ndarray:
        """Return flat frame indices of shape [num_clips * clip_len]."""
        if rng is None:
            rng = np.random.default_rng()
        if self.test_mode:
            offsets = self._test_offsets(total_frames)
        else:
            offsets = self._train_offsets(total_frames, rng)
        inds = offsets[:, None] + np.arange(self.clip_len)[None, :] * self.frame_interval
        inds = inds.reshape(-1)
        if self.temporal_jitter and self.frame_interval > 1:
            inds = inds + rng.integers(0, self.frame_interval, size=len(inds))
        inds = inds.reshape(-1, self.clip_len)
        if self.out_of_bound_opt == "loop":
            inds = np.mod(inds, total_frames)
        else:  # repeat_last: clamp overshoot to the clip's last in-bounds index
            safe = inds < total_frames
            last = np.max(np.where(safe, inds, 0), axis=1, keepdims=True)
            inds = np.where(safe, inds, last)
        return (inds.reshape(-1) + start_index).astype(np.int64)


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


def center_neighbor_sample(
    total_frames: int,
    num_frames: int,
    sample_rate: int,
    rng: np.random.Generator | None = None,
    test_mode: bool = False,
) -> tuple[np.ndarray, int]:
    """HD-VILA-style sampling: a middle frame plus neighbors at fixed spacing.

    Returns (indices[num_frames], middle_position). The middle frame sits at
    position num_frames // 2; neighbors are ``sample_rate`` apart. Train mode
    randomizes the middle frame within the valid span; test centers it.
    """
    half_span = (num_frames // 2) * sample_rate
    lo, hi = half_span, max(total_frames - half_span, half_span + 1)
    if test_mode or rng is None:
        middle = (lo + hi) // 2
    else:
        middle = int(rng.integers(lo, hi))
    offsets = (np.arange(num_frames) - num_frames // 2) * sample_rate
    inds = np.clip(middle + offsets, 0, total_frames - 1)
    return inds.astype(np.int64), num_frames // 2


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


def span_jitter_linspace_sample(
    total_frames: int,
    num_frames: int,
    rng: np.random.Generator | None = None,
    test_mode: bool = False,
) -> np.ndarray:
    """Linspace over the full video with jittered endpoints at train time.

    The LF-VILA downstream-task read pattern (``how2qa_dataset.py:57-66``,
    identical in violin/actnet/video-classification): eval is an exact
    ``linspace(0, T-1, n)``; train draws a random start in the first
    inter-frame interval and a random end in the last, then linspaces
    between them.
    """
    total_frames = max(int(total_frames), 1)
    if test_mode or rng is None or total_frames <= num_frames:
        return np.linspace(0, total_frames - 1, num_frames).astype(np.int64)
    interval = int(total_frames / max(num_frames - 1, 1))
    start = int(rng.integers(0, interval + 1))
    lo = max(total_frames - 1 - interval, start + 1)
    end = int(rng.integers(lo, max(total_frames, lo + 1)))
    return np.linspace(start, end, num_frames).astype(np.int64)


def spread_center_neighbor_sample(
    total_frames: int,
    n_clips: int,
    num_frames: int,
    sample_rate: int,
    rng: np.random.Generator | None = None,
    test_mode: bool = False,
) -> list[np.ndarray]:
    """n_clips center+neighbor windows over ONE video.

    The HD-VILA QA/retrieval eval pattern (``dataset_video_qa.py:79-100``):
    middle frames are drawn without replacement from the valid span at train
    time, and spread at an even stride across it at inference, so
    ``inference_n_clips`` clips cover the whole video instead of re-sampling
    the same center. The sample rate shrinks when the video is too short.
    Returns one [num_frames] index array per clip (middle at num_frames//2).
    """
    total_frames = max(int(total_frames), 1)
    neighbor = (num_frames - 1) // 2
    sr = sample_rate
    if neighbor and total_frames < 2 * neighbor * sr + n_clips:
        sr = max((total_frames - n_clips) // (2 * neighbor), 0)
    lo, hi = neighbor * sr, total_frames - neighbor * sr
    valid = np.arange(lo, max(hi, lo + 1))
    if test_mode or rng is None:
        stride = max(len(valid) // n_clips, 1)
        middles = valid[::stride][:n_clips]
    else:
        k = min(n_clips, len(valid))
        middles = np.sort(rng.choice(valid, size=k, replace=False))
    middles = list(middles)
    while len(middles) < n_clips:
        middles.append(middles[-1])
    offsets = (np.arange(num_frames) - num_frames // 2) * sr
    return [
        np.clip(int(m) + offsets, 0, total_frames - 1).astype(np.int64) for m in middles
    ]
