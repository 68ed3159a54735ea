"""LF-VILA downstream benchmark datasets (How2QA / VIOLIN / ActivityNet-QA /
video classification) + their collators (the port's copy of
``xpretrain_tpu/data/datasets_lfvila_tasks.py``).

Capability parity with the reference's four dedicated loaders:

- :class:`How2QADataset` — ``LF-VILA/src/datasets/how2qa_dataset.py:1-196``:
  jsonl rows ``{clip_id, span, text_q, text_a[4], text_s[{text,start,end}],
  answer_idx}``; per-choice text layout [4, 2+max_num_subtitle, L] (question
  row, answer row, merged subtitles, zero-padded); temporal span labels +
  weights over the sampled frames.
- :class:`ViolinDataset` — ``violin_dataset.py:1-182``: statement
  verification; text layout [1+max_num_subtitle, L]; binary label.
- :class:`ActnetQADataset` — ``actnet_qa_dataset.py:1-134``: open-ended QA
  as classification; rows ``{video_name, question, answer}`` with integer
  answer labels; text layout [1, L].
- :class:`VideoClsDataset` — ``video_classification_dataset.py:1-113``:
  video-only classification; rows ``{video_id, recipe_type}``.

All four read a single long video with the jittered-linspace pattern
(:func:`~xpretrain_tpu_torch.data.sample_frames.span_jitter_linspace_sample`) and
carry the reference's replacement-retry resilience. A ``synthetic`` mode
generates deterministic (seed, index)-keyed fixtures for the ``dummy_data``
CLI path, so every task trains/evals without real assets.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from xpretrain_tpu_torch.data.datasets import FrameSource, synthetic_caption
from xpretrain_tpu_torch.data.sample_frames import span_jitter_linspace_sample
from xpretrain_tpu_torch.data.transforms import (
    IMAGENET_MEAN,
    IMAGENET_STD,
    center_crop,
    normalize,
    random_crop,
    resize,
)
from xpretrain_tpu_torch.utils.logging import LOGGER


def get_temporal_loss_label(
    span: Sequence[float], num_frame: int, num_labels: int = 32, fps: int = 3
) -> tuple[np.ndarray, np.ndarray]:
    """Per-frame in-span labels + balancing weights.

    Matches ``how2qa_dataset.py:175-196``: the answer span (seconds) maps to
    a [start, end) bucket range over ``num_labels`` frame slots; a NaN span
    means the whole video. Weights rebalance so in-span and out-of-span
    halves each carry 0.5 of the mass.
    """

    def clamp(lo, x, hi):
        return max(lo, min(x, hi))

    total_time = num_frame / fps
    if span[0] == span[0] and span[1] == span[1]:  # NaN check, as reference
        start = clamp(0.0, span[0] / total_time, 1.0)
        end = clamp(0.0, span[1] / total_time, 1.0)
    else:
        start, end = 0.0, 1.0
    start = clamp(0, int(round(start * num_labels)), num_labels - 1)
    end = clamp(start + 1, int(round(end * num_labels)), num_labels)
    label = np.zeros(num_labels, np.int64)
    label[start:end] = 1
    n1 = end - start
    n0 = max(1, num_labels - n1)
    weight = np.full(num_labels, num_labels * 0.5 / n0, np.float32)
    weight[start:end] = num_labels * 0.5 / n1
    return label, weight


def merge_subtitles_greedy(
    texts: list[str], spans: list[tuple[float, float]], tolen: int
) -> tuple[list[str], list[tuple[float, float]]]:
    """Greedy shortest-adjacent-pair merge of subtitles, spans unioned
    (the in-class ``merge`` of ``how2qa_dataset.py:80-100``)."""
    texts, spans = list(texts), list(spans)
    while len(texts) > tolen:
        pair_lens = [len(texts[i]) + len(texts[i + 1]) for i in range(len(texts) - 1)]
        i = int(np.argmin(pair_lens))
        texts[i : i + 2] = [texts[i] + " " + texts[i + 1]]
        spans[i : i + 2] = [(spans[i][0], spans[i + 1][1])]
    return texts, spans


class _LongVideoTaskDataset:
    """Shared base: one long video per row, jittered-linspace frame sampling,
    resize->crop->ImageNet-normalize, replacement retries."""

    id_key = "clip_id"

    def __init__(
        self,
        rows: Sequence[dict],
        frame_source: FrameSource | None,
        sample_frame: int = 32,
        input_hw: tuple[int, int] = (192, 320),
        train: bool = True,
        seed: int = 0,
        max_num_subtitle: int = 6,
        max_retries: int = 10,
        synthetic: bool = False,
        synthetic_num_frame: int = 96,
    ):
        self.rows = rows
        self.source = frame_source
        self.sample_frame = sample_frame
        self.input_hw = tuple(input_hw)
        self.train = train
        self.seed = seed
        self.max_num_subtitle = max_num_subtitle
        self.max_retries = max_retries
        self.synthetic = synthetic
        self.synthetic_num_frame = synthetic_num_frame
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.rows)

    def _read_video(self, clip_id: str, rng) -> tuple[np.ndarray, int]:
        """-> (fp32 [3, N, H, W], source frame count)."""
        h, w = self.input_hw
        if self.synthetic:
            num_frame = self.synthetic_num_frame
            frames = rng.integers(
                0, 256, size=(self.sample_frame, h + 16, w + 16, 3), dtype=np.uint8
            )
        else:
            num_frame = self.source.total_frames(clip_id)
            inds = span_jitter_linspace_sample(
                num_frame, self.sample_frame, rng, test_mode=not self.train
            )
            frames = self.source.load(clip_id, inds)
        frames = resize(frames, (int(h * 1.1), int(w * 1.1)))
        frames = random_crop(frames, (h, w), rng) if self.train else center_crop(frames, (h, w))
        pixels = normalize(frames, IMAGENET_MEAN, IMAGENET_STD)  # [N, 3, H, W]
        return pixels.transpose(1, 0, 2, 3), num_frame

    def _load(self, index: int, rng) -> dict[str, Any]:
        raise NotImplementedError

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = np.random.default_rng((self.seed, self.epoch, index))
        for _ in range(self.max_retries):
            try:
                return self._load(index, rng)
            except Exception as e:  # noqa: BLE001 - corrupt-clip resilience
                LOGGER.warning(
                    "%s: failed idx %d (%s); replacement retry",
                    type(self).__name__,
                    index,
                    e,
                )
                index = int(rng.integers(0, len(self.rows)))
        raise RuntimeError(f"{type(self).__name__}: exceeded retry budget")

    # -- helpers ---------------------------------------------------------
    def _subtitles(self, row: dict) -> list[str]:
        subs = row.get("text_s", [])
        texts = [s["text"] for s in subs]
        spans = [(s.get("start", 0.0), s.get("end", 0.0)) for s in subs]
        if len(texts) > self.max_num_subtitle:
            texts, spans = merge_subtitles_greedy(texts, spans, self.max_num_subtitle)
        return texts


class How2QADataset(_LongVideoTaskDataset):
    """Multichoice QA over long videos with subtitles + span labels: a
    synthetic sample draws ``num_options`` answers (How2QA's 4 by default), a
    jsonl row carries its own."""

    def __init__(self, *args, num_options: int = 4, **kwargs):
        super().__init__(*args, **kwargs)
        self.n_choice = num_options

    def _load(self, index: int, rng) -> dict[str, Any]:
        row = self.rows[index]
        if self.synthetic:
            video, num_frame = self._read_video("", rng)
            question = synthetic_caption(rng)
            answers = [synthetic_caption(rng) for _ in range(self.n_choice)]
            subtitles = [synthetic_caption(rng) for _ in range(2)]
            label = index % self.n_choice
            t = num_frame / 3.0
            span = sorted(rng.uniform(0.0, t, size=2).tolist())
        else:
            video, num_frame = self._read_video(str(row["clip_id"]), rng)
            question = row["text_q"]
            answers = list(row["text_a"])
            subtitles = self._subtitles(row)
            label = int(row["answer_idx"])
            span = row["span"]
        span_labels, span_weights = get_temporal_loss_label(
            span, num_frame, num_labels=self.sample_frame
        )
        return {
            "id": index,
            "video_frames": video,
            "question": question,
            "answers": answers,
            "subtitles": subtitles,
            "label": label,
            "span_labels": span_labels,
            "span_label_weights": span_weights,
        }


class ViolinDataset(_LongVideoTaskDataset):
    """Statement verification (true/false) with subtitles."""

    def _load(self, index: int, rng) -> dict[str, Any]:
        row = self.rows[index]
        if self.synthetic:
            video, _ = self._read_video("", rng)
            statement = synthetic_caption(rng)
            subtitles = [synthetic_caption(rng)]
            label = index % 2
        else:
            video, _ = self._read_video(str(row["clip_id"]), rng)
            statement = row["text_q"]
            subtitles = self._subtitles(row)
            label = int(row["answer"])
        return {
            "id": index,
            "video_frames": video,
            "statement": statement,
            "subtitles": subtitles,
            "label": label,
        }


class ActnetQADataset(_LongVideoTaskDataset):
    """Open-ended QA as classification over an answer vocabulary."""

    def __init__(self, *args, num_labels: int = 1000, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_labels = num_labels

    def _load(self, index: int, rng) -> dict[str, Any]:
        row = self.rows[index]
        if self.synthetic:
            video, _ = self._read_video("", rng)
            question = synthetic_caption(rng)
            label = index % self.num_labels
        else:
            video, _ = self._read_video(str(row["video_name"]), rng)
            question = row["question"]
            label = int(row["answer"])
        return {"id": index, "video_frames": video, "question": question, "label": label}


class VideoClsDataset(_LongVideoTaskDataset):
    """Video-only classification (COIN recipe types / LVU)."""

    def __init__(self, *args, num_labels: int = 180, **kwargs):
        super().__init__(*args, **kwargs)
        self.num_labels = num_labels

    def _load(self, index: int, rng) -> dict[str, Any]:
        row = self.rows[index]
        if self.synthetic:
            video, _ = self._read_video("", rng)
            label = index % self.num_labels
        else:
            video, _ = self._read_video(str(row["video_id"]), rng)
            label = int(row.get("recipe_type", row.get("label")))
        return {"id": index, "video_frames": video, "label": label}


# ---------------------------------------------------------------------------
# collators
# ---------------------------------------------------------------------------


def _tokenize_rows(tokenizer, texts: list[str], max_len: int) -> tuple[np.ndarray, np.ndarray]:
    ids, mask = tokenizer(texts, max_len)
    return np.asarray(ids), np.asarray(mask)


def _pad_subtitle_rows(
    tokenizer, subtitles: list[str], max_num: int, max_len: int
) -> tuple[np.ndarray, np.ndarray]:
    """Tokenize up to ``max_num`` subtitles; missing rows are ALL-ZERO ids and
    mask (the reference pads token ids with zeros, not tokenized empty
    strings — ``how2qa_dataset.py:117-121``)."""
    ids = np.zeros((max_num, max_len), np.int64)
    mask = np.zeros((max_num, max_len), np.int64)
    present = subtitles[:max_num]
    if present:
        sid, smask = _tokenize_rows(tokenizer, present, max_len)
        ids[: len(present)] = sid
        mask[: len(present)] = smask
    return ids, mask


class How2QACollator:
    """-> text_ids [B, 4, 2+max_num_subtitle, L] (question row, answer row,
    subtitle rows shared across choices), labels, span labels/weights."""

    def __init__(self, tokenizer, max_sent_len: int = 50, max_num_subtitle: int = 6):
        self.tok = tokenizer
        self.max_sent_len = max_sent_len
        self.max_num_subtitle = max_num_subtitle

    def __call__(self, items: Sequence[dict]) -> dict[str, np.ndarray]:
        B = len(items)
        n_choice = len(items[0]["answers"])
        L, S = self.max_sent_len, self.max_num_subtitle
        q_ids, q_mask = _tokenize_rows(self.tok, [it["question"] for it in items], L)
        a_flat = [a for it in items for a in it["answers"]]
        a_ids, a_mask = _tokenize_rows(self.tok, a_flat, L)
        a_ids = a_ids.reshape(B, n_choice, L)
        a_mask = a_mask.reshape(B, n_choice, L)

        ids = np.zeros((B, n_choice, 2 + S, L), np.int64)
        mask = np.zeros((B, n_choice, 2 + S, L), np.int64)
        for b, it in enumerate(items):
            s_ids, s_mask = _pad_subtitle_rows(self.tok, it["subtitles"], S, L)
            ids[b, :, 0] = q_ids[b]
            mask[b, :, 0] = q_mask[b]
            ids[b, :, 1] = a_ids[b]
            mask[b, :, 1] = a_mask[b]
            ids[b, :, 2:] = s_ids
            mask[b, :, 2:] = s_mask
        return {
            "video_frames": np.stack([it["video_frames"] for it in items]).astype(np.float32),
            "text_ids": ids,
            "attention_mask": mask,
            "labels": np.asarray([it["label"] for it in items], np.int64),
            "span_labels": np.stack([it["span_labels"] for it in items]),
            "span_label_weights": np.stack([it["span_label_weights"] for it in items]),
        }


class ViolinCollator:
    """-> text_ids [B, 1+max_num_subtitle, L] (statement + subtitles)."""

    def __init__(self, tokenizer, max_sent_len: int = 30, max_num_subtitle: int = 4):
        self.tok = tokenizer
        self.max_sent_len = max_sent_len
        self.max_num_subtitle = max_num_subtitle

    def __call__(self, items: Sequence[dict]) -> dict[str, np.ndarray]:
        B = len(items)
        L, S = self.max_sent_len, self.max_num_subtitle
        q_ids, q_mask = _tokenize_rows(self.tok, [it["statement"] for it in items], L)
        ids = np.zeros((B, 1 + S, L), np.int64)
        mask = np.zeros((B, 1 + S, L), np.int64)
        for b, it in enumerate(items):
            s_ids, s_mask = _pad_subtitle_rows(self.tok, it["subtitles"], S, L)
            ids[b, 0], mask[b, 0] = q_ids[b], q_mask[b]
            ids[b, 1:], mask[b, 1:] = s_ids, s_mask
        return {
            "video_frames": np.stack([it["video_frames"] for it in items]).astype(np.float32),
            "text_ids": ids,
            "attention_mask": mask,
            "labels": np.asarray([it["label"] for it in items], np.int64),
        }


class ActnetQACollator:
    """-> text_ids [B, 1, L] (question only)."""

    def __init__(self, tokenizer, max_sent_len: int = 50):
        self.tok = tokenizer
        self.max_sent_len = max_sent_len

    def __call__(self, items: Sequence[dict]) -> dict[str, np.ndarray]:
        ids, mask = _tokenize_rows(self.tok, [it["question"] for it in items], self.max_sent_len)
        return {
            "video_frames": np.stack([it["video_frames"] for it in items]).astype(np.float32),
            "text_ids": ids[:, None, :],
            "attention_mask": mask[:, None, :],
            "labels": np.asarray([it["label"] for it in items], np.int64),
        }


class VideoClsCollator:
    def __call__(self, items: Sequence[dict]) -> dict[str, np.ndarray]:
        return {
            "video_frames": np.stack([it["video_frames"] for it in items]).astype(np.float32),
            "labels": np.asarray([it["label"] for it in items], np.int64),
        }
