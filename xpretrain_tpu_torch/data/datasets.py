"""Dataset classes + collators for the video-text pipelines (the port's copy of
the parts of ``xpretrain_tpu/data/datasets.py`` it uses).

Capability parity with the reference's dataset layer (SURVEY.md §2.5):
retrieval datasets over json/jsonl annotations with uniform/jittered frame
sampling (``CLIP-ViP/src/datasets/dataset_video_retrieval.py:25-148``), the
``dummy_data`` synthetic path (``:126-130``), corrupt-video retry with random
replacement (``dataset_pretrain_stage1_all_source.py:196-212``) and
paragraph-concat for DiDeMo-style sets (``:137-138``).

Video frames come from pluggable sources: a directory of frame images, .npy
clips, or the native decoder (``xpretrain_tpu_torch.data.video_reader``).
"""

from __future__ import annotations

import os
from typing import Any, Callable, Sequence

import numpy as np

from xpretrain_tpu_torch.data.sample_frames import uniform_sample_with_jitter
from xpretrain_tpu_torch.data.transforms import clip_resize_crop_u8, clip_transform
from xpretrain_tpu_torch.utils.basic import load_json, load_jsonl
from xpretrain_tpu_torch.utils.logging import LOGGER

_WORDS = (
    "a person dog cat car runs jumps plays sings red blue green small large "
    "city park road water sky tree house ball game music fast slow day night"
).split()


def synthetic_caption(rng: np.random.Generator, min_len: int = 4, max_len: int = 12) -> str:
    n = int(rng.integers(min_len, max_len))
    return " ".join(_WORDS[int(i)] for i in rng.integers(0, len(_WORDS), n))


class SyntheticVideoTextDataset:
    """The ``dummy_data`` path: deterministic random clips + captions.

    Every item is reproducible from (seed, index) so multi-process loaders
    agree without communication; frames are uint8 [T, H, W, C].
    """

    def __init__(
        self,
        size: int = 256,
        num_frames: int = 12,
        image_size: int = 224,
        seed: int = 0,
        with_image_branch: bool = False,
    ):
        self.size = size
        self.num_frames = num_frames
        self.image_size = image_size
        self.seed = seed
        self.with_image_branch = with_image_branch

    def __len__(self) -> int:
        return self.size

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = np.random.default_rng((self.seed, index))
        frames = rng.integers(
            0, 256, size=(self.num_frames, self.image_size, self.image_size, 3), dtype=np.uint8
        )
        item = {
            "id": index,
            "frames": frames,
            "text": synthetic_caption(rng),
        }
        if self.with_image_branch:
            item["image"] = frames[self.num_frames // 2 : self.num_frames // 2 + 1]
            item["caption"] = synthetic_caption(rng)
        return item


class FrameSource:
    """Load raw frames for a clip id from one of several storage layouts."""

    def __init__(self, root: str, mode: str = "auto", ext: str = ".jpg"):
        self.root = root
        self.mode = mode
        self.ext = ext

    def total_frames(self, clip_id: str) -> int:
        path = os.path.join(self.root, clip_id)
        if self.mode == "npy" or (self.mode == "auto" and os.path.exists(path + ".npy")):
            return int(np.load(path + ".npy", mmap_mode="r").shape[0])
        if os.path.isdir(path):
            return len([f for f in os.listdir(path) if f.endswith(self.ext)])
        from xpretrain_tpu_torch.data import video_reader

        return video_reader.probe(self._video_path(clip_id)).num_frames

    def _video_path(self, clip_id: str) -> str:
        base = os.path.join(self.root, clip_id)
        for ext in (".mp4", ".webm", ".mkv", ".avi"):
            if os.path.exists(base + ext):
                return base + ext
        return base

    def load(self, clip_id: str, frame_indices: np.ndarray) -> np.ndarray:
        """-> uint8 [T, H, W, C]"""
        path = os.path.join(self.root, clip_id)
        if self.mode == "npy" or (self.mode == "auto" and os.path.exists(path + ".npy")):
            arr = np.load(path + ".npy", mmap_mode="r")
            return np.ascontiguousarray(arr[frame_indices])
        if os.path.isdir(path):
            import cv2

            names = sorted(f for f in os.listdir(path) if f.endswith(self.ext))
            frames = []
            for i in frame_indices:
                img = cv2.imread(os.path.join(path, names[int(i)]))
                frames.append(cv2.cvtColor(img, cv2.COLOR_BGR2RGB))
            return np.stack(frames)
        from xpretrain_tpu_torch.data import video_reader

        return video_reader.read_frames(self._video_path(clip_id), frame_indices)


class VideoRetrievalDataset:
    """json/jsonl annotation dataset for retrieval train/eval.

    Annotation rows: ``{"clip_id": ..., "text": ...}`` (lists of texts are
    joined for paragraph retrieval, the DiDeMo behavior). Corrupt clips are
    retried with random replacements up to ``max_retries``.
    """

    def __init__(
        self,
        annotation_path: str,
        frame_source: FrameSource,
        num_frames: int = 12,
        image_size: int = 224,
        train: bool = False,
        seed: int = 0,
        max_retries: int = 10,
        transform: Callable | None = None,
        device_ingest: bool = False,
    ):
        rows = (
            load_jsonl(annotation_path)
            if annotation_path.endswith("l")
            else load_json(annotation_path)
        )
        self.rows = rows
        self.source = frame_source
        self.num_frames = num_frames
        self.image_size = image_size
        self.train = train
        self.seed = seed
        self.max_retries = max_retries
        if transform is not None:
            self.transform = transform
        elif device_ingest:
            # geometry-only on host; uint8 to device, normalization folded
            # into the patch-embedding gemm (ops/patchify.py)
            self.transform = lambda frames, rng: clip_resize_crop_u8(
                frames, image_size, train, rng
            )
        else:
            self.transform = lambda frames, rng: clip_transform(frames, image_size, train, rng)
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.rows)

    def _text_of(self, row: dict) -> str:
        text = row.get("text", row.get("caption", ""))
        if isinstance(text, (list, tuple)):
            text = " ".join(text)
        return text

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = np.random.default_rng((self.seed, self.epoch, index))
        for attempt in range(self.max_retries):
            row = self.rows[index]
            clip_id = str(row.get("clip_id", row.get("video_id", row.get("id"))))
            try:
                total = self.source.total_frames(clip_id)
                inds = uniform_sample_with_jitter(
                    total, self.num_frames, rng=rng, test_mode=not self.train
                )
                frames = self.source.load(clip_id, inds)
                pixels = self.transform(frames, rng)
                return {"id": index, "video": pixels, "text": self._text_of(row)}
            except Exception as e:  # noqa: BLE001 - corrupt-clip resilience
                LOGGER.warning("failed to load %s (%s); retrying", clip_id, e)
                index = int(rng.integers(0, len(self.rows)))
        raise RuntimeError(f"exceeded {self.max_retries} retries loading data")


class RetrievalCollator:
    """Tokenize texts + stack clips (ref ``VideoRetrievalCollator``)."""

    def __init__(self, tokenizer, max_txt_len: int = 70):
        self.tokenizer = tokenizer
        self.max_txt_len = max_txt_len

    def __call__(self, items: Sequence[dict]) -> dict[str, np.ndarray]:
        video = np.stack([it["video"] for it in items])
        if video.dtype != np.uint8:  # uint8 = device-ingest path, keep as-is
            video = video.astype(np.float32)
        ids, mask = self.tokenizer([it["text"] for it in items], self.max_txt_len)
        return {
            "video": video,  # [B, T, C, H, W] fp32 or [B, T, H, W, C] uint8
            "text_input_ids": ids,
            "text_input_mask": mask,
            "ids": np.asarray([it["id"] for it in items], dtype=np.int64),
        }
