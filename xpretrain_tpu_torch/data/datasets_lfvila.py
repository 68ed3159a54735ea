"""LF-VILA datasets: long-form multi-clip reads + per-sentence collation (the
port's copy of ``xpretrain_tpu/data/datasets_lfvila.py``).

Capability parity with ``LF-VILA/src/datasets/pretrain_dataset.py:27-224``
(multi-clip sequences: a frame budget split across the clips of one
long-form sample; per-sentence tokenization padded to ``sample_clip``
chunks; metadata by integer index from an LMDB-scale store; here a
sequence of records or of callables that return one) and
``retrieval_dataset.py:27-182`` (single long video -> uniform frames;
greedy shortest-pair sentence merging down to ``total_chunk``).
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from xpretrain_tpu_torch.data.datasets import FrameSource, synthetic_caption
from xpretrain_tpu_torch.data.sample_frames import multi_clip_sample, uniform_sample_with_jitter
from xpretrain_tpu_torch.data.tokenization import mask_batch_text_tokens
from xpretrain_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD, center_crop, normalize, random_crop, resize
from xpretrain_tpu_torch.utils.logging import LOGGER


def merge_sentences_greedy(sentences: list[str], total_chunk: int) -> list[str]:
    """Greedy shortest-adjacent-pair merging down to ``total_chunk``
    (ref ``retrieval_dataset.py:85-112``)."""
    sents = list(sentences)
    while len(sents) > total_chunk:
        lengths = [len(sents[i]) + len(sents[i + 1]) for i in range(len(sents) - 1)]
        i = int(np.argmin(lengths))
        sents[i : i + 2] = [sents[i] + " " + sents[i + 1]]
    while len(sents) < total_chunk:
        sents.append("")
    return sents


class LfVilaPretrainDataset:
    """Long-form samples: N frames split over the clips of a sequence,
    one sentence per clip (padded to ``sample_clip``)."""

    def __init__(
        self,
        records,  # sequence of {"clips": [clip_id...], "sentences": [str...]}
        frame_source: FrameSource | None,
        sample_frame: int = 32,
        sample_clip: int = 4,
        input_hw: tuple[int, int] = (192, 320),
        train: bool = True,
        seed: int = 0,
        max_retries: int = 10,
        synthetic: bool = False,
        device_ingest: bool = False,
    ):
        self.records = records
        self.source = frame_source
        self.sample_frame = sample_frame
        self.sample_clip = sample_clip
        self.input_hw = input_hw
        self.train = train
        self.seed = seed
        self.max_retries = max_retries
        self.synthetic = synthetic
        # ship raw uint8 [N, H, W, 3] and let PatchEmbed3D normalize on
        # device (4x less collate/H2D bytes, no host f32 pass) — the
        # packed-feed production path, PERF.md
        self.device_ingest = device_ingest
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.records)

    def _record(self, index: int) -> dict:
        rec = self.records[index]
        return rec if isinstance(rec, dict) else rec()

    def _load(self, index: int, rng) -> dict[str, Any]:
        rec = self._record(index)
        h, w = self.input_hw
        if self.synthetic:
            sr = np.random.default_rng((self.seed, index))
            frames = sr.integers(
                0, 256, size=(self.sample_frame, h + 16, w + 16, 3), dtype=np.uint8
            )
            sentences = [synthetic_caption(sr) for _ in range(self.sample_clip)]
        else:
            clips = [str(c) for c in rec["clips"]][: self.sample_clip]
            counts = [self.source.total_frames(c) for c in clips]
            index_lists = multi_clip_sample(
                counts, self.sample_frame, rng=rng, test_mode=not self.train
            )
            parts = [
                self.source.load(c, inds) for c, inds in zip(clips, index_lists)
            ]
            min_hw = (min(p.shape[1] for p in parts), min(p.shape[2] for p in parts))
            frames = np.concatenate([p[:, : min_hw[0], : min_hw[1]] for p in parts])
            sentences = list(rec.get("sentences", []))[: self.sample_clip]
            while len(sentences) < self.sample_clip:
                sentences.append("")
        frames = resize(frames, max(h, w) if h == w else (int(h * 1.1), int(w * 1.1)))
        if self.train:
            frames = random_crop(frames, (h, w), rng)
        else:
            frames = center_crop(frames, (h, w))
        if self.device_ingest:
            return {
                "id": index,
                "video_frames": np.ascontiguousarray(frames),  # u8 [N, H, W, 3]
                "sentences": sentences,
            }
        pixels = normalize(frames, IMAGENET_MEAN, IMAGENET_STD)  # [N, 3, H, W]
        return {
            "id": index,
            "video_frames": pixels.transpose(1, 0, 2, 3),  # [3, N, H, W]
            "sentences": sentences,
        }

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = np.random.default_rng((self.seed, self.epoch, index))
        for _ in range(self.max_retries):
            try:
                return self._load(index, rng)
            except Exception as e:  # noqa: BLE001
                LOGGER.warning("lfvila: failed idx %d (%s); replacement retry", index, e)
                index = int(rng.integers(0, len(self.records)))
        raise RuntimeError("exceeded retry budget loading lf-vila data")


class LfVilaPretrainCollator:
    """Per-sentence tokenization [B, M, L] + MLM over the flat [B, M*L]
    stream (ref ``LF-VILA/src/datasets/dataloader.py:28-91``)."""

    def __init__(self, tokenizer, max_sent_len: int = 50, mlm: bool = True, seed: int = 0):
        self.tokenizer = tokenizer
        self.max_sent_len = max_sent_len
        self.mlm = mlm
        self.rng = np.random.default_rng(seed)

    def __call__(self, items: Sequence[dict]) -> dict[str, np.ndarray]:
        B = len(items)
        M = len(items[0]["sentences"])
        flat = [s for it in items for s in it["sentences"]]
        ids, mask = self.tokenizer(flat, self.max_sent_len)
        ids = ids.reshape(B, M, self.max_sent_len)
        mask = mask.reshape(B, M, self.max_sent_len)
        vf = np.stack([it["video_frames"] for it in items])
        if vf.dtype != np.uint8:  # device-ingest ships u8 straight through
            vf = vf.astype(np.float32)
        batch = {
            "video_frames": vf,
            "text_ids": ids,
            "attention_mask": mask,
        }
        if self.mlm:
            masked, labels = mask_batch_text_tokens(
                ids.reshape(B, -1),
                getattr(self.tokenizer, "mask_id", 1),
                getattr(self.tokenizer, "vocab_size", 30522),
                self.rng,
                special_ids=(0,),
            )
            batch["text_ids"] = masked.reshape(B, M, self.max_sent_len)
            batch["mlm_labels"] = labels
        return batch


class LfVilaRetrievalDataset:
    """Paragraph->video retrieval: one long video, uniform frames, sentences
    greedily merged down to ``sample_clip`` chunks."""

    def __init__(
        self,
        rows,  # [{"clip_id", "sentences": [...]}]
        frame_source: FrameSource,
        sample_frame: int = 32,
        sample_clip: int = 4,
        input_hw: tuple[int, int] = (192, 320),
        train: bool = False,
        seed: int = 0,
    ):
        self.rows = rows
        self.source = frame_source
        self.sample_frame = sample_frame
        self.sample_clip = sample_clip
        self.input_hw = input_hw
        self.train = train
        self.seed = seed

    def __len__(self) -> int:
        return len(self.rows)

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = np.random.default_rng((self.seed, index))
        row = self.rows[index]
        clip_id = str(row.get("clip_id", row.get("video_id", index)))
        total = self.source.total_frames(clip_id)
        inds = uniform_sample_with_jitter(total, self.sample_frame, rng, not self.train)
        frames = self.source.load(clip_id, inds)
        h, w = self.input_hw
        frames = resize(frames, (int(h * 1.1), int(w * 1.1)))
        frames = random_crop(frames, (h, w), rng) if self.train else center_crop(frames, (h, w))
        pixels = normalize(frames, IMAGENET_MEAN, IMAGENET_STD).transpose(1, 0, 2, 3)
        sentences = merge_sentences_greedy(list(row["sentences"]), self.sample_clip)
        return {"id": index, "video_frames": pixels, "sentences": sentences}
