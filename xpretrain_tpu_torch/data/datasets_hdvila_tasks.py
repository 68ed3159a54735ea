"""HD-VILA downstream-task datasets: retrieval, QA, multiple-choice (the
port's copy of ``xpretrain_tpu/data/datasets_hdvila_tasks.py``).

Capability parity with ``hd-vila/src/datasets/dataset_video_retrieval.py:30-256``,
``dataset_video_qa.py:19-298`` (incl. TGIF-QA's action/transition
multiple-choice vs frameqa classification modes) and
``dataset_video_mc.py:20-247`` (MSR-VTT-MC 5-option eval). All reuse the
hybrid high/low-res clip loading of the pretrain dataset; low-res sources
get their middle frame cv2-upscaled ×4 (ref ``dataset_video_retrieval.py:93-143``).

As in ``datasets_hdvila.py``, frames stay uint8 and the encoder normalizes
them on the device, once.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from xpretrain_tpu_torch.data.datasets import FrameSource
from xpretrain_tpu_torch.data.sample_frames import spread_center_neighbor_sample
from xpretrain_tpu_torch.data.transforms import hybrid_res_transform, resize
from xpretrain_tpu_torch.utils.basic import load_json, load_jsonl
from xpretrain_tpu_torch.utils.logging import LOGGER


def _load_rows(path: str):
    return load_jsonl(path) if path.endswith("l") else load_json(path)


class HdVilaClipLoader:
    """Shared hybrid-res clip loading for the task datasets."""

    def __init__(
        self,
        frame_source: FrameSource | None,
        n_clips: int = 2,
        num_frm: int = 7,
        sample_rate: int = 12,
        crop_hw: tuple[int, int] = (640, 1024),
        low_res_source: bool = False,
        synthetic_seed: int | None = None,
    ):
        self.source = frame_source
        self.n_clips = n_clips
        self.num_frm = num_frm
        self.sample_rate = sample_rate
        self.crop_hw = crop_hw
        self.low_res_source = low_res_source
        self.synthetic_seed = synthetic_seed

    def load(self, clip_id: str, rng, train: bool) -> tuple[np.ndarray, np.ndarray]:
        """-> (img_middle [n_clips, 3, H, W], img_other [n_clips, T-1, 3, H/4, W/4]).

        The n_clips windows are spread over the video: random middles at
        train time, an even stride at eval — so ``inference_n_clips`` covers
        the whole video, the precondition for the reference's multi-clip
        score aggregation (``dataset_video_qa.py:79-100``).
        """
        if self.synthetic_seed is not None:
            h, w = self.crop_hw
            index_lists = [None] * self.n_clips
        else:
            total = self.source.total_frames(clip_id)
            index_lists = spread_center_neighbor_sample(
                total, self.n_clips, self.num_frm, self.sample_rate, rng,
                test_mode=not train,
            )
        middles, others = [], []
        for ci, inds in enumerate(index_lists):
            if self.synthetic_seed is not None:
                sr = np.random.default_rng(
                    (self.synthetic_seed, hash(clip_id) % (2**31), ci)
                )
                frames = sr.integers(0, 256, (self.num_frm, h, w, 3), dtype=np.uint8)
            else:
                frames = self.source.load(clip_id, inds)
                if self.low_res_source:
                    # low-res source: upscale x4 so the middle frame is
                    # "high-res" relative to neighbors (ref :93-143)
                    frames = resize(
                        frames, (frames.shape[1] * 4, frames.shape[2] * 4), "bicubic"
                    )
            mid, oth = hybrid_res_transform(
                frames, self.num_frm // 2, self.crop_hw, train=train, rng=rng
            )
            middles.append(mid[0])
            others.append(oth)
        return np.stack(middles), np.stack(others)


class HdVilaRetrievalDataset:
    """Video-text retrieval rows {"clip_id", "text"}."""

    def __init__(self, annotation_path, clip_loader: HdVilaClipLoader, train=False,
                 seed=0, max_retries=10, rows=None):
        self.rows = rows if rows is not None else _load_rows(annotation_path)
        self.loader = clip_loader
        self.train = train
        self.seed = seed
        self.max_retries = max_retries
        self.epoch = 0

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = np.random.default_rng((self.seed, self.epoch, index))
        for _ in range(self.max_retries):
            row = self.rows[index]
            clip_id = str(row.get("clip_id", row.get("video_id", index)))
            try:
                middle, other = self.loader.load(clip_id, rng, self.train)
                text = row.get("text", row.get("caption", ""))
                if isinstance(text, (list, tuple)):
                    text = " ".join(text)
                return {"id": index, "img_middle": middle, "img_other": other, "text": text}
            except Exception as e:  # noqa: BLE001
                LOGGER.warning("hdvila retrieval: %s failed (%s)", clip_id, e)
                index = int(rng.integers(0, len(self.rows)))
        raise RuntimeError("retry budget exceeded")


class HdVilaQADataset:
    """Video QA rows {"clip_id", "question", "answer"(, "options", "label")}.

    ``task_type``: "frameqa"/"open" -> classification over an answer vocab;
    "action"/"transition"/"mc" -> multiple choice over ``options``.
    """

    def __init__(
        self,
        annotation_path,
        clip_loader: HdVilaClipLoader,
        task_type: str = "open",
        answer_vocab: dict[str, int] | None = None,
        train=False,
        seed=0,
        rows=None,
    ):
        self.rows = rows if rows is not None else _load_rows(annotation_path)
        self.loader = clip_loader
        self.task_type = task_type
        self.answer_vocab = answer_vocab or {}
        self.train = train
        self.seed = seed
        self.epoch = 0

    def __len__(self):
        return len(self.rows)

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = np.random.default_rng((self.seed, self.epoch, index))
        row = self.rows[index]
        clip_id = str(row.get("clip_id", row.get("video_id", index)))
        middle, other = self.loader.load(clip_id, rng, self.train)
        item: dict[str, Any] = {
            "id": index,
            "img_middle": middle,
            "img_other": other,
            "question": row.get("question", ""),
        }
        if self.task_type in ("action", "transition", "mc"):
            item["options"] = [f"{item['question']} {opt}" for opt in row["options"]]
            item["label"] = int(row.get("label", row.get("answer", 0)))
        elif self.task_type == "count":
            # TGIF count: the answer IS the integer count (ref
            # dataset_video_qa.py open_ended handling + mse eval)
            item["label"] = int(row.get("answer", row.get("label", 1)))
        elif "label" in row:  # pre-resolved integer label (synthetic fixtures,
            # pre-mapped annotation dumps)
            item["label"] = int(row["label"])
        else:
            # unknown answers stay -1: never equal to an argmax prediction, so
            # they count as wrong at eval (the reference filters them upstream)
            answer = str(row.get("answer", ""))
            item["label"] = int(self.answer_vocab.get(answer, -1))
        return item


class HdVilaQACollator:
    """Batch QA items: classification -> [B, L]; MC -> [B, n_choice, L]."""

    def __init__(self, tokenizer, max_txt_len: int = 40, multiple_choice: bool = False):
        self.tokenizer = tokenizer
        self.max_txt_len = max_txt_len
        self.multiple_choice = multiple_choice

    def __call__(self, items: Sequence[dict]) -> dict[str, np.ndarray]:
        batch = {
            "img_middle": np.stack([it["img_middle"] for it in items]),  # uint8
            "img_other": np.stack([it["img_other"] for it in items]),
            "labels": np.asarray([it["label"] for it in items], np.int64),
            "ids": np.asarray([it["id"] for it in items], np.int64),
        }
        if self.multiple_choice:
            n_choice = len(items[0]["options"])
            flat = [opt for it in items for opt in it["options"]]
            ids, mask = self.tokenizer(flat, self.max_txt_len)
            batch["text_input_ids"] = ids.reshape(len(items), n_choice, -1)
            batch["text_input_mask"] = mask.reshape(len(items), n_choice, -1)
        else:
            ids, mask = self.tokenizer([it["question"] for it in items], self.max_txt_len)
            batch["text_input_ids"] = ids
            batch["text_input_mask"] = mask
        return batch
