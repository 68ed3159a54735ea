"""HD-VILA datasets: hybrid high/low-res clips + ITM/MLM collation (the port's
copy of ``xpretrain_tpu/data/datasets_hdvila.py``).

Capability parity with ``hd-vila/src/datasets/dataset_pretrain.py:18-269``:
center-frame neighborhoods sampled per clip (middle full-res, neighbors
×4-downsampled), ITM negative swapping, MLM masking; plus the retrieval/QA
dataset shapes (``dataset_video_retrieval.py``, ``dataset_video_qa.py``,
``dataset_video_mc.py``) over the same hybrid loading. The
``reliable_idx_list`` corrupt-video fallback becomes the retry-with-
replacement loop shared with :class:`~xpretrain_tpu_torch.data.datasets.VideoRetrievalDataset`.

Frames stay uint8 to the device: ``hybrid_res_transform`` does no
normalization here and the collator stacks uint8, so ``HdVilaEncoder.normalize``
is the one normalization on the path (the JAX copy ships fp32 frames that it
has already normalized, and its encoder normalizes them again: ROADMAP
Queue 3). The ids, masks, MLM and ITM labels are the JAX copy's.
"""

from __future__ import annotations

from typing import Any, Sequence

import numpy as np

from xpretrain_tpu_torch.data.datasets import FrameSource, synthetic_caption
from xpretrain_tpu_torch.data.sample_frames import center_neighbor_sample
from xpretrain_tpu_torch.data.tokenization import mask_batch_text_tokens
from xpretrain_tpu_torch.data.transforms import hybrid_res_transform
from xpretrain_tpu_torch.utils.basic import load_json, load_jsonl
from xpretrain_tpu_torch.utils.logging import LOGGER


class HdVilaPretrainDataset:
    """Hybrid-res pretrain items: per clip one full-res middle + low-res
    neighbors (ref ``dataset_pretrain.py:66-144``)."""

    def __init__(
        self,
        annotation_path: str | None,
        frame_source: FrameSource | None,
        train_n_clips: int = 2,
        num_frm: int = 7,
        sample_rate: int = 12,
        crop_hw: tuple[int, int] = (640, 1024),
        train: bool = True,
        seed: int = 0,
        max_retries: int = 10,
        synthetic_size: int = 0,
    ):
        self.synthetic = synthetic_size > 0
        if self.synthetic:
            self.rows = [{"clip_id": str(i)} for i in range(synthetic_size)]
        else:
            self.rows = (
                load_jsonl(annotation_path)
                if annotation_path.endswith("l")
                else load_json(annotation_path)
            )
        self.source = frame_source
        self.train_n_clips = train_n_clips
        self.num_frm = num_frm
        self.sample_rate = sample_rate
        self.crop_hw = crop_hw
        self.train = train
        self.seed = seed
        self.max_retries = max_retries
        self.epoch = 0

    def __len__(self) -> int:
        return len(self.rows)

    def _load_clip_frames(self, clip_id: str, rng) -> np.ndarray:
        if self.synthetic:
            h, w = self.crop_hw
            sr = np.random.default_rng((self.seed, int(clip_id)))
            return sr.integers(0, 256, size=(self.num_frm, h, w, 3), dtype=np.uint8)
        total = self.source.total_frames(clip_id)
        inds, _ = center_neighbor_sample(
            total, self.num_frm, self.sample_rate, rng, test_mode=not self.train
        )
        return self.source.load(clip_id, inds)

    def __getitem__(self, index: int) -> dict[str, Any]:
        rng = np.random.default_rng((self.seed, self.epoch, index))
        for _attempt in range(self.max_retries):
            row = self.rows[index]
            clip_id = str(row.get("clip_id", row.get("video_id", index)))
            try:
                middles, others = [], []
                for _clip in range(self.train_n_clips):
                    frames = self._load_clip_frames(clip_id, rng)
                    mid, oth = hybrid_res_transform(
                        frames, self.num_frm // 2, self.crop_hw, train=self.train, rng=rng
                    )
                    middles.append(mid[0])
                    others.append(oth)
                text = row.get("text", row.get("caption")) or synthetic_caption(rng)
                if isinstance(text, (list, tuple)):
                    text = " ".join(text)
                return {
                    "id": index,
                    "img_middle": np.stack(middles),  # [clips, 3, H, W]
                    "img_other": np.stack(others),  # [clips, F-1, 3, H/4, W/4]
                    "text": text,
                }
            except Exception as e:  # noqa: BLE001
                LOGGER.warning("hdvila: failed %s (%s); replacement retry", clip_id, e)
                index = int(rng.integers(0, len(self.rows)))
        raise RuntimeError("exceeded retry budget loading hd-vila data")


class HdVilaPretrainCollator:
    """Tokenize + MLM + ITM negative swapping
    (ref ``dataset_pretrain.py:183-269``)."""

    def __init__(
        self,
        tokenizer,
        max_txt_len: int = 50,
        mlm: bool = True,
        itm: bool = True,
        itm_neg_prob: float = 0.5,
        seed: int = 0,
    ):
        self.tokenizer = tokenizer
        self.max_txt_len = max_txt_len
        self.mlm = mlm
        self.itm = itm
        self.itm_neg_prob = itm_neg_prob
        self.rng = np.random.default_rng(seed)

    def __call__(self, items: Sequence[dict]) -> dict[str, np.ndarray]:
        texts = [it["text"] for it in items]
        n = len(items)
        itm_labels = np.ones(n, np.int64)
        if self.itm and n > 1:
            # swap some samples' text with another sample's (negative pairs)
            for i in range(n):
                if self.rng.random() < self.itm_neg_prob:
                    j = int(self.rng.integers(0, n - 1))
                    j = j if j < i else j + 1
                    texts[i] = items[j]["text"]
                    itm_labels[i] = 0
        ids, mask = self.tokenizer(texts, self.max_txt_len)
        batch = {
            "img_middle": np.stack([it["img_middle"] for it in items]),  # uint8
            "img_other": np.stack([it["img_other"] for it in items]),
            "text_input_ids": ids,
            "text_input_mask": mask,
        }
        if self.itm:
            batch["itm_labels"] = itm_labels
        if self.mlm:
            masked, labels = mask_batch_text_tokens(
                ids,
                getattr(self.tokenizer, "mask_id", 1),
                getattr(self.tokenizer, "vocab_size", 30522),
                self.rng,
                special_ids=(0,),
            )
            batch["text_input_ids"] = masked
            batch["mlm_labels"] = labels
        return batch
