"""CLIP-ViP zero-shot retrieval eval on one device (PyTorch port).

The ``--mode eval`` path of ``xpretrain_tpu/cli/run_retrieval_clipvip.py``:
build the model, run every val batch through the eval step, rank text ->
video and report R@K (``xpretrain_tpu.train.evaluate.evaluate_retrieval``).
``--mode train`` comes with the training slice.

Usage (synthetic ingest, B/32, on the card):
    python -m xpretrain_tpu_torch.cli.run_retrieval_clipvip --dummy_data 1 \
        --mode eval --clip_size base_32 --device_ingest 1 --device cuda
"""

from __future__ import annotations

import torch

from xpretrain_tpu.cli.shared_args import build_shared_parser
from xpretrain_tpu.config import parse_with_config
from xpretrain_tpu.data.datasets import (
    FrameSource,
    RetrievalCollator,
    SyntheticVideoTextDataset,
    VideoRetrievalDataset,
)
from xpretrain_tpu.data.loader import SequentialEvalLoader
from xpretrain_tpu.data.tokenization import build_tokenizer
from xpretrain_tpu.data.transforms import clip_resize_crop_u8, clip_transform
from xpretrain_tpu.train.evaluate import evaluate_retrieval
from xpretrain_tpu.utils.basic import save_json
from xpretrain_tpu.utils.logging import LOGGER, setup_logging
from xpretrain_tpu_torch.models.clip_vip.model import CLIPViPModel
from xpretrain_tpu_torch.parallel.train_step import make_eval_step
from xpretrain_tpu_torch.train.trainer import clip_vip_config_from

DUMMY_VAL_SIZE = 128  # clips in the synthetic val set (as the JAX runner)


# _TransformedSynthetic and build_tokenizer_from_cfg restate the JAX runner's
# helpers: that module imports jax at its top.
class _TransformedSynthetic:
    def __init__(self, size, num_frames, image_size, seed=0, device_ingest=False):
        self.ds = SyntheticVideoTextDataset(size, num_frames, image_size, seed)
        self.device_ingest = device_ingest

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        item = self.ds[i]
        if self.device_ingest:
            item["video"] = clip_resize_crop_u8(item["frames"], self.ds.image_size)
        else:
            item["video"] = clip_transform(item["frames"], self.ds.image_size)
        return item


def build_tokenizer_from_cfg(cfg):
    kind = cfg.get("tokenizer", "hash")
    kwargs = {}
    if kind == "clip_bpe":
        kwargs = dict(vocab_path=cfg["tokenizer_vocab"], merges_path=cfg.get("tokenizer_merges") or None)
    elif kind == "wordpiece":
        kwargs = dict(vocab_path=cfg["tokenizer_vocab"])
    return build_tokenizer(kind, **kwargs)


def build_val_loader(cfg) -> tuple[SequentialEvalLoader, int]:
    collate = RetrievalCollator(build_tokenizer_from_cfg(cfg), max_txt_len=int(cfg.get("max_txt_len", 70)))
    ingest = bool(cfg.get("device_ingest"))
    if cfg.get("dummy_data"):
        val_ds = _TransformedSynthetic(
            DUMMY_VAL_SIZE, cfg.num_frm, cfg.crop_img_size, seed=cfg.seed + 1, device_ingest=ingest
        )
    else:
        val_ds = VideoRetrievalDataset(
            cfg.val_annotation, FrameSource(cfg.video_root), cfg.num_frm, cfg.crop_img_size,
            train=False, device_ingest=ingest,
        )
    return SequentialEvalLoader(val_ds, cfg.val_batch_size, collate), len(val_ds)


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} was asked for but torch sees no CUDA device")
    return device


def build_model(cfg, device: torch.device) -> CLIPViPModel:
    """The CLIP-ViP model on ``device``, random weights from ``--seed``."""
    if cfg.get("clip_weights") or cfg.get("e2e_weights_path"):
        raise NotImplementedError(
            "loading torch CLIP checkpoints into the port comes later (ROADMAP Queue 1)"
        )
    model = CLIPViPModel(clip_vip_config_from(cfg), device=device)
    generator = torch.Generator(device=device).manual_seed(int(cfg.seed))
    return model.init_weights(generator).eval()


def _without_ids(loader):
    # evaluate_retrieval gathers "ids" through JAX (_host_rows); the port is
    # one process, so the clip ids add nothing and stay on the host
    for batch in loader:
        batch.pop("ids", None)
        yield batch


def main(argv=None):
    parser = build_shared_parser("CLIP-ViP video retrieval (PyTorch)")
    parser.add_argument("--mode", type=str, default="eval", choices=["train", "eval"])
    parser.add_argument("--save_feats", type=str, default="",
                        help="dump eval features to this .npz (ref run_video_retrieval.py:233 save_feat)")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    # shared_args.parse_args would start JAX's distributed runtime
    cfg = parse_with_config(parser, argv)
    if cfg.get("data_mount_dir"):
        for key in ("val_annotation", "video_root"):
            if cfg.get(key) and not str(cfg[key]).startswith("/"):
                cfg[key] = f"{cfg['data_mount_dir'].rstrip('/')}/{cfg[key]}"
    if cfg.mode == "train":
        raise NotImplementedError("--mode train comes with the training slice (ROADMAP Queue 1)")
    setup_logging(cfg.output_dir, 0)
    device = resolve_device(cfg.device)

    val_loader, valid_len = build_val_loader(cfg)
    model = build_model(cfg, device)
    LOGGER.info("eval on %s: %d clips, batch %d", device, valid_len, cfg.val_batch_size)
    report = evaluate_retrieval(
        make_eval_step(device), model, _without_ids(val_loader), valid_len,
        save_feats_path=cfg.get("save_feats") or None,
    )
    save_json(report, f"{cfg.output_dir}/eval_report.json", pretty=True)
    return report


if __name__ == "__main__":
    main()
