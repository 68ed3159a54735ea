"""CLIP-ViP retrieval on one device (PyTorch port of
``xpretrain_tpu/cli/run_retrieval_clipvip.py``).

``--mode train`` (the default) fine-tunes with the contrastive loss through
``ClipVipTrainer`` (on the val split when no ``--train_annotation`` is
given, as the JAX runner does), validating at start and every
``--valid_steps``, and writes ``final_report.json``; ``--mode eval`` ranks
text -> video with the model as built and writes ``eval_report.json`` (both
through ``xpretrain_tpu_torch.train.evaluate.evaluate_retrieval``).
``--clip_weights`` / ``--e2e_weights_path`` (a torch CLIP or CLIP-ViP
checkpoint) load over the seeded init before either mode runs.

Usage (synthetic ingest, the MSR-VTT B/32 fine-tune preset, on the card):
    python -m xpretrain_tpu_torch.cli.run_retrieval_clipvip --dummy_data 1 \
        --config xpretrain_tpu_torch/configs/msrvtt_retrieval_vip_base_32.json \
        --device_ingest 1 --device cuda --output_dir output/ft
"""

from __future__ import annotations

import torch

from xpretrain_tpu_torch.cli.shared_args import build_shared_parser
from xpretrain_tpu_torch.config import parse_with_config
from xpretrain_tpu_torch.data.datasets import (
    FrameSource,
    RetrievalCollator,
    SyntheticVideoTextDataset,
    VideoRetrievalDataset,
)
from xpretrain_tpu_torch.data.loader import BatchLoader, InfiniteIterator, SequentialEvalLoader
from xpretrain_tpu_torch.data.tokenization import build_tokenizer, warn_if_hash_with_weights
from xpretrain_tpu_torch.data.transforms import clip_resize_crop_u8, clip_transform
from xpretrain_tpu_torch.models.clip_vip.convert import load_torch_checkpoint, merge_pretrained
from xpretrain_tpu_torch.models.clip_vip.model import CLIPViPModel
from xpretrain_tpu_torch.parallel.train_step import make_eval_step
from xpretrain_tpu_torch.train.checkpoints import save_training_meta
from xpretrain_tpu_torch.train.evaluate import evaluate_retrieval
from xpretrain_tpu_torch.train.trainer import ClipVipTrainer, clip_vip_config_from
from xpretrain_tpu_torch.utils.basic import save_json
from xpretrain_tpu_torch.utils.logging import LOGGER, setup_logging

DUMMY_TRAIN_SIZE = 512  # clips in the synthetic train set (as the JAX runner)
DUMMY_VAL_SIZE = 128  # clips in the synthetic val set (as the JAX runner)


# _TransformedSynthetic and build_tokenizer_from_cfg are the JAX runner's
# helpers (``xpretrain_tpu/cli/run_retrieval_clipvip.py``).
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


def build_loaders(cfg) -> tuple[InfiniteIterator | None, SequentialEvalLoader, int]:
    """(train loader or None, val loader, val clip count), as the JAX runner
    builds them for process 0 of 1."""
    collate = RetrievalCollator(build_tokenizer_from_cfg(cfg), max_txt_len=int(cfg.get("max_txt_len", 70)))
    ingest = bool(cfg.get("device_ingest"))
    if cfg.get("dummy_data"):
        train_ds = _TransformedSynthetic(
            DUMMY_TRAIN_SIZE, cfg.num_frm, cfg.crop_img_size, seed=cfg.seed, device_ingest=ingest
        )
        val_ds = _TransformedSynthetic(
            DUMMY_VAL_SIZE, cfg.num_frm, cfg.crop_img_size, seed=cfg.seed + 1, device_ingest=ingest
        )
    else:
        source = FrameSource(cfg.video_root)
        train_ds = VideoRetrievalDataset(
            cfg.train_annotation, source, cfg.num_frm, cfg.crop_img_size,
            train=True, seed=cfg.seed, device_ingest=ingest,
        ) if cfg.get("train_annotation") else None
        val_ds = VideoRetrievalDataset(
            cfg.val_annotation, source, cfg.num_frm, cfg.crop_img_size,
            train=False, device_ingest=ingest,
        )
    train_loader = None
    if train_ds is not None:
        train_loader = InfiniteIterator(
            BatchLoader(train_ds, cfg.train_batch_size, collate, seed=cfg.seed)
        )
    return train_loader, SequentialEvalLoader(val_ds, cfg.val_batch_size, collate), len(val_ds)


def reroot_data_paths(cfg):
    """Re-root relative data paths under ``--data_mount_dir``, as the JAX
    package's ``cli/shared_args.py:parse_args`` does."""
    if cfg.get("data_mount_dir"):
        for key in ("train_annotation", "val_annotation", "video_root"):
            if cfg.get(key) and not str(cfg[key]).startswith("/"):
                cfg[key] = f"{cfg['data_mount_dir'].rstrip('/')}/{cfg[key]}"
    return cfg


def resolve_device(name: str) -> torch.device:
    device = torch.device(name)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"--device {name} was asked for but torch sees no CUDA device")
    return device


def load_pretrained(cfg, model: CLIPViPModel) -> None:
    """Merge ``--e2e_weights_path`` (or else ``--clip_weights``), a torch CLIP
    / CLIP-ViP checkpoint, into ``model``'s parameters in place
    (``merge_pretrained``: shape-tolerant, a temporal embedding of another
    length interpolated). A trainer's model takes them before the optimizer's
    first step; a checkpoint that ``train()`` resumes from still wins, as in
    JAX."""
    path = cfg.get("e2e_weights_path") or cfg.get("clip_weights")
    if not path:
        return
    warn_if_hash_with_weights(
        cfg.get("tokenizer", "hash"), path, vocab_name="CLIP BPE",
        hint="--tokenizer clip_bpe --tokenizer_vocab <vocab.json> --tokenizer_merges <merges.txt>",
    )
    merge_pretrained(model, load_torch_checkpoint(path))
    LOGGER.info("loaded pretrained weights from %s", path)


def build_model(cfg, device: torch.device) -> CLIPViPModel:
    """The CLIP-ViP model on ``device``: random weights from ``--seed``, then
    the pretrained ones of ``load_pretrained``."""
    model = CLIPViPModel(clip_vip_config_from(cfg), device=device)
    generator = torch.Generator(device=device).manual_seed(int(cfg.seed))
    model.init_weights(generator)
    load_pretrained(cfg, model)
    return model.eval()


def main(argv=None):
    parser = build_shared_parser("CLIP-ViP video retrieval (PyTorch)")
    parser.add_argument("--mode", type=str, default="train", choices=["train", "eval"])
    parser.add_argument("--save_feats", type=str, default="",
                        help="dump eval features to this .npz (ref run_video_retrieval.py:233 save_feat)")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    cfg = reroot_data_paths(parse_with_config(parser, argv))
    setup_logging(cfg.output_dir, 0)
    save_training_meta(cfg.output_dir, cfg)
    device = resolve_device(cfg.device)
    feats_path = cfg.get("save_feats") or None

    train_loader, val_loader, valid_len = build_loaders(cfg)
    if cfg.mode == "eval":
        model = build_model(cfg, device)
        LOGGER.info("eval on %s: %d clips, batch %d", device, valid_len, cfg.val_batch_size)
        report = evaluate_retrieval(
            make_eval_step(device), model, val_loader, valid_len,
            save_feats_path=feats_path,
        )
        save_json(report, f"{cfg.output_dir}/eval_report.json", pretty=True)
        return report
    # without --train_annotation the val split is the train split, as in JAX
    trainer = ClipVipTrainer(cfg, train_loader or val_loader, val_loader, valid_len, device=device)
    load_pretrained(cfg, trainer.model)
    LOGGER.info("train on %s: %d steps, batch %d", device, trainer.num_train_steps, cfg.train_batch_size)
    trainer.train()
    report = trainer.validate(save_feats_path=feats_path)
    save_json(report, f"{cfg.output_dir}/final_report.json", pretty=True)
    return report


if __name__ == "__main__":
    main()
