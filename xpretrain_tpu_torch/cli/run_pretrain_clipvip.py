"""CLIP-ViP pretraining on one device (PyTorch port of
``xpretrain_tpu/cli/run_pretrain_clipvip.py``).

The runner surface of ``CLIP-ViP/src/pretrain/run_pretrain.py:202-445``:
video-subtitle pairs plus the auxiliary image/caption branch, trained
through ``ClipVipTrainer`` on the ``NCELearnableTempLoss_vsc_fc`` loss,
with ``MetaLoader`` multi-source mixing (``--train_ratio``) and, on real
data, periodic retrieval validation. ``--clip_weights`` /
``--e2e_weights_path`` start it from a torch CLIP or CLIP-ViP checkpoint.

- The loss default is the documented one, ``NCELearnableTempLoss_vsc_fc``;
  an explicit ``--loss_name`` or a config's ``loss_name`` wins. (The JAX
  runner means the same, but its shared parser's default always fills the
  key first, so without a config it trains on the pair loss, which never
  reads the image and caption features.)
- The synthetic path ships fp32 video and images (``PretrainCollator``):
  pretraining does not take the uint8 device ingest.

Usage (synthetic data, the B/32 pretraining preset, on the card):
    python -m xpretrain_tpu_torch.cli.run_pretrain_clipvip --dummy_data 1 \\
        --config xpretrain_tpu_torch/configs/pretrain_vip_base_32.json \\
        --clip_weights clip_b32.pt --num_train_steps 10 --output_dir output/pretrain_vip
"""

from __future__ import annotations

from xpretrain_tpu_torch.cli.run_retrieval_clipvip import (
    build_loaders,
    build_tokenizer_from_cfg,
    load_pretrained,
    reroot_data_paths,
    resolve_device,
)
from xpretrain_tpu_torch.cli.shared_args import build_shared_parser
from xpretrain_tpu_torch.config import parse_with_config
from xpretrain_tpu_torch.data.datasets import PretrainCollator, SyntheticVideoTextDataset
from xpretrain_tpu_torch.data.loader import BatchLoader, InfiniteIterator, MetaLoader
from xpretrain_tpu_torch.data.transforms import clip_transform
from xpretrain_tpu_torch.train.checkpoints import save_training_meta
from xpretrain_tpu_torch.train.trainer import ClipVipTrainer
from xpretrain_tpu_torch.utils.basic import save_json
from xpretrain_tpu_torch.utils.logging import LOGGER, setup_logging

DUMMY_SIZE = 2048  # synthetic pretraining items (as the JAX runner)
DEFAULT_LOSS = "NCELearnableTempLoss_vsc_fc"


class _SyntheticPretrain:
    """Synthetic pretrain items incl. the image/caption auxiliary branch
    (the JAX runner's ``_SyntheticPretrain``)."""

    def __init__(self, size, num_frames, image_size, seed=0):
        self.ds = SyntheticVideoTextDataset(size, num_frames, image_size, seed, with_image_branch=True)
        self.image_size = image_size

    def __len__(self):
        return len(self.ds)

    def __getitem__(self, i):
        item = self.ds[i]
        item["video"] = clip_transform(item["frames"], self.image_size)
        item["image"] = clip_transform(item["image"], self.image_size)
        return item


def build_train_loader(cfg) -> MetaLoader:
    """The synthetic source behind a ``MetaLoader``, as the JAX runner builds
    it for process 0 of 1."""
    collate = PretrainCollator(build_tokenizer_from_cfg(cfg), max_txt_len=int(cfg.get("max_txt_len", 70)))
    ds = _SyntheticPretrain(DUMMY_SIZE, cfg.num_frm, cfg.crop_img_size, seed=cfg.seed)
    loader = InfiniteIterator(BatchLoader(ds, cfg.train_batch_size, collate, seed=cfg.seed))
    return MetaLoader({"synthetic": (loader, 1)}, seed=cfg.seed)


def build_parser():
    """The shared flags, ``--train_ratio``, ``--device``, and the documented
    loss default (a flag or a config's ``loss_name`` wins over it)."""
    parser = build_shared_parser("CLIP-ViP pretraining (PyTorch)")
    parser.add_argument("--train_ratio", type=int, nargs="*", default=[1])
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    parser.set_defaults(loss_name=DEFAULT_LOSS)
    return parser


def main(argv=None):
    cfg = reroot_data_paths(parse_with_config(build_parser(), argv))
    setup_logging(cfg.output_dir, 0)
    save_training_meta(cfg.output_dir, cfg)
    device = resolve_device(cfg.device)

    if cfg.get("dummy_data"):
        train_loader, val_loader, valid_len = build_train_loader(cfg), None, None
    else:
        # real data: pretrain annotations through the retrieval loaders
        train_loader, val_loader, valid_len = build_loaders(cfg)
    trainer = ClipVipTrainer(cfg, train_loader, val_loader, valid_len, device=device)
    load_pretrained(cfg, trainer.model)
    LOGGER.info("CLIP-ViP pretraining on %s: %d steps at batch %d, loss %s", device, trainer.num_train_steps,
                cfg.train_batch_size, cfg.loss_name)
    state = trainer.train()
    if val_loader is not None:
        save_json(trainer.validate(), f"{cfg.output_dir}/final_report.json", pretty=True)
    return state


if __name__ == "__main__":
    main()
