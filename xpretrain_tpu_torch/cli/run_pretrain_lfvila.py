"""LF-VILA pretraining runner, stages 1 and 2, on one device or on each rank
of a torchrun data-parallel group (PyTorch port of
``xpretrain_tpu/cli/run_pretrain_lfvila.py``).

The runner surface of ``LF-VILA/src/run_pretrain.py:21-121`` +
``src/tools/trainer_pretrain.py``: a YAML/JSON config, the two-stage model
(random weights from ``--seed``, then the WEIGHTS cascade below), global
InfoNCE + MTC (stage 1) or MLM + VTM over the fusion tower with the stage-1
modules frozen by the config's ``frozen_patterns`` (stage 2), trained
through ``GenericTrainer``.

- The WEIGHTS cascade (``load_lfvila_cascade``): ``--model_weight`` (a full
  LF-VILA checkpoint) | ``--stage1_model_weight`` (after ``--bert_weight``)
  | ``--swin_weight`` (a 2-D ImageNet Swin inflated to the model's 3-D
  windows with ``--pretrained_2d 1``, the default) and ``--bert_weight``,
  merged shape-tolerantly over the seeded init before the first step.

- ``device_ingest`` defaults to 1 here: the host ships raw uint8 [N, H, W, 3]
  frames and ``PatchEmbed3D`` normalizes them on the device. (The JAX runner
  means the same default, ``cfg.get("device_ingest", 1)``, but its shared
  parser's default of 0 always fills the key first.)
- Stage 2's collator masks tokens for MLM.
- The window kernel is not on this path: JAX never trains through it, and
  the kernel has no backward (the model raises on a gradient through it).

Usage (synthetic data, on the card; PyYAML is needed for a .yaml config, the
port's .json copies work without):
    python -m xpretrain_tpu_torch.cli.run_pretrain_lfvila \\
        --config xpretrain_tpu_torch/configs/lfvila_pretrain_stage1.json \\
        --dummy_data 1 --num_train_steps 10 --output_dir output/lfvila_stage1
"""

from __future__ import annotations

import torch

from xpretrain_tpu_torch.cli.run_retrieval_clipvip import resolve_device
from xpretrain_tpu_torch.cli.shared_args import build_shared_parser, parse_args
from xpretrain_tpu_torch.data.datasets import FrameSource
from xpretrain_tpu_torch.data.datasets_lfvila import LfVilaPretrainCollator, LfVilaPretrainDataset
from xpretrain_tpu_torch.data.loader import BatchLoader, InfiniteIterator
from xpretrain_tpu_torch.data.tokenization import build_model_tokenizer, warn_if_hash_with_weights
from xpretrain_tpu_torch.models.bert import BertConfig
from xpretrain_tpu_torch.models.lf_vila.convert import flax_param_paths
from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaConfig, LfVilaPretrain
from xpretrain_tpu_torch.models.lf_vila.swin3d import Swin3DConfig
from xpretrain_tpu_torch.models.pretrained import load_lfvila_cascade
from xpretrain_tpu_torch.optim.optimizer import NO_DECAY_LFVILA
from xpretrain_tpu_torch.parallel.mesh import is_main_process, process_index_count, process_rank
from xpretrain_tpu_torch.train.checkpoints import save_training_meta
from xpretrain_tpu_torch.train.generic_trainer import GenericTrainer
from xpretrain_tpu_torch.utils.basic import load_jsonl
from xpretrain_tpu_torch.utils.logging import LOGGER, setup_logging

DUMMY_SIZE = 1024  # synthetic long-form samples (as the JAX runner)
WEIGHT_FLAGS = ("model_weight", "stage1_model_weight", "swin_weight", "bert_weight")
METRIC_KEYS = ("ct_global_loss", "ct_time_loss", "mlm_loss", "vtm_loss", "mlm_acc", "vtm_acc")


def lfvila_config_from(cfg) -> LfVilaConfig:
    """The model config of a training config
    (``xpretrain_tpu/cli/run_pretrain_lfvila.py:lfvila_config_from``).

    For a config without them it builds the JAX config; it also reads
    ``video_encoder.use_pallas_attention`` and ``video_encoder.pallas_min_window``
    (defaults False and 240, as ``Swin3DConfig``), which the JAX builder leaves
    at their defaults. ``gradient_checkpointing`` and ``remat_policy`` become
    Swin3D's ``remat`` and ``remat_policy``; ``--cp > 1`` carries through, and
    the model raises on it."""
    ve = cfg.get("video_encoder", {})
    cp = int(cfg.get("cp", 1) or 1)
    dtype = torch.bfloat16 if cfg.get("bf16", True) else torch.float32
    video = Swin3DConfig(
        context_parallel_axis="model" if cp > 1 else None,
        patch_size=tuple(ve.get("patch_size", (1, 8, 8))),
        embed_dim=int(ve.get("embed_dim", 128)),
        depths=tuple(ve.get("depths", (2, 2, 14, 2, 2, 2))),
        num_heads=tuple(ve.get("num_heads", (4, 8, 16, 16, 16, 32))),
        stages=tuple(ve.get("stages", (0, 1, 2, 2, 2, 3))),
        downsample_stages=tuple(ve.get("downsample_stages", (0, 1, 4))),
        window_size=tuple(tuple(w) for w in ve.get(
            "window_size", ((2, 3, 5), (4, 3, 5), (8, 3, 5), (16, 3, 5), (16, 3, 5), (32, 3, 5)))),
        local_window=int(ve.get("local_window", 4)),
        temporal_no_shifting=bool(ve.get("temporal_no_shifting", True)),
        dtype=dtype,
        remat=bool(cfg.get("gradient_checkpointing", False)),
        remat_policy=cfg.get("remat_policy") or None,
        group_windows=bool(ve.get("group_windows", True)),
        use_pallas_attention=bool(ve.get("use_pallas_attention", False)),
        pallas_min_window=int(ve.get("pallas_min_window", 240)),
    )
    bert_kw = dict(
        stage_bounds=(int(cfg.get("num_local_layers", 8)), int(cfg.get("stage1_layers", 12))),
        type_vocab_size=int(cfg.get("type_vocab_size", 8)),
        attention_window=int(cfg.get("attention_window", 0)),
    )
    kind = cfg.get("bert", "large")
    if kind == "large":
        bert = BertConfig.bert_large(**bert_kw)
    elif kind == "base":
        bert = BertConfig.bert_base(**bert_kw)
    else:  # tiny debug: hidden must match the Swin num_features for fusion
        hidden = int(video.embed_dim * 2 ** video.stages[-1])
        bert = BertConfig(
            hidden_size=hidden,
            num_hidden_layers=6,
            num_attention_heads=4,
            intermediate_size=2 * hidden,
            vocab_size=49408,
            **bert_kw,
        )
    tr = cfg.get("training", {})
    return LfVilaConfig(
        video=video,
        bert=bert,
        stage=int(cfg.get("stage", 1)),
        sample_clip=int(cfg.get("sample_clip", 4)),
        sample_frame=int(cfg.get("sample_frame", 32)),
        final_num_patches=int(cfg.get("final_num_patches", 6)),
        temp=float(tr.get("temp", 0.05)),
        time_temp=float(tr.get("time_temp", 0.05)),
        num_key=int(tr.get("num_key", 2)),
        num_value=int(tr.get("num_value", 2)),
        num_other_neg=int(tr.get("num_other_neg", 3)),
        use_time_match=bool(tr.get("use_time_match", True)),
        ct_global_loss_weight=float(tr.get("ct_global_loss_weight", 1.0)),
        ct_time_loss_weight=float(tr.get("ct_time_loss_weight", 1.0)),
        mlm_loss_weight=float(cfg.get("mlm_loss_weight", 1.0)),
        vtm_loss_weight=float(cfg.get("vtm_loss_weight", 10.0)),
        dtype=dtype,
    )


def build_loader(cfg, tokenizer, stage: int) -> InfiniteIterator:
    """The train loader of a stage, as the JAX runner builds it for process
    0 of 1 (stage 2's collator masks tokens for MLM)."""
    collate = LfVilaPretrainCollator(tokenizer, max_sent_len=int(cfg.get("max_txt_len", 50)), mlm=stage == 2)
    device_ingest = bool(cfg.get("device_ingest", 1))
    if cfg.get("dummy_data"):
        ds = LfVilaPretrainDataset([{} for _ in range(DUMMY_SIZE)], None, cfg.sample_frame, cfg.sample_clip,
                                   tuple(cfg.input_hw), synthetic=True, seed=cfg.seed, device_ingest=device_ingest)
    else:
        ds = LfVilaPretrainDataset(load_jsonl(cfg.train_annotation), FrameSource(cfg.video_root), cfg.sample_frame,
                                   cfg.sample_clip, tuple(cfg.input_hw), seed=cfg.seed, device_ingest=device_ingest)
    pi, pc = process_index_count()
    return InfiniteIterator(BatchLoader(ds, cfg.train_batch_size, collate, seed=cfg.seed, process_index=pi,
                                        process_count=pc))


def load_weights(cfg, model, swin_config: Swin3DConfig) -> None:
    """The WEIGHTS cascade of the config's weight flags into ``model``, in
    place (nothing without them)."""
    paths = [cfg.get(k) for k in WEIGHT_FLAGS if cfg.get(k)]
    if not paths:
        return
    warn_if_hash_with_weights(cfg.get("tokenizer", "hash"), paths[0])
    load_lfvila_cascade(
        model,
        model_weight=cfg.get("model_weight", ""),
        stage1_model_weight=cfg.get("stage1_model_weight", ""),
        swin_weight=cfg.get("swin_weight", ""),
        bert_weight=cfg.get("bert_weight", ""),
        pretrained_2d=bool(cfg.get("pretrained_2d", 1)),
        swin_config=swin_config,
    )


def main(argv=None):
    parser = build_shared_parser("LF-VILA pretraining (PyTorch)")
    parser.add_argument("--stage", type=int, default=1, choices=[1, 2])
    parser.add_argument("--sample_frame", type=int, default=32)
    parser.add_argument("--sample_clip", type=int, default=4)
    parser.add_argument("--input_hw", type=int, nargs=2, default=[192, 320])
    # the reference's WEIGHTS cascade (LF-VILA/src/run_pretrain.py:52-77)
    parser.add_argument("--model_weight", type=str, default="",
                        help="full LFVILA torch checkpoint (converted+merged)")
    parser.add_argument("--stage1_model_weight", type=str, default="")
    parser.add_argument("--swin_weight", type=str, default="",
                        help="Swin torch checkpoint; 2-D inflated when --pretrained_2d")
    parser.add_argument("--bert_weight", type=str, default="")
    parser.add_argument("--pretrained_2d", type=int, default=1)
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    parser.set_defaults(device_ingest=1)
    cfg = parse_args(parser, argv)
    setup_logging(cfg.output_dir, process_rank())
    if is_main_process():
        save_training_meta(cfg.output_dir, cfg)
    device = resolve_device(cfg.device)

    model_cfg = lfvila_config_from(cfg)
    tokenizer = build_model_tokenizer(cfg.get("tokenizer", "hash"), model_cfg.bert.vocab_size)
    loader = build_loader(cfg, tokenizer, model_cfg.stage)
    model = LfVilaPretrain(model_cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(int(cfg.seed)))
    load_weights(cfg, model, model_cfg.video)

    def apply_fn(m, batch, generator):
        # stage 1 draws the MTC clips from the step's generator (JAX: its rng)
        labels = batch["mlm_labels"] if model_cfg.stage == 2 else None
        return m(batch["video_frames"], batch["text_ids"], batch["attention_mask"], mlm_labels=labels,
                 generator=generator)

    trainer = GenericTrainer(
        cfg, model, apply_fn, loader, metric_keys=METRIC_KEYS,
        no_decay_patterns=NO_DECAY_LFVILA, param_paths=flax_param_paths(model), device=device,
    )
    LOGGER.info("LF-VILA stage %d pretraining on %s: %d steps at batch %d", model_cfg.stage, device,
                trainer.num_train_steps, cfg.train_batch_size)
    return trainer.train()


if __name__ == "__main__":
    main()
