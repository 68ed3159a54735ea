"""Shared CLI flag surface for the port's runners (the port's copy of
``xpretrain_tpu/cli/shared_args.py:build_shared_parser``).

Mirrors the reference's ``SharedConfigs`` argparse block
(``CLIP-ViP/src/configs/config.py:33-254``) with the "explicit CLI flag wins
over --config JSON" merge semantics and 0/1->bool coercion
(``xpretrain_tpu_torch/config.py:parse_with_config``); fp16/amp flags become
bf16. The flags, defaults and choices are the JAX package's, so one config
file parses the same in both; flags whose feature is not ported are read by
the trainers, which raise on them. :func:`parse_args` is every runner's
entry: it parses, re-roots the data paths and joins the data-parallel group
that the environment describes (``torchrun``'s variables,
``parallel/mesh.py``) and forms the ``(data, model)`` mesh of ``--tp`` /
``--cp`` before any model touches the device."""

from __future__ import annotations

import argparse
from typing import Sequence

from xpretrain_tpu_torch.config import ConfigDict, parse_with_config
from xpretrain_tpu_torch.parallel.mesh import maybe_init_distributed, mesh_from_config


def build_shared_parser(desc: str = "xpretrain_tpu_torch runner") -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=desc)
    p.add_argument("--config", type=str, default=None, help="JSON/YAML config path")
    p.add_argument("--debug", type=int, default=0)
    p.add_argument("--seed", type=int, default=42)
    p.add_argument("--output_dir", type=str, default="output")
    p.add_argument("--data_mount_dir", type=str, default="", help="re-root data paths here")

    # data
    p.add_argument("--train_annotation", type=str, default="")
    p.add_argument("--val_annotation", type=str, default="")
    p.add_argument("--video_root", type=str, default="")
    p.add_argument("--dummy_data", type=int, default=0, help="synthetic ingest path")
    p.add_argument("--num_frm", type=int, default=12)
    p.add_argument("--sample_rate", type=int, default=0)
    p.add_argument("--crop_img_size", type=int, default=224)
    p.add_argument("--max_txt_len", type=int, default=70)
    p.add_argument("--train_batch_size", type=int, default=32)
    p.add_argument("--val_batch_size", type=int, default=32)
    p.add_argument("--device_ingest", type=int, default=0,
                   help="upload raw uint8 frames; normalize folds into the patch gemm")
    p.add_argument("--tokenizer", type=str, default="hash", help="hash|clip_bpe|wordpiece")
    p.add_argument("--tokenizer_vocab", type=str, default="")
    p.add_argument("--tokenizer_merges", type=str, default="")

    # optimization
    p.add_argument("--learning_rate", type=float, default=5e-6)
    p.add_argument("--weight_decay", type=float, default=0.2)
    p.add_argument("--betas", type=float, nargs=2, default=[0.9, 0.98])
    p.add_argument("--decay", type=str, default="cosine",
                   choices=["linear", "cosine", "invsqrt", "constant", "multi_step"])
    p.add_argument("--warmup_ratio", type=float, default=0.1)
    p.add_argument("--grad_norm", type=float, default=2.0)
    p.add_argument("--num_train_steps", type=int, default=1000)
    p.add_argument("--gradient_accumulation_steps", type=int, default=1)
    p.add_argument("--fused_adamw", type=int, default=1, help="kept for config compatibility")
    p.add_argument("--moment_dtype", type=str, default="fp32", choices=["fp32", "bf16"],
                   help="Adam moment storage dtype; accumulation runs in fp32")
    p.add_argument("--param_dtype", type=str, default="fp32", choices=["fp32", "bf16"],
                   help="parameter storage dtype; bf16 keeps fp32 masters in the optimizer")
    p.add_argument("--steps_per_call", type=int, default=1,
                   help="optimizer steps per dispatch (on a card: replays of one captured CUDA graph)")
    p.add_argument("--lr_mul", type=float, default=1.0)
    p.add_argument("--lr_mul_prefix", type=str, default="")
    p.add_argument("--loss_name", type=str, default="NCELearnableTempLoss")
    p.add_argument("--if_gather", type=int, default=1, help="kept for config compatibility")

    # freezing (stage-2 recipes, text-encoder freeze)
    p.add_argument("--freeze_text_model", type=int, default=0)
    p.add_argument("--freeze_text_proj", type=int, default=0)
    p.add_argument("--frozen_patterns", type=str, nargs="*", default=[])

    # precision / memory
    p.add_argument("--bf16", type=int, default=1)
    p.add_argument("--gradient_checkpointing", type=int, default=0)
    p.add_argument("--remat_policy", type=str, default="",
                   help="selective-remat policy of the LF-VILA Swin3D blocks; '' = full remat")
    p.add_argument("--zero2", type=int, default=1,
                   help="shard the Adam moments and masters over the data-parallel ranks (one process: no effect)")
    p.add_argument("--zero3", type=int, default=0,
                   help="FSDP: shard the parameters and moments over the data-parallel ranks")
    p.add_argument("--async_checkpoint", type=int, default=0, help="non-blocking saves")
    p.add_argument("--tp", type=int, default=1,
                   help="tensor-parallel degree: the model axis of a (data, model) mesh of the ranks")
    p.add_argument("--cp", type=int, default=1,
                   help="LF-VILA context-parallel degree: Swin3D's frames sharded over the model axis")

    # cadence
    p.add_argument("--log_steps", type=int, default=20)
    p.add_argument("--valid_steps", type=int, default=500)
    p.add_argument("--save_steps", type=int, default=500)
    p.add_argument("--validate_at_start", type=int, default=1)
    p.add_argument("--profile_steps", type=int, default=0,
                   help="capture a torch.profiler trace over N steps into output_dir/profile")
    p.add_argument("--profile_start_step", type=int, default=3)

    # model
    p.add_argument("--clip_size", type=str, default="base_32",
                   choices=["base_32", "base_16", "large_14", "tiny"])
    p.add_argument("--clip_weights", type=str, default="",
                   help="path to a torch CLIP / CLIP-ViP checkpoint to convert")
    p.add_argument("--e2e_weights_path", type=str, default="")
    return p


def reroot_data_paths(cfg: ConfigDict) -> ConfigDict:
    """Re-root relative data paths under ``--data_mount_dir`` (the
    reference's blob_mount / data_mount, ref
    ``CLIP-ViP/src/pretrain/run_pretrain.py:447-466``)."""
    if cfg.get("data_mount_dir"):
        for key in ("train_annotation", "val_annotation", "video_root"):
            if cfg.get(key) and not str(cfg[key]).startswith("/"):
                cfg[key] = f"{cfg['data_mount_dir'].rstrip('/')}/{cfg[key]}"
    return cfg


def parse_args(parser: argparse.ArgumentParser, argv: Sequence[str] | None = None) -> ConfigDict:
    """Parse a runner's flags (``parse_with_config``), re-root its data paths,
    join the group of the environment (``maybe_init_distributed``, with the
    runner's ``--device``) and form the mesh of ``--tp`` / ``--cp``
    (``mesh_from_config``) before the loaders take their data index. In a
    group on CUDA, ``cfg.device`` becomes this rank's card,
    ``cuda:LOCAL_RANK``."""
    cfg = reroot_data_paths(parse_with_config(parser, argv))
    mesh = maybe_init_distributed(cfg.get("device", "cuda"))
    if mesh is not None:
        cfg["device"] = str(mesh.device)
    mesh_from_config(cfg)
    return cfg
