"""LF-VILA downstream runner on one device (PyTorch port of
``xpretrain_tpu/cli/run_tasks_lfvila.py``): ``--task retrieval``.

Paragraph-to-video retrieval: the model is built at the config's widths
(random weights from ``--seed``), trained through ``GenericTrainer`` for
``--num_train_steps`` steps (0 goes straight to the eval, as in JAX), and
ranked text -> video on the validation set through
``xpretrain_tpu_torch.train.evaluate.evaluate_retrieval``; the report, R@K, goes
to ``final_report.json``. ``video_encoder.use_pallas_attention: true`` in
the config routes the window attention of stages whose window holds at
least ``pallas_min_window`` tokens through the hand-written CUDA kernel.

``qa_mc``, ``qa_cls`` and ``video_cls`` need stage-2 fusion, ``VideoTokenPos``
and label smoothing, and raise until they are ported (ROADMAP Queue 1), as
``--model_weight`` does.

Usage (synthetic data, the stage-1 preset's model, on the card; PyYAML is
needed for a .yaml config, a .json copy of it works without):
    python -m xpretrain_tpu_torch.cli.run_tasks_lfvila --task retrieval \\
        --config xpretrain_tpu/configs/presets/lfvila_pretrain_stage1.yaml \\
        --dummy_data 1 --num_train_steps 0 --val_batch_size 8 --device cuda \\
        --output_dir output/lfvila_retrieval
"""

from __future__ import annotations

import torch

from xpretrain_tpu_torch.cli.run_retrieval_clipvip import reroot_data_paths, resolve_device
from xpretrain_tpu_torch.cli.shared_args import build_shared_parser
from xpretrain_tpu_torch.config import parse_with_config
from xpretrain_tpu_torch.data.datasets import FrameSource
from xpretrain_tpu_torch.data.datasets_lfvila import (
    LfVilaPretrainCollator,
    LfVilaPretrainDataset,
    LfVilaRetrievalDataset,
)
from xpretrain_tpu_torch.data.loader import BatchLoader, InfiniteIterator, SequentialEvalLoader
from xpretrain_tpu_torch.data.tokenization import build_model_tokenizer
from xpretrain_tpu_torch.models.bert import BertConfig
from xpretrain_tpu_torch.models.lf_vila.convert import flax_param_paths
from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaConfig
from xpretrain_tpu_torch.models.lf_vila.swin3d import Swin3DConfig
from xpretrain_tpu_torch.models.lf_vila.tasks import LfVilaRetrieval
from xpretrain_tpu_torch.optim.optimizer import NO_DECAY_LFVILA
from xpretrain_tpu_torch.parallel.train_step import LFVILA_EVAL_IO, make_eval_step
from xpretrain_tpu_torch.train.checkpoints import save_training_meta
from xpretrain_tpu_torch.train.evaluate import evaluate_retrieval
from xpretrain_tpu_torch.train.generic_trainer import GenericTrainer
from xpretrain_tpu_torch.utils.basic import load_jsonl, save_json
from xpretrain_tpu_torch.utils.logging import LOGGER, setup_logging

DUMMY_SIZE = 256  # synthetic samples in each of the train and val sets (as the JAX runner)


def lfvila_config_from(cfg) -> LfVilaConfig:
    """The model config of a training config
    (``xpretrain_tpu/cli/run_pretrain_lfvila.py:lfvila_config_from``).

    For a config without them it builds the JAX config; it also reads
    ``video_encoder.use_pallas_attention`` and ``video_encoder.pallas_min_window``
    (defaults False and 240, as ``Swin3DConfig``), which the JAX builder leaves
    at their defaults. ``--cp > 1``, ``gradient_checkpointing`` and
    ``remat_policy`` carry through, and the model raises on them."""
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


def _synth_video_ds(cfg):
    return LfVilaPretrainDataset(
        [{} for _ in range(DUMMY_SIZE)], None, cfg.sample_frame, cfg.sample_clip,
        tuple(cfg.input_hw), synthetic=True, seed=cfg.seed,
    )


def build_loaders(cfg, tokenizer) -> tuple[InfiniteIterator, SequentialEvalLoader]:
    """(train, val) loaders of the retrieval task, as the JAX runner builds
    them for process 0 of 1."""
    collate = LfVilaPretrainCollator(tokenizer, max_sent_len=int(cfg.get("max_txt_len", 50)), mlm=False)
    if cfg.get("dummy_data"):
        train_ds = _synth_video_ds(cfg)
        val_ds = _synth_video_ds(cfg)
    else:
        source = FrameSource(cfg.video_root)
        train_ds = LfVilaRetrievalDataset(load_jsonl(cfg.train_annotation), source, cfg.sample_frame,
                                          cfg.sample_clip, tuple(cfg.input_hw), train=True)
        val_ds = LfVilaRetrievalDataset(load_jsonl(cfg.val_annotation), source,
                                        cfg.sample_frame, cfg.sample_clip, tuple(cfg.input_hw))
    train = InfiniteIterator(BatchLoader(train_ds, cfg.train_batch_size, collate, seed=cfg.seed))
    return train, SequentialEvalLoader(val_ds, cfg.val_batch_size, collate)


def main(argv=None):
    parser = build_shared_parser("LF-VILA downstream tasks (PyTorch)")
    parser.add_argument("--task", type=str, required=True,
                        choices=["retrieval", "qa_mc", "qa_cls", "video_cls"])
    parser.add_argument("--sample_frame", type=int, default=32)
    parser.add_argument("--sample_clip", type=int, default=4)
    parser.add_argument("--input_hw", type=int, nargs=2, default=[192, 320])
    parser.add_argument("--model_weight", type=str, default="",
                        help="pretrained LFVILA torch checkpoint to fine-tune from")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    cfg = reroot_data_paths(parse_with_config(parser, argv))
    if cfg.task != "retrieval":
        raise NotImplementedError(
            f"--task {cfg.task} needs stage-2 fusion, VideoTokenPos and label smoothing, which are "
            "not ported yet (ROADMAP Queue 1, LF-VILA slice)"
        )
    if cfg.get("model_weight"):
        raise NotImplementedError(
            "loading LF-VILA torch checkpoints into the port comes later (ROADMAP Queue 1)"
        )
    setup_logging(cfg.output_dir, 0)
    save_training_meta(cfg.output_dir, cfg)
    device = resolve_device(cfg.device)

    model_cfg = lfvila_config_from(cfg)
    tokenizer = build_model_tokenizer(cfg.get("tokenizer", "hash"), model_cfg.bert.vocab_size)
    train_loader, val_loader = build_loaders(cfg, tokenizer)
    model = LfVilaRetrieval(model_cfg, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(int(cfg.seed)))

    def apply_fn(m, batch, generator):
        return m(batch["video_frames"], batch["text_ids"], batch["attention_mask"], generator=generator)

    trainer = GenericTrainer(
        cfg, model, apply_fn, train_loader,
        metric_keys=("acc", "ct_global_loss", "span_loss", "span_acc"),
        no_decay_patterns=NO_DECAY_LFVILA, param_paths=flax_param_paths(model), device=device,
    )
    LOGGER.info("retrieval on %s: %d train steps, then eval of %d samples at batch %d",
                device, trainer.num_train_steps, val_loader.valid_len, cfg.val_batch_size)
    trainer.train()

    model.eval()
    report = evaluate_retrieval(make_eval_step(device, LFVILA_EVAL_IO), model, val_loader, val_loader.valid_len)
    report["score"] = report["t2v"]["R1"]
    save_json(report, f"{cfg.output_dir}/final_report.json", pretty=True)
    return report


if __name__ == "__main__":
    main()
