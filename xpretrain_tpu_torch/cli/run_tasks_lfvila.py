"""LF-VILA downstream runner on one device (PyTorch port of
``xpretrain_tpu/cli/run_tasks_lfvila.py``): retrieval, QA multichoice
(How2QA), QA classification (VIOLIN / ActivityNet-QA) and video
classification (COIN / LVU).

The model is built at the config's widths (random weights from ``--seed``),
trained through ``GenericTrainer`` for ``--num_train_steps`` steps (0 goes
straight to the eval, as in JAX), then evaluated on the validation set:
retrieval ranks text -> video
(``xpretrain_tpu_torch.train.evaluate.evaluate_retrieval``, R@K), the other
tasks report accuracy. The report goes to ``final_report.json``.
``qa_mc`` trains on the choice loss plus ``--span_loss_weight`` times the
temporal span loss (``--use_span_loss``). ``video_encoder.use_pallas_attention:
true`` in the config routes the window attention of stages whose window
holds at least ``pallas_min_window`` tokens through the hand-written CUDA
kernel; it has no backward, so on the card that config evaluates only.

``--model_weight`` (a reference LF-VILA checkpoint) merges over the seeded
init shape-tolerantly; the task heads keep their init.

Usage (synthetic data, the stage-1 preset's model, on the card; PyYAML is
needed for a .yaml config, a .json copy of it works without):
    python -m xpretrain_tpu_torch.cli.run_tasks_lfvila --task retrieval \\
        --config xpretrain_tpu/configs/presets/lfvila_pretrain_stage1.yaml \\
        --dummy_data 1 --num_train_steps 0 --val_batch_size 8 --device cuda \\
        --output_dir output/lfvila_retrieval
"""

from __future__ import annotations

import time

import numpy as np
import torch

from xpretrain_tpu_torch.cli.run_pretrain_lfvila import lfvila_config_from
from xpretrain_tpu_torch.cli.run_retrieval_clipvip import reroot_data_paths, resolve_device
from xpretrain_tpu_torch.cli.shared_args import build_shared_parser
from xpretrain_tpu_torch.config import parse_with_config
from xpretrain_tpu_torch.data.datasets import FrameSource
from xpretrain_tpu_torch.data.datasets_lfvila import (
    LfVilaPretrainCollator,
    LfVilaPretrainDataset,
    LfVilaRetrievalDataset,
)
from xpretrain_tpu_torch.data.datasets_lfvila_tasks import (
    ActnetQACollator,
    ActnetQADataset,
    How2QACollator,
    How2QADataset,
    VideoClsCollator,
    VideoClsDataset,
    ViolinCollator,
    ViolinDataset,
)
from xpretrain_tpu_torch.data.loader import BatchLoader, InfiniteIterator, SequentialEvalLoader
from xpretrain_tpu_torch.data.tokenization import build_model_tokenizer, warn_if_hash_with_weights
from xpretrain_tpu_torch.models.lf_vila.convert import flax_param_paths
from xpretrain_tpu_torch.models.lf_vila.tasks import (
    LfVilaQAClassification,
    LfVilaQAMultichoice,
    LfVilaRetrieval,
    LfVilaVideoClassification,
)
from xpretrain_tpu_torch.models.pretrained import load_lfvila_cascade
from xpretrain_tpu_torch.optim.optimizer import NO_DECAY_LFVILA
from xpretrain_tpu_torch.parallel.train_step import LFVILA_EVAL_IO, batch_to_device, make_eval_step
from xpretrain_tpu_torch.train.checkpoints import save_training_meta
from xpretrain_tpu_torch.train.evaluate import evaluate_retrieval
from xpretrain_tpu_torch.train.generic_trainer import GenericTrainer
from xpretrain_tpu_torch.utils.basic import load_jsonl, save_json
from xpretrain_tpu_torch.utils.logging import LOGGER, setup_logging

DUMMY_SIZE = 256  # synthetic samples in each of the train and val sets (as the JAX runner)
VIDEO_TEXT = ("video_frames", "text_ids", "attention_mask")  # what the text-and-video models take


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


def _task_datasets(cfg, ds_cls, **extra):
    """(train, val) benchmark datasets: synthetic fixtures under
    ``--dummy_data``, jsonl-annotation-backed otherwise."""
    common = dict(sample_frame=cfg.sample_frame, input_hw=tuple(cfg.input_hw), seed=cfg.seed, **extra)
    if cfg.get("dummy_data"):
        rows = [{} for _ in range(DUMMY_SIZE)]
        return (ds_cls(rows, None, train=True, synthetic=True, **common),
                ds_cls(rows, None, train=False, synthetic=True, **common))
    source = FrameSource(cfg.video_root)
    return (ds_cls(load_jsonl(cfg.train_annotation), source, train=True, **common),
            ds_cls(load_jsonl(cfg.val_annotation), source, train=False, **common))


def build_task(cfg, model_cfg, tokenizer, device):
    """(model, collate, train set, val set, the batch keys the model takes)
    of ``--task`` qa_mc, qa_cls or video_cls, as the JAX runner builds them."""
    max_sent = int(cfg.get("max_txt_len", 50))
    if cfg.task == "qa_mc":
        # How2QA: 4-way multichoice with subtitles and temporal span labels
        # (ref LF-VILA/src/datasets/how2qa_dataset.py, configs/how2_qa.yaml)
        model = LfVilaQAMultichoice(model_cfg, device=device)
        collate = How2QACollator(tokenizer, max_sent, cfg.max_num_subtitle)
        train_ds, val_ds = _task_datasets(cfg, How2QADataset, max_num_subtitle=cfg.max_num_subtitle,
                                          num_options=cfg.num_options)
        return model, collate, train_ds, val_ds, VIDEO_TEXT
    if cfg.task == "qa_cls":
        # VIOLIN (statement verification) or ActivityNet-QA (answer-vocabulary
        # classification), both on LfVilaQAClassification (ref run_qa.py:107-110)
        qa_ds = cfg.qa_dataset or "actnet"
        num_labels = cfg.num_labels or {"violin": 2, "actnet": 1654}[qa_ds]
        model = LfVilaQAClassification(model_cfg, device=device, num_labels=num_labels)
        if qa_ds == "violin":
            subtitles = min(cfg.max_num_subtitle, 4)
            collate = ViolinCollator(tokenizer, max_sent, subtitles)
            train_ds, val_ds = _task_datasets(cfg, ViolinDataset, max_num_subtitle=subtitles)
        else:
            collate = ActnetQACollator(tokenizer, max_sent)
            train_ds, val_ds = _task_datasets(cfg, ActnetQADataset, num_labels=num_labels)
        return model, collate, train_ds, val_ds, VIDEO_TEXT
    # video_cls (COIN/LVU, ref video_classification_dataset.py)
    num_labels = cfg.num_labels or 180
    model = LfVilaVideoClassification(model_cfg, device=device, num_labels=num_labels)
    train_ds, val_ds = _task_datasets(cfg, VideoClsDataset, num_labels=num_labels)
    return model, VideoClsCollator(), train_ds, val_ds, ("video_frames",)


def with_labels(collate):
    """The collator, plus ``labels`` from the items when it sets none (the
    JAX runner's ``collate_with_labels``)."""
    def collate_with_labels(items):
        batch = collate(items)
        if "labels" not in batch and hasattr(items[0], "get"):
            batch["labels"] = np.asarray([it.get("label", 0) for it in items], np.int64)
        return batch
    return collate_with_labels


def evaluate_accuracy(model, loader: SequentialEvalLoader, keys: tuple[str, ...], device) -> dict:
    """Accuracy of the argmax of ``logits`` over the first ``valid_len``
    samples, forward under ``inference_mode``; ``perf`` holds the wall time
    and clips/s (host clock, decode and upload included)."""
    place = batch_to_device(device)
    correct = total = 0
    t0 = time.perf_counter()
    with torch.inference_mode():
        for batch in loader:
            labels = batch["labels"]
            inputs = place({k: batch[k] for k in keys})
            out = model(*(inputs[k] for k in keys))
            pred = out["logits"].float().argmax(dim=-1).cpu().numpy()
            n = min(len(labels), loader.valid_len - total)
            correct += int((pred[:n] == labels[:n]).sum())
            total += n
    wall = time.perf_counter() - t0
    return {"accuracy": correct / max(total, 1), "n": total,
            "perf": {"wall_s": wall, "clips_per_s": total / max(wall, 1e-9)}}


def main(argv=None):
    parser = build_shared_parser("LF-VILA downstream tasks (PyTorch)")
    parser.add_argument("--task", type=str, required=True,
                        choices=["retrieval", "qa_mc", "qa_cls", "video_cls"])
    parser.add_argument("--sample_frame", type=int, default=32)
    parser.add_argument("--sample_clip", type=int, default=4)
    parser.add_argument("--input_hw", type=int, nargs=2, default=[192, 320])
    parser.add_argument("--num_labels", type=int, default=0,
                        help="0 = benchmark default (how2qa 4-way; violin 2; "
                             "actnet 1654; video_cls 180)")
    parser.add_argument("--num_options", type=int, default=4,
                        help="qa_mc: answers of a synthetic How2QA sample (jsonl rows carry their own)")
    parser.add_argument("--qa_dataset", type=str, default="",
                        choices=["", "how2qa", "violin", "actnet"],
                        help="benchmark row format for qa tasks (qa_mc -> how2qa; "
                             "qa_cls -> violin|actnet, default actnet)")
    parser.add_argument("--max_num_subtitle", type=int, default=6)
    parser.add_argument("--use_span_loss", type=int, default=1,
                        help="how2qa temporal span loss (ref how2_qa.yaml:72)")
    parser.add_argument("--span_loss_weight", type=float, default=1.0)
    parser.add_argument("--model_weight", type=str, default="",
                        help="pretrained LFVILA torch checkpoint to fine-tune from "
                             "(shape-tolerant; task heads keep their init)")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    # qa_mc stacks 2 + max_num_subtitle rows of max_txt_len tokens into one
    # paragraph of 512 sentence positions: its default is 50 (the JAX
    # runner's own fallback; 8 x 50 = 400 fits), the other tasks keep 70
    parser.set_defaults(max_txt_len=None)
    cfg = reroot_data_paths(parse_with_config(parser, argv))
    if cfg.max_txt_len is None:
        cfg.max_txt_len = 50 if cfg.task == "qa_mc" else 70
    setup_logging(cfg.output_dir, 0)
    save_training_meta(cfg.output_dir, cfg)
    device = resolve_device(cfg.device)

    model_cfg = lfvila_config_from(cfg)
    tokenizer = build_model_tokenizer(cfg.get("tokenizer", "hash"), model_cfg.bert.vocab_size)
    if cfg.task == "retrieval":
        train_loader, val_loader = build_loaders(cfg, tokenizer)
        model, keys = LfVilaRetrieval(model_cfg, device=device), VIDEO_TEXT
    else:
        model, collate, train_ds, val_ds, keys = build_task(cfg, model_cfg, tokenizer, device)
        collate = with_labels(collate)
        train_loader = InfiniteIterator(BatchLoader(train_ds, cfg.train_batch_size, collate, seed=cfg.seed))
        val_loader = SequentialEvalLoader(val_ds, cfg.val_batch_size, collate)
    model.init_weights(torch.Generator(device=device).manual_seed(int(cfg.seed)))
    if cfg.get("model_weight"):
        # the task models share video_encoder/text_encoder/projection names
        # with the pretraining model, so the full-checkpoint converter merges
        warn_if_hash_with_weights(cfg.get("tokenizer", "hash"), cfg["model_weight"])
        load_lfvila_cascade(model, model_weight=cfg["model_weight"])

    def apply_fn(m, batch, generator):
        kwargs = {} if cfg.task == "retrieval" else {"labels": batch["labels"]}
        if cfg.task == "qa_mc" and cfg.use_span_loss and "span_labels" in batch:
            kwargs["span_labels"] = batch["span_labels"]
            kwargs["span_label_weights"] = batch["span_label_weights"]
        out = m(*(batch[k] for k in keys), generator=generator, **kwargs)
        if "span_loss" in out:
            # total = choice loss + weighted temporal span loss
            # (ref trainer_qa_multichoice.py:190-196)
            out["loss"] = out["loss"] + cfg.span_loss_weight * out["span_loss"]
        return out

    trainer = GenericTrainer(
        cfg, model, apply_fn, train_loader,
        metric_keys=("acc", "ct_global_loss", "span_loss", "span_acc"),
        no_decay_patterns=NO_DECAY_LFVILA, param_paths=flax_param_paths(model), device=device,
    )
    LOGGER.info("%s on %s: %d train steps, then eval of %d samples at batch %d", cfg.task, device,
                trainer.num_train_steps, val_loader.valid_len, cfg.val_batch_size)
    trainer.train()

    model.eval()
    if cfg.task == "retrieval":
        report = evaluate_retrieval(make_eval_step(device, LFVILA_EVAL_IO), model, val_loader,
                                    val_loader.valid_len)
        report["score"] = report["t2v"]["R1"]
    else:
        report = evaluate_accuracy(model, val_loader, keys, device)
        LOGGER.info("%s accuracy: %.4f", cfg.task, report["accuracy"])
    save_json(report, f"{cfg.output_dir}/final_report.json", pretty=True)
    return report


if __name__ == "__main__":
    main()
