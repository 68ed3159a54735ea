"""HD-VILA video QA, on one device or on each rank of a torchrun data-parallel
group: train and standalone inference (PyTorch port of
``xpretrain_tpu/cli/run_video_qa_hdvila.py``).

The runner surface of ``hd-vila/src/tasks/run_video_qa.py:386-705`` (and the
MSR-VTT-MC runner ``run_msrvtt_mc.py:145-316``): multiple-choice heads for
the action / transition / mc / msrvtt_mc tasks, a regression head for TGIF
count, classification heads otherwise. ``--mode inference`` restores the
training run's ``log/args.json`` without the inference keys and evaluates
its best checkpoint (ref ``:653-705``).

Usage (synthetic data, on the card):
    python -m xpretrain_tpu_torch.cli.run_video_qa_hdvila \\
        --config xpretrain_tpu_torch/configs/hdvila_pretrain_stage1.json --dummy_data 1 \\
        --task_type mc --num_train_steps 10 --output_dir output/hdvila_qa
"""

from __future__ import annotations

import os

import numpy as np
import torch
from torch import nn

from xpretrain_tpu_torch.cli.run_pretrain_hdvila import hdvila_configs_from, init_hdvila_weights, load_e2e_weights
from xpretrain_tpu_torch.cli.run_retrieval_clipvip import resolve_device
from xpretrain_tpu_torch.cli.shared_args import build_shared_parser, parse_args
from xpretrain_tpu_torch.data.datasets import FrameSource
from xpretrain_tpu_torch.data.datasets_hdvila_tasks import HdVilaClipLoader, HdVilaQACollator, HdVilaQADataset
from xpretrain_tpu_torch.data.loader import BatchLoader, InfiniteIterator, SequentialEvalLoader
from xpretrain_tpu_torch.data.tokenization import build_model_tokenizer
from xpretrain_tpu_torch.models.hd_vila.convert import flax_param_paths
from xpretrain_tpu_torch.models.hd_vila.e2e import HdVilaEncoder
from xpretrain_tpu_torch.models.hd_vila.modeling import (
    HdVilaForMultipleChoice,
    HdVilaForRegression,
    HdVilaForSequenceClassification,
)
from xpretrain_tpu_torch.ops.losses import label_smoothing_xent
from xpretrain_tpu_torch.parallel.fsdp import gathered
from xpretrain_tpu_torch.parallel.mesh import host_rows, is_main_process, process_index_count, process_rank
from xpretrain_tpu_torch.parallel.train_step import make_eval_step
from xpretrain_tpu_torch.train.checkpoints import CheckpointManager, save_training_meta
from xpretrain_tpu_torch.train.generic_trainer import GenericTrainer
from xpretrain_tpu_torch.utils.basic import load_json, save_json
from xpretrain_tpu_torch.utils.logging import LOGGER, setup_logging

MC_TASKS = ("action", "transition", "mc", "msrvtt_mc")
REGRESSION_TASKS = ("count",)  # TGIF count: MSE head, preds rounded and clamped to [1, 10] at eval
DUMMY_TRAIN_ROWS, DUMMY_VAL_ROWS = 256, 64  # synthetic questions (as the JAX runner)
QA_EVAL_IO = (("img_middle", "img_other", "text_input_ids", "text_input_mask"), {"logits": "logits"})

# TGIF/MSRVTT open-ended QA report per-answer-type accuracy
# (ref dataset_video_qa.py:199-253 evaluate_tgif_qa)
ANSWER_TYPE2IDX = {
    "frameqa": {"object": 0, "number": 1, "color": 2, "location": 3},
    "msrvtt_qa": {k: i for i, k in enumerate(["what", "who", "how", "where", "when"])},
}


class HdVilaQAModel(nn.Module):
    def __init__(self, enc_cfg, model_cfg, task_type: str, num_labels: int = 2, device=None):
        super().__init__()
        self.task_type = task_type
        self.encoder = HdVilaEncoder(enc_cfg, device)
        if task_type in MC_TASKS:
            self.head = HdVilaForMultipleChoice(model_cfg, device)
        elif task_type in REGRESSION_TASKS:
            self.head = HdVilaForRegression(model_cfg, device)
        else:
            self.head = HdVilaForSequenceClassification(model_cfg, num_labels, device)

    def init_weights(self, generator: torch.Generator) -> "HdVilaQAModel":
        return init_hdvila_weights(self, generator)

    def forward(self, img_middle, img_other, text_input_ids, text_input_mask, labels=None,
                generator=None) -> dict[str, torch.Tensor]:
        out = self.head(self.encoder(img_middle, img_other), text_input_ids, text_input_mask, generator)
        if labels is not None:
            if self.task_type in REGRESSION_TASKS:
                logits32 = out["logits"].float()
                out["loss"] = ((logits32 - labels.float()) ** 2).mean()
                pred = torch.clamp(torch.floor(logits32 + 0.5).long(), 1, 10)
                out["acc"] = (pred == labels).float().mean()
            else:
                out["loss"] = label_smoothing_xent(out["logits"], labels, smoothing=0.0)
                out["acc"] = (out["logits"].argmax(dim=-1) == labels).float().mean()
        return out


def build_qa_data(cfg, tok):
    """(train loader, val loader, val set). The train loader samples
    ``train_n_clips`` random windows; the val loader spreads
    ``inference_n_clips`` windows evenly over each video so the model's
    in-forward score aggregation covers the whole clip (the reference's
    multi-clip inference, ``run_video_qa.py:263-280``)."""
    loader_args = dict(num_frm=cfg.num_frm, sample_rate=cfg.sample_rate or 12,
                       crop_hw=tuple(cfg.get("crop_size", (640, 1024))))
    mc = cfg.task_type in MC_TASKS
    collate = HdVilaQACollator(tok, max_txt_len=int(cfg.get("max_txt_len", 40)), multiple_choice=mc)
    inf_clips = int(cfg.get("inference_n_clips", 1))
    if cfg.get("dummy_data"):
        clip_loader = HdVilaClipLoader(None, n_clips=cfg.train_n_clips, synthetic_seed=cfg.seed, **loader_args)
        val_clip_loader = HdVilaClipLoader(None, n_clips=inf_clips, synthetic_seed=cfg.seed, **loader_args)
        n_opt = int(cfg.get("num_options", 5))
        count = cfg.task_type in REGRESSION_TASKS
        rows = [
            {
                "clip_id": f"c{i}",
                "question": f"question {i}",
                "question_id": 1000 + i,
                "options": [f"opt {j}" for j in range(n_opt)],
                "label": i % n_opt if mc else i % cfg.get("num_labels", 2),
                "answer": 1 + i % 10 if count else "a",
            }
            for i in range(DUMMY_TRAIN_ROWS)
        ]
        train_ds = HdVilaQADataset(None, clip_loader, cfg.task_type, rows=rows, train=True, seed=cfg.seed)
        val_ds = HdVilaQADataset(None, val_clip_loader, cfg.task_type, rows=rows[:DUMMY_VAL_ROWS])
    else:
        source = FrameSource(cfg.video_root)
        clip_loader = HdVilaClipLoader(source, n_clips=cfg.train_n_clips, **loader_args)
        val_clip_loader = HdVilaClipLoader(source, n_clips=inf_clips, **loader_args)
        vocab = load_json(cfg.answer_vocab) if cfg.get("answer_vocab") else None
        train_ds = HdVilaQADataset(cfg.train_annotation, clip_loader, cfg.task_type, answer_vocab=vocab,
                                   train=True, seed=cfg.seed)
        val_ds = HdVilaQADataset(cfg.val_annotation, val_clip_loader, cfg.task_type, answer_vocab=vocab)
    pi, pc = process_index_count()
    train_loader = InfiniteIterator(BatchLoader(train_ds, cfg.train_batch_size, collate, seed=cfg.seed,
                                                process_index=pi, process_count=pc))
    val_loader = SequentialEvalLoader(val_ds, cfg.val_batch_size, collate, process_index=pi, process_count=pc)
    return train_loader, val_loader, val_ds


def evaluate_qa(model: nn.Module, val_loader, device, val_ds=None, task_type: str = "open") -> dict:
    """Accuracy + per-question predictions (+ the per-answer-type breakdown
    of the open-ended TGIF/MSRVTT tasks). The clip-score aggregation already
    happened inside the model's forward, so each eval row is one question.
    In a group every rank's predictions, labels and ids are gathered."""
    model.eval()
    eval_step = make_eval_step(device, QA_EVAL_IO)
    preds, golds, row_ids = [], [], []
    total = 0
    for batch in val_loader:
        logits = eval_step(model, batch)["logits"]
        if task_type in REGRESSION_TASKS:
            pred = np.clip((logits + 0.5).astype(np.int64), 1, 10)
        else:
            pred = np.argmax(logits, -1)
        pred, labels, ids = host_rows(pred), host_rows(batch["labels"]), host_rows(batch["ids"])
        n = min(len(labels), val_loader.valid_len - total)
        preds.extend(pred[:n].tolist())
        golds.extend(labels[:n].tolist())
        row_ids.extend(ids[:n].tolist())
        total += n
    preds_arr, golds_arr = np.asarray(preds), np.asarray(golds)
    acc = float((preds_arr == golds_arr).mean()) if total else 0.0
    LOGGER.info("QA accuracy: %.4f (%d samples)", acc, total)
    report = {"accuracy": acc, "score": acc, "n": total}
    if val_ds is not None:
        rows = val_ds.rows
        report["qa_results"] = [
            {"question_id": rows[i].get("question_id", int(i)), "answer": int(p)} for i, p in zip(row_ids, preds)
        ]
        type_map = ANSWER_TYPE2IDX.get(task_type)
        if type_map:
            types = np.asarray([type_map.get(str(rows[i].get("answer_type", "")), -1) for i in row_ids])
            for name, idx in type_map.items():
                sel = types == idx
                if sel.any():
                    report[f"{name}_acc"] = float((preds_arr[sel] == golds_arr[sel]).mean())
                    report[f"{name}_ratio"] = float(sel.mean())
    return report


def main(argv=None):
    parser = build_shared_parser("HD-VILA video QA (PyTorch)")
    parser.add_argument("--mode", type=str, default="train", choices=["train", "inference"])
    parser.add_argument("--task_type", type=str, default="open")
    parser.add_argument("--num_labels", type=int, default=2)
    parser.add_argument("--num_options", type=int, default=5)
    parser.add_argument("--train_n_clips", type=int, default=2)
    parser.add_argument("--inference_n_clips", type=int, default=1,
                        help="clips spread over the video at eval; scores aggregated in-model "
                             "(ref run_video_qa.py:263)")
    parser.add_argument("--score_agg_func", type=str, default="mean", choices=["mean", "max", "lse"])
    parser.add_argument("--answer_vocab", type=str, default="")
    parser.add_argument("--inference_model_step", type=int, default=-1)
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    cfg = parse_args(parser, argv)

    if cfg.mode == "inference":
        # restore the training-time args, without the inference-only keys
        # (ref run_video_qa.py:653-705)
        args_path = os.path.join(cfg.output_dir, "log", "args.json")
        if os.path.exists(args_path):
            for key, value in load_json(args_path).items():
                if not str(key).startswith(("inference", "mode")) and key not in ("output_dir", "device"):
                    cfg[key] = value
    setup_logging(cfg.output_dir, process_rank())
    device = resolve_device(cfg.device)

    enc_cfg, model_cfg = hdvila_configs_from(cfg)
    model = HdVilaQAModel(enc_cfg, model_cfg, cfg.task_type, int(cfg.num_labels), device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(int(cfg.seed)))
    # fine-tunes start from pretrained e2e weights (shape-tolerant: the QA
    # head keeps its init, ref load_state_dict_with_mismatch)
    load_e2e_weights(cfg, model)
    tok = build_model_tokenizer(cfg.get("tokenizer", "hash"), model_cfg.bert.vocab_size)
    train_loader, val_loader, val_ds = build_qa_data(cfg, tok)

    if cfg.mode == "inference":
        # best-model checkpoints hold {"params", "score"} (BestModelSaver)
        mgr = CheckpointManager(f"{cfg.output_dir}/best")
        if mgr.latest_step() is not None:
            restored = mgr.restore(cfg.inference_model_step if cfg.inference_model_step >= 0 else None)
            model.load_state_dict(restored["params"])
            LOGGER.info("restored best model (score %.4f)", float(restored["score"]))
        report = evaluate_qa(model, val_loader, device, val_ds=val_ds, task_type=cfg.task_type)
        if is_main_process():
            save_json(report, f"{cfg.output_dir}/inference_report.json", pretty=True)
        return report

    if is_main_process():
        save_training_meta(cfg.output_dir, cfg)

    def apply_fn(m, batch, generator):
        return m(batch["img_middle"], batch["img_other"], batch["text_input_ids"], batch["text_input_mask"],
                 labels=batch["labels"], generator=generator)

    trainer = GenericTrainer(
        cfg, model, apply_fn, train_loader,
        eval_fn=lambda m: evaluate_qa(m, val_loader, device, val_ds=val_ds, task_type=cfg.task_type),
        metric_keys=("acc",), param_paths=flax_param_paths(model), device=device,
    )
    LOGGER.info("HD-VILA QA (%s) on %s: %d steps at batch %d", cfg.task_type, device, trainer.num_train_steps,
                cfg.train_batch_size)
    state = trainer.train()
    with gathered(state.model):
        report = evaluate_qa(state.model, val_loader, device, val_ds=val_ds, task_type=cfg.task_type)
    if is_main_process():
        save_json(report, f"{cfg.output_dir}/final_report.json", pretty=True)
    return report


if __name__ == "__main__":
    main()
