"""HD-VILA video-text retrieval, on one device or on each rank of a torchrun
data-parallel group: dual-encoder ITC fine-tune and R@K eval (PyTorch port of
``xpretrain_tpu/cli/run_retrieval_hdvila.py``).

The runner surface of ``hd-vila/src/tasks/run_video_retrieval.py:168-434``:
the hybrid encoder's stage-1 ITC features trained with the contrastive loss
zoo over the batch; the eval ranks text -> video (R@K raw and DSL) through
``make_eval_step`` and ``evaluate_retrieval``.

``--loss_type rank`` trains the fusion rerank head
(``HdVilaForVideoTextRetrieval``, ref ``modeling_stage.py:694-751``) with the
reference's margin triplet loss (``calc_loss`` ``:738-747``): each video's
fused score against its own caption is the positive and its scores against
``--num_negs`` batch-rolled captions the negatives, ``mean(relu(margin + neg
- pos))`` over sigmoid scores. Its retrieval eval uses the head's
dual-encoder projections (``t_proj``/``v_proj``).

``--mode eval`` evaluates the model as built (seeded init, then
``--e2e_weights_path``) and writes ``eval_report.json``; ``--mode train``
(the default) trains, validating every ``--valid_steps``, and writes
``final_report.json``.

Usage (synthetic data, the stage-1 preset's model, on the card):
    python -m xpretrain_tpu_torch.cli.run_retrieval_hdvila \\
        --config xpretrain_tpu_torch/configs/hdvila_pretrain_stage1.json \\
        --dummy_data 1 --num_train_steps 10 --output_dir output/hdvila_retrieval
"""

from __future__ import annotations

import math

import torch
from torch import nn

from xpretrain_tpu_torch.cli.run_pretrain_hdvila import (
    HdVilaPretrainModel,
    hdvila_configs_from,
    init_hdvila_weights,
    load_e2e_weights,
)
from xpretrain_tpu_torch.cli.run_retrieval_clipvip import resolve_device
from xpretrain_tpu_torch.cli.shared_args import build_shared_parser, parse_args
from xpretrain_tpu_torch.data.datasets import FrameSource
from xpretrain_tpu_torch.data.datasets_hdvila import HdVilaPretrainCollator
from xpretrain_tpu_torch.data.datasets_hdvila_tasks import HdVilaClipLoader, HdVilaRetrievalDataset
from xpretrain_tpu_torch.data.loader import BatchLoader, InfiniteIterator, SequentialEvalLoader
from xpretrain_tpu_torch.data.tokenization import build_model_tokenizer
from xpretrain_tpu_torch.models.hd_vila.convert import flax_param_paths
from xpretrain_tpu_torch.models.hd_vila.e2e import HdVilaEncoder, HdVilaEncoderConfig
from xpretrain_tpu_torch.models.hd_vila.modeling import HdVilaForVideoTextRetrieval, HdVilaModelConfig
from xpretrain_tpu_torch.ops.losses import build_loss_fn
from xpretrain_tpu_torch.parallel.fsdp import gathered
from xpretrain_tpu_torch.parallel.mesh import gather_rows, is_main_process, process_index_count, process_rank, rank_slice
from xpretrain_tpu_torch.parallel.train_step import make_eval_step
from xpretrain_tpu_torch.train.checkpoints import save_training_meta
from xpretrain_tpu_torch.train.evaluate import evaluate_retrieval
from xpretrain_tpu_torch.train.generic_trainer import GenericTrainer
from xpretrain_tpu_torch.utils.basic import save_json
from xpretrain_tpu_torch.utils.logging import LOGGER, setup_logging

DUMMY_TRAIN_ROWS, DUMMY_VAL_ROWS = 128, 64  # synthetic captions (as the JAX runner)
HDVILA_EVAL_IO = (("img_middle", "img_other", "text_input_ids", "text_input_mask"),
                  {"vis_features": "vis_features", "text_features": "text_features"})


def rolled_captions(text_input_ids: torch.Tensor, text_input_mask: torch.Tensor, k: int
                    ) -> tuple[torch.Tensor, torch.Tensor]:
    """(ids, mask) of the (1+k)*b pairs: this rank's b captions, then for
    each roll 1..k its rows of the global batch's captions rolled by it (the
    in-batch negatives; in a data-parallel group the captions of every rank
    are gathered first)."""
    all_ids, all_mask = gather_rows(text_input_ids), gather_rows(text_input_mask)
    B = all_ids.shape[0]
    if k >= B:
        # a roll s with s % B == 0 would reproduce the positive pair: its
        # "negative" column then adds a constant margin with zero gradient
        raise ValueError(
            f"rank mode needs num_negs < batch size, got num_negs={k} with batch {B} (every roll "
            "1..num_negs must be a distinct non-identity permutation)")
    ids = torch.cat([text_input_ids] + [rank_slice(torch.roll(all_ids, s, 0)) for s in range(1, k + 1)])
    mask = torch.cat([text_input_mask] + [rank_slice(torch.roll(all_mask, s, 0)) for s in range(1, k + 1)])
    return ids, mask


class HdVilaRerankModel(nn.Module):
    """Encoder + fusion rerank head with in-batch rolled negatives.

    The margin triplet loss over sigmoid fusion scores follows the reference
    (``modeling_stage.py:738-747``): scores reshape to (video, 1 + num_negs)
    with the positive in column 0; the negatives are batch rolls of the
    caption tensors."""

    def __init__(self, enc_cfg: HdVilaEncoderConfig, model_cfg: HdVilaModelConfig, num_negs: int = 3,
                 margin: float = 0.2, device=None):
        super().__init__()
        self.num_negs, self.margin = num_negs, margin
        self.encoder = HdVilaEncoder(enc_cfg, device)
        self.head = HdVilaForVideoTextRetrieval(model_cfg, device)

    def init_weights(self, generator: torch.Generator) -> "HdVilaRerankModel":
        return init_hdvila_weights(self, generator)

    def forward(self, img_middle, img_other, text_input_ids, text_input_mask, with_rank_loss: bool = False,
                generator=None) -> dict[str, torch.Tensor]:
        grid = self.encoder(img_middle, img_other)
        if not with_rank_loss:
            return self.head(grid, text_input_ids, text_input_mask, generator)
        k = self.num_negs
        ids, mask = rolled_captions(text_input_ids, text_input_mask, k)
        pair = self.head(grid.repeat(1 + k, *([1] * (grid.dim() - 1))), ids, mask, generator)
        b = text_input_ids.shape[0]
        out = {name: pair[name][:b] for name in ("logits", "text_features", "vis_features")}
        scores = torch.sigmoid(pair["logits"].float()).reshape(1 + k, -1).T
        pos, neg = scores[:, :1], scores[:, 1:]
        out["rank_loss"] = torch.clamp(self.margin + neg - pos, min=0.0).mean()
        out["loss"] = out["rank_loss"]
        return out


def build_data(cfg, tokenizer) -> tuple[InfiniteIterator, SequentialEvalLoader]:
    """(train loader, val loader), as the JAX runner builds them: each
    rank's share of every batch."""
    collate = HdVilaPretrainCollator(tokenizer, max_txt_len=int(cfg.get("max_txt_len", 50)), mlm=False, itm=False)
    loader_args = dict(n_clips=cfg.train_n_clips, num_frm=cfg.num_frm, sample_rate=cfg.sample_rate or 12,
                       crop_hw=tuple(cfg.get("crop_size", (640, 1024))))
    if cfg.get("dummy_data"):
        clip_loader = HdVilaClipLoader(None, synthetic_seed=cfg.seed, **loader_args)
        rows = [{"clip_id": f"c{i}", "text": f"video about topic {i}"} for i in range(DUMMY_TRAIN_ROWS)]
        train_ds = HdVilaRetrievalDataset(None, clip_loader, rows=rows, train=True, seed=cfg.seed)
        val_ds = HdVilaRetrievalDataset(None, clip_loader, rows=rows[:DUMMY_VAL_ROWS])
    else:
        clip_loader = HdVilaClipLoader(FrameSource(cfg.video_root), **loader_args)
        train_ds = HdVilaRetrievalDataset(cfg.train_annotation, clip_loader, train=True, seed=cfg.seed)
        val_ds = HdVilaRetrievalDataset(cfg.val_annotation, clip_loader)
    pi, pc = process_index_count()
    train = InfiniteIterator(BatchLoader(train_ds, cfg.train_batch_size, collate, seed=cfg.seed, process_index=pi,
                                         process_count=pc))
    return train, SequentialEvalLoader(val_ds, cfg.val_batch_size, collate, process_index=pi, process_count=pc)


def main(argv=None):
    parser = build_shared_parser("HD-VILA video retrieval (PyTorch)")
    parser.add_argument("--mode", type=str, default="train", choices=["train", "eval"])
    parser.add_argument("--train_n_clips", type=int, default=2)
    parser.add_argument("--loss_type", type=str, default="itc", choices=["itc", "rank"],
                        help="itc: dual-encoder contrastive fine-tune; rank: fusion rerank head with the "
                             "reference's margin triplet loss")
    parser.add_argument("--margin", type=float, default=0.2)
    parser.add_argument("--num_negs", type=int, default=3, help="rank mode: in-batch rolled negatives per video")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    cfg = parse_args(parser, argv)
    cfg["stage"] = 1  # dual-encoder ITC
    setup_logging(cfg.output_dir, process_rank())
    if is_main_process():
        save_training_meta(cfg.output_dir, cfg)
    device = resolve_device(cfg.device)

    enc_cfg, model_cfg = hdvila_configs_from(cfg)
    rank_mode = cfg.get("loss_type", "itc") == "rank"
    if rank_mode:
        model = HdVilaRerankModel(enc_cfg, model_cfg, num_negs=int(cfg.get("num_negs", 3)),
                                  margin=float(cfg.get("margin", 0.2)), device=device)
    else:
        model = HdVilaPretrainModel(enc_cfg, model_cfg, temp=model_cfg.temp, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(int(cfg.seed)))
    load_e2e_weights(cfg, model)
    tokenizer = build_model_tokenizer(cfg.get("tokenizer", "hash"), model_cfg.bert.vocab_size)
    train_loader, val_loader = build_data(cfg, tokenizer)

    # the JAX runner's loss selection, as it is
    loss_fn = build_loss_fn(cfg.get("loss_name", "NCEContrastiveLoss"), temp=model_cfg.temp) \
        if cfg.get("loss_name", "NCEContrastiveLoss") in ("NCEContrastiveLoss",) \
        else build_loss_fn(cfg["loss_name"])

    def apply_fn(m, batch, generator):
        out = m(batch["img_middle"], batch["img_other"], batch["text_input_ids"], batch["text_input_mask"],
                generator=generator, **({"with_rank_loss": True} if rank_mode else {}))
        if rank_mode:
            return out  # the margin triplet loss is computed in the model
        if getattr(loss_fn, "signature_kind", "pair_temp") == "pair_temp":
            out["loss"] = loss_fn(out["vis_features"], out["text_features"])
        else:
            scale = torch.full((), math.log(1.0 / model_cfg.temp), device=out["vis_features"].device)
            out["loss"] = loss_fn(out["vis_features"], out["text_features"], scale)
        return out

    eval_step = make_eval_step(device, HDVILA_EVAL_IO)

    def run_eval(m):
        m.eval()
        report = evaluate_retrieval(eval_step, m, val_loader, val_loader.valid_len)
        report["score"] = report["t2v"]["R1"]
        return report

    if cfg.mode == "eval":
        report = run_eval(model)
        if is_main_process():
            save_json(report, f"{cfg.output_dir}/eval_report.json", pretty=True)
        return report
    trainer = GenericTrainer(cfg, model, apply_fn, train_loader, eval_fn=run_eval,
                             metric_keys=("rank_loss",) if rank_mode else (), param_paths=flax_param_paths(model),
                             device=device)
    LOGGER.info("HD-VILA retrieval (%s) on %s: %d steps at batch %d", cfg.get("loss_type", "itc"), device,
                trainer.num_train_steps, cfg.train_batch_size)
    state = trainer.train()
    with gathered(state.model):
        report = run_eval(state.model)
    if is_main_process():
        save_json(report, f"{cfg.output_dir}/final_report.json", pretty=True)
    return report


if __name__ == "__main__":
    main()
