"""HD-VILA pretraining runner, stages 1 and 2, on one device or on each rank
of a torchrun data-parallel group (PyTorch port of
``xpretrain_tpu/cli/run_pretrain_hdvila.py``).

The runner surface of ``hd-vila/src/pretrain/run_pretrain_stage1_group.py:220-495``
and ``run_pretrain_stage2_group.py``: the hybrid high/low-res encoder and the
two-stage BERT (random weights from ``--seed``, then ``--e2e_weights_path``),
ITC (stage 1) or MLM + ITM (stage 2, the stage-1 modules frozen by the
config's ``frozen_patterns``, matched on the flax paths), trained through
``GenericTrainer``.

- The host ships uint8 frames (``datasets_hdvila``); the encoder normalizes
  them on the device, once.
- Stage 2's pixel random sampling draws from the step's generator.
- ``apply_stage2_batch_fallback`` (JAX's grad-accumulation rewrite of
  stage-2 batches >= 16) rewrites on a TPU backend only, so never here.

Usage (synthetic data, on the card):
    python -m xpretrain_tpu_torch.cli.run_pretrain_hdvila \\
        --config xpretrain_tpu_torch/configs/hdvila_pretrain_stage1.json \\
        --dummy_data 1 --num_train_steps 10 --output_dir output/hdvila_stage1
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from xpretrain_tpu_torch.cli.run_retrieval_clipvip import resolve_device
from xpretrain_tpu_torch.cli.shared_args import build_shared_parser, parse_args
from xpretrain_tpu_torch.data.datasets import FrameSource
from xpretrain_tpu_torch.data.datasets_hdvila import HdVilaPretrainCollator, HdVilaPretrainDataset
from xpretrain_tpu_torch.data.loader import BatchLoader, InfiniteIterator
from xpretrain_tpu_torch.data.tokenization import build_model_tokenizer, warn_if_hash_with_weights
from xpretrain_tpu_torch.models.bert import BertConfig
from xpretrain_tpu_torch.models.hd_vila.convert import flax_param_paths
from xpretrain_tpu_torch.models.hd_vila.e2e import HdVilaEncoder, HdVilaEncoderConfig
from xpretrain_tpu_torch.models.hd_vila.modeling import HdVilaForPreTraining, HdVilaModelConfig
from xpretrain_tpu_torch.models.hd_vila.resnet import FrozenBatchNorm
from xpretrain_tpu_torch.models.hd_vila.timesformer import DividedBlock
from xpretrain_tpu_torch.models.pretrained import load_hdvila_e2e
from xpretrain_tpu_torch.ops.losses import nce_loss
from xpretrain_tpu_torch.parallel.mesh import gather_rows, is_main_process, process_index_count, process_rank
from xpretrain_tpu_torch.train.checkpoints import save_training_meta
from xpretrain_tpu_torch.train.generic_trainer import GenericTrainer
from xpretrain_tpu_torch.utils.logging import LOGGER, setup_logging

DUMMY_SIZE = 1024  # synthetic pretraining samples (as the JAX runner)
METRIC_KEYS = ("itc_loss", "mlm_loss", "itm_loss", "mlm_acc", "itm_acc")


@torch.no_grad()
def init_hdvila_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init from ``generator`` (on the parameters' device) at the JAX
    package's scales: dense and conv kernels N(0, 1/fan_in), zero biases,
    embeddings N(0, 1/features), unit layer norms, identity frozen BNs
    (scale 1, bias 0, mean 0, var 1), the TimeSformer's ``pos_embed`` and the
    visual token-type embedding N(0, 0.02), zero ``time_embed``, and a zero
    ``temporal_fc`` in every TimeSformer block but the first."""
    for module in model.modules():
        if isinstance(module, (nn.Linear, nn.Conv2d)):
            module.weight.normal_(0.0, module.weight[0].numel() ** -0.5, generator=generator)
            if module.bias is not None:
                module.bias.zero_()
        elif isinstance(module, nn.LayerNorm):
            module.weight.fill_(1.0)
            module.bias.zero_()
        elif isinstance(module, nn.Embedding):
            module.weight.normal_(0.0, module.embedding_dim**-0.5, generator=generator)
        elif isinstance(module, FrozenBatchNorm):
            for p, value in ((module.scale, 1.0), (module.bias, 0.0), (module.mean, 0.0), (module.var, 1.0)):
                p.fill_(value)
    for module in model.modules():
        if isinstance(module, DividedBlock) and module.zero_init_temporal_fc:
            module.temporal_fc.weight.zero_()
    for name, p in model.named_parameters():
        if name.endswith(("pos_embed", "token_type_embedding")):
            p.normal_(0.0, 0.02, generator=generator)
        elif name.endswith("time_embed"):
            p.zero_()
    return model


class HdVilaPretrainModel(nn.Module):
    """Encoder + transformer + the stage-1 ITC loss in one module (the
    ``HDVILA`` wrapper role, ref ``e2e_model.py:16-93``)."""

    def __init__(self, enc_cfg: HdVilaEncoderConfig, model_cfg: HdVilaModelConfig, temp: float = 0.05,
                 device=None):
        super().__init__()
        self.model_cfg = model_cfg
        self.temp = temp
        self.encoder = HdVilaEncoder(enc_cfg, device)
        self.transformer = HdVilaForPreTraining(model_cfg, device)

    def init_weights(self, generator: torch.Generator) -> "HdVilaPretrainModel":
        return init_hdvila_weights(self, generator)

    def forward(
        self,
        img_middle: torch.Tensor,
        img_other: torch.Tensor,
        text_input_ids: torch.Tensor,
        text_input_mask: torch.Tensor,
        mlm_labels: Optional[torch.Tensor] = None,
        itm_labels: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        sample_indices: Optional[torch.Tensor] = None,
    ) -> dict[str, torch.Tensor]:
        grid = self.encoder(img_middle, img_other)
        out = self.transformer(grid, text_input_ids, text_input_mask, mlm_labels=mlm_labels,
                               itm_labels=itm_labels, generator=generator, sample_indices=sample_indices)
        if self.model_cfg.stage == 1:
            # over the global batch in a data-parallel group (parallel/mesh.py)
            out["itc_loss"] = nce_loss(gather_rows(out["vis_features"]), gather_rows(out["text_features"]), self.temp)
            out["loss"] = out["itc_loss"]
        else:
            zero = torch.zeros((), device=grid.device)
            out["loss"] = out.get("mlm_loss", zero) + out.get("itm_loss", zero)
        return out

    def forward_video(self, img_middle: torch.Tensor, img_other: torch.Tensor) -> torch.Tensor:
        """Video tower alone: hybrid encoder grid -> ITC projection (the video
        half of the stage-1 forward)."""
        return self.transformer.project_visual(self.encoder(img_middle, img_other))

    def forward_text(self, text_input_ids: torch.Tensor, text_input_mask: torch.Tensor) -> torch.Tensor:
        """Text tower alone (stage-0 BERT -> pooled -> t_proj -> L2)."""
        return self.transformer.forward_text(text_input_ids, text_input_mask)


def hdvila_configs_from(cfg) -> tuple[HdVilaEncoderConfig, HdVilaModelConfig]:
    """(encoder config, model config) of a run's config, as the JAX runner's
    ``hdvila_configs_from`` builds them."""
    dtype = torch.bfloat16 if cfg.get("bf16", True) else torch.float32
    # the trained pos-embed grid is (10, 16) = 640x1024/64 whatever the crop
    # (the model interpolates at other sizes, ref timesformer.py:486-511)
    ts_hw = tuple(cfg.get("timesformer_hw", (10, 16)))
    enc = HdVilaEncoderConfig(
        resnet_depth=int(cfg.get("resnet_depth", 50)),
        hidden_size=int(cfg.get("hidden_size", 1024)),
        timesformer_depth=int(cfg.get("timesformer_depth", 4)),
        timesformer_heads=int(cfg.get("timesformer_heads", 16)),
        timesformer_frames=int(cfg.get("num_frm", 7)),
        timesformer_hw=ts_hw,
        dtype=dtype,
        remat=bool(cfg.get("gradient_checkpointing", False)),
    )
    kind = cfg.get("bert", "large")
    if kind == "large":
        bert = BertConfig.bert_large(stage_bounds=(12,))
    elif kind == "base":
        bert = BertConfig.bert_base(stage_bounds=(6,))
    else:  # tiny debug
        bert = BertConfig(
            hidden_size=int(cfg.get("hidden_size", 64)),
            num_hidden_layers=4,
            num_attention_heads=4,
            intermediate_size=2 * int(cfg.get("hidden_size", 64)),
            vocab_size=int(cfg.get("vocab_size", 49408)),
            stage_bounds=(2,),
        )
    model = HdVilaModelConfig(
        bert=bert,
        stage=int(cfg.get("stage", 1)),
        pixel_random_sampling_size=int(cfg.get("pixel_random_sampling_size", 160)),
        temp=float(cfg.get("temp", 0.05)),
        score_agg_func=cfg.get("score_agg_func", "mean"),
        dtype=dtype,
    )
    return enc, model


def apply_stage2_batch_fallback(cfg, backend: str):
    """JAX's stage-2 rewrite of per-chip batches >= 16 into microbatches of 8
    with gradient accumulation, a workaround for a TPU compiler crash: it
    applies on the ``tpu`` backend only (``--stage2_b16_fallback 0`` opts
    out), so on ``cuda`` and ``cpu`` ``cfg`` stays as it is. A pure function
    of (cfg, backend), as JAX's."""
    b = int(cfg.get("train_batch_size", 32))
    if (
        int(cfg.get("stage", 1)) == 2
        and backend == "tpu"
        and bool(cfg.get("stage2_b16_fallback", 1))
        and b >= 16
        and int(cfg.get("gradient_accumulation_steps", 1)) == 1
        and b % 8 == 0
    ):
        cfg["gradient_accumulation_steps"] = b // 8
        cfg["train_batch_size"] = 8
        LOGGER.warning("stage-2 b=%d auto-fallback: %d microbatches of 8 with gradient accumulation", b, b // 8)
    return cfg


def load_e2e_weights(cfg, model: nn.Module) -> None:
    """``--e2e_weights_path`` (a reference HDVILA checkpoint) into ``model``,
    in place, shape-tolerantly (nothing without it)."""
    path = cfg.get("e2e_weights_path")
    if path:
        warn_if_hash_with_weights(cfg.get("tokenizer", "hash"), path)
        load_hdvila_e2e(model, path)


def build_loader(cfg, tokenizer, use_mlm: bool, use_itm: bool) -> InfiniteIterator:
    collate = HdVilaPretrainCollator(tokenizer, max_txt_len=int(cfg.get("max_txt_len", 50)), mlm=use_mlm,
                                     itm=use_itm, seed=cfg.seed)
    ds = HdVilaPretrainDataset(
        cfg.get("train_annotation") or None,
        FrameSource(cfg.video_root) if cfg.get("video_root") else None,
        train_n_clips=cfg.train_n_clips,
        num_frm=cfg.num_frm,
        sample_rate=cfg.sample_rate or 12,
        crop_hw=tuple(cfg.get("crop_size", (640, 1024))),
        seed=cfg.seed,
        synthetic_size=DUMMY_SIZE if cfg.get("dummy_data") else 0,
    )
    pi, pc = process_index_count()
    return InfiniteIterator(BatchLoader(ds, cfg.train_batch_size, collate, seed=cfg.seed, process_index=pi,
                                        process_count=pc))


def main(argv=None):
    parser = build_shared_parser("HD-VILA pretraining (PyTorch)")
    parser.add_argument("--stage", type=int, default=1, choices=[1, 2])
    parser.add_argument("--train_n_clips", type=int, default=2)
    parser.add_argument("--use_mlm", type=int, default=1)
    parser.add_argument("--use_itm", type=int, default=1,
                        help="stage-2 ITM; the reference stage-2 recipe disables it (pretrain_stage2.json use_itm: 0)")
    parser.add_argument("--stage2_b16_fallback", type=int, default=1,
                        help="JAX's grad-accum rewrite of stage-2 batches >= 16 on a TPU (never applies here)")
    parser.add_argument("--device", type=str, default="cuda", help="torch device: cuda, cuda:N or cpu")
    cfg = parse_args(parser, argv)
    device = resolve_device(cfg.device)
    cfg = apply_stage2_batch_fallback(cfg, device.type)
    setup_logging(cfg.output_dir, process_rank())
    if is_main_process():
        save_training_meta(cfg.output_dir, cfg)

    enc_cfg, model_cfg = hdvila_configs_from(cfg)
    stage2 = model_cfg.stage == 2
    use_mlm = stage2 and bool(cfg.get("use_mlm", 1))
    use_itm = stage2 and bool(cfg.get("use_itm", 1))
    tokenizer = build_model_tokenizer(cfg.get("tokenizer", "hash"), model_cfg.bert.vocab_size)
    loader = build_loader(cfg, tokenizer, use_mlm, use_itm)
    model = HdVilaPretrainModel(enc_cfg, model_cfg, temp=model_cfg.temp, device=device)
    model.init_weights(torch.Generator(device=device).manual_seed(int(cfg.seed)))
    load_e2e_weights(cfg, model)

    def apply_fn(m, batch, generator):
        return m(batch["img_middle"], batch["img_other"], batch["text_input_ids"], batch["text_input_mask"],
                 mlm_labels=batch["mlm_labels"] if use_mlm else None,
                 itm_labels=batch["itm_labels"] if use_itm else None, generator=generator)

    trainer = GenericTrainer(cfg, model, apply_fn, loader, metric_keys=METRIC_KEYS,
                             param_paths=flax_param_paths(model), device=device)
    LOGGER.info("HD-VILA stage %d pretraining on %s: %d steps at batch %d", model_cfg.stage, device,
                trainer.num_train_steps, cfg.train_batch_size)
    return trainer.train()


if __name__ == "__main__":
    main()
