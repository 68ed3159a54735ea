"""The CLIP-ViP retrieval fine-tune trainer (``xpretrain_tpu/train/trainer.py``),
on one device or on each rank of a data-parallel group.

A :class:`GenericTrainer` (set-up, resume, the loop, checkpoints, scalar
logging, the group's layouts and ZeRO-2) with CLIP-ViP's own parts: the
model built from the config, the contrastive loss through
``make_train_step``, JAX's optimizer defaults, and validation with
best-model tracking by text-to-video R1; validation at step 0 is kept as the
end-to-end smoke test (ref ``run_pretrain.py:321-322``). Parameters come
from ``--seed`` or from a JAX ``{"params": ...}`` tree (``load_jax_params``);
the runners merge a torch checkpoint over them before ``train()``
(``load_pretrained``), and a checkpoint that ``train()`` resumes from wins
over both. A batch with ``image`` (pretraining) also runs the image/caption
branch.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from xpretrain_tpu_torch.models.clip_vip.convert import flax_param_paths, load_jax_params
from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel, VipConfig
from xpretrain_tpu_torch.ops.losses import build_loss_fn
from xpretrain_tpu_torch.parallel.fsdp import gathered
from xpretrain_tpu_torch.parallel.train_step import make_eval_step, make_train_step
from xpretrain_tpu_torch.train.evaluate import evaluate_retrieval
from xpretrain_tpu_torch.train.generic_trainer import GenericTrainer


def clip_vip_config_from(cfg) -> CLIPVipConfig:
    """Build a model config from a ConfigDict-style training config."""
    vip = cfg.get("clip_vision_additional_config", {})
    size = cfg.get("clip_size", "base_32")
    factory = {
        "base_32": CLIPVipConfig.base_patch32,
        "base_16": CLIPVipConfig.base_patch16,
        "large_14": CLIPVipConfig.large_patch14,
        "tiny": lambda **kw: CLIPVipConfig.tiny_debug(
            image_size=int(cfg.get("crop_img_size", 32)), **kw
        ),
    }[size]
    return factory(
        vip=VipConfig(
            type=vip.get("type", "ViP"),
            temporal_size=int(vip.get("temporal_size", 12)),
            if_use_temporal_embed=bool(vip.get("if_use_temporal_embed", 1)),
            add_cls_num=int(vip.get("add_cls_num", 3)),
            logit_scale_init_value=float(vip.get("logit_scale_init_value", 4.60)),
        ),
        dtype=torch.bfloat16 if cfg.get("bf16", True) else torch.float32,
        remat=bool(cfg.get("gradient_checkpointing", False)),
    )


class ClipVipTrainer(GenericTrainer):
    """End-to-end CLIP-ViP training.

    ``fused_adamw`` goes to ``build_optimizer``, which raises, as JAX does,
    on ``moment_dtype bf16`` with ``fused_adamw 0``. Otherwise it changes
    nothing: JAX picks between two optimizer-state layouts of the same AdamW
    update with it (and, on resume, follows the layout the checkpoint was
    written with, ``xpretrain_tpu/train/trainer.py``), while the port has
    one layout, ``GroupedAdamW``'s; its checkpoints are torch files that JAX
    cannot read, so there is no other layout to follow on resume."""

    DEFAULTS = {"learning_rate": 5e-6, "weight_decay": 0.2, "grad_norm": 2.0}
    TRAIN_SCALARS = ("loss", "steps_per_s", "grad_norm")
    VAL_PREFIX = "val_t2v"
    VALIDATE_AT_START = True

    def __init__(
        self,
        cfg,
        train_loader,
        val_loader=None,
        val_valid_len: Optional[int] = None,
        model_cfg: Optional[CLIPVipConfig] = None,
        init_params: Optional[Mapping[str, Any]] = None,
        device: torch.device | str = "cuda",
    ):
        self.val_loader = val_loader
        self.val_valid_len = val_valid_len
        # ---- params: from the seed, or a JAX {"params": ...} tree ----
        device = torch.device(device)
        model = CLIPViPModel(model_cfg or clip_vip_config_from(cfg), device=device)
        if init_params is None:
            model.init_weights(torch.Generator(device=device).manual_seed(int(cfg.get("seed", 0))))
        else:
            load_jax_params(model, init_params)
        super().__init__(cfg, model, self._apply_train, train_loader, metric_keys=("logit_scale",),
                         param_paths=flax_param_paths(model.config), device=device)
        self.eval_step = make_eval_step(self.device)

    def _optimizer_options(self) -> dict:
        frozen = list(self.cfg.get("frozen_patterns", ()))
        if self.cfg.get("freeze_text_model"):
            # VidCLIP.freeze_text_encoder (ref VidCLIP.py:96-103)
            frozen.append("text_model")
            if self.cfg.get("freeze_text_proj"):
                frozen.append("text_projection")
        return {"frozen_patterns": tuple(frozen), "fused": bool(self.cfg.get("fused_adamw", True))}

    def _make_train_step(self):
        loss_fn = build_loss_fn(self.cfg.get("loss_name", "NCELearnableTempLoss"))
        return make_train_step(self.apply_fn, loss_fn, self.device, steps_per_call=self.steps_per_call)

    @staticmethod
    def _apply_train(model: CLIPViPModel, batch: dict, generator: torch.Generator) -> dict:
        """The forward of a train step; a pretraining batch (one with
        ``image``) also runs the image/caption branch."""
        kwargs = {}
        if "image" in batch:
            kwargs = {k: batch[k] for k in ("image", "caption_ids", "caption_masks")}
        return model(batch["video"], batch["text_input_ids"], batch["text_input_mask"], generator=generator,
                     **kwargs)

    def validate(self, save_feats_path: Optional[str] = None) -> dict:
        """Retrieval eval of the model as it stands; {} without a val loader."""
        if self.val_loader is None:
            return {}
        was_training = self.model.training
        self.model.eval()
        try:
            with gathered(self.model):
                return evaluate_retrieval(
                    self.eval_step, self.model, self.val_loader, self.val_valid_len,
                    save_feats_path=save_feats_path,
                )
        finally:
            self.model.train(was_training)

    def _val_report(self) -> Optional[tuple[dict, float]]:
        if self.val_loader is None:
            return None
        t2v = self.validate().get("t2v", {})
        return t2v, t2v.get("R1", 0.0)
