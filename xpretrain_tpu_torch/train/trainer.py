"""The CLIP-ViP retrieval fine-tune trainer on one device
(``xpretrain_tpu/train/trainer.py``).

Model and optimizer set-up, resume, the train step, validation with
best-model tracking, periodic checkpoints and scalar logging, as the JAX
``ClipVipTrainer``; validation at step 0 is kept as the end-to-end smoke
test (ref ``run_pretrain.py:321-322``). Parameters come from ``--seed`` or
from a JAX ``{"params": ...}`` tree (``load_jax_params``); the runners merge a
torch checkpoint over them before ``train()`` (``load_pretrained``), and a
checkpoint that ``train()`` resumes from wins over both. A batch with
``image`` (pretraining) also runs the image/caption branch.
"""

from __future__ import annotations

from typing import Any, Mapping, Optional

import torch

from xpretrain_tpu_torch.models.clip_vip.convert import flax_param_paths, load_jax_params
from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel, VipConfig
from xpretrain_tpu_torch.ops.losses import build_loss_fn
from xpretrain_tpu_torch.optim.optimizer import build_optimizer, check_param_dtype, moment_dtype_from_cfg
from xpretrain_tpu_torch.optim.schedules import get_schedule
from xpretrain_tpu_torch.parallel.train_step import (
    TrainState,
    batch_to_device,
    make_eval_step,
    make_train_step,
)
from xpretrain_tpu_torch.train.checkpoints import BestModelSaver, CheckpointManager
from xpretrain_tpu_torch.train.evaluate import evaluate_retrieval
from xpretrain_tpu_torch.train.loop import drive_train_loop
from xpretrain_tpu_torch.utils.logging import LOGGER, RunningMeter, ScalarWriter


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


def check_single_device(cfg) -> None:
    """The mesh layouts (--tp, --cp, --zero3) are not ported: raise on them."""
    for key in ("tp", "cp"):
        if int(cfg.get(key, 1) or 1) > 1:
            raise NotImplementedError(f"--{key} > 1 (a multi-device mesh) is not ported yet (ROADMAP Queue 1)")
    if cfg.get("zero3"):
        raise NotImplementedError("--zero3 (FSDP) is not ported yet (ROADMAP Queue 1)")


class ClipVipTrainer:
    """End-to-end CLIP-ViP training on one device.

    ``fused_adamw`` is read and ignored, on purpose: JAX picks between two
    optimizer-state layouts of the same AdamW update with it (and, on
    resume, follows the layout the checkpoint was written with,
    ``xpretrain_tpu/train/trainer.py``), while the port has one layout,
    ``GroupedAdamW``'s; its checkpoints are torch files that JAX cannot
    read, so there is no other layout to follow on resume."""

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
        check_single_device(cfg)
        check_param_dtype(cfg)
        self.cfg = cfg
        self.device = torch.device(device)
        self.train_loader = train_loader
        self.val_loader = val_loader
        self.val_valid_len = val_valid_len

        # ---- params: from the seed, or a JAX {"params": ...} tree ----
        self.model = CLIPViPModel(model_cfg or clip_vip_config_from(cfg), device=self.device)
        if init_params is None:
            generator = torch.Generator(device=self.device).manual_seed(int(cfg.get("seed", 0)))
            self.model.init_weights(generator)
        else:
            load_jax_params(self.model, init_params)

        # ---- io ----
        out_dir = cfg.get("output_dir", "output")
        self.ckpt = CheckpointManager(
            f"{out_dir}/ckpt", max_to_keep=2, async_save=bool(cfg.get("async_checkpoint", False))
        )
        self.best = BestModelSaver(out_dir)
        self.writer = ScalarWriter(f"{out_dir}/log", 0)
        self.meter = RunningMeter("train_loss")

        # ---- optimizer ----
        accum = int(cfg.get("gradient_accumulation_steps", 1))
        num_steps = int(cfg.get("num_train_steps", 1000))
        schedule = get_schedule(
            cfg.get("decay", "cosine"),
            float(cfg.get("learning_rate", 5e-6)),
            num_steps,
            warmup_ratio=float(cfg.get("warmup_ratio", 0.1)),
        )
        frozen = list(cfg.get("frozen_patterns", ()))
        if cfg.get("freeze_text_model"):
            # VidCLIP.freeze_text_encoder (ref VidCLIP.py:96-103)
            frozen.append("text_model")
            if cfg.get("freeze_text_proj"):
                frozen.append("text_projection")
        self.optimizer, _ = build_optimizer(
            dict(self.model.named_parameters()),
            schedule,
            weight_decay=float(cfg.get("weight_decay", 0.2)),
            betas=tuple(cfg.get("betas", (0.9, 0.98))),
            lr_mul=float(cfg.get("lr_mul", 1.0)),
            lr_mul_prefix=cfg.get("lr_mul_prefix", ""),
            max_grad_norm=float(cfg.get("grad_norm", 2.0)),
            grad_accum_steps=accum,
            frozen_patterns=tuple(frozen),
            moment_dtype=moment_dtype_from_cfg(cfg),
            paths=flax_param_paths(self.model.config),
        )
        self.num_train_steps = num_steps * accum

        loss_fn = build_loss_fn(cfg.get("loss_name", "NCELearnableTempLoss"))
        self.train_step = make_train_step(
            self._apply_train, loss_fn, self.device,
            steps_per_call=int(cfg.get("steps_per_call", 1)),
            zero2=bool(cfg.get("zero2", False)),
        )
        self.eval_step = make_eval_step(self.device)
        self.place_batch = batch_to_device(self.device)

    # ---- model plumbing -------------------------------------------------

    @staticmethod
    def _apply_train(model: CLIPViPModel, batch: dict, generator: torch.Generator) -> dict:
        """The forward of a train step; a pretraining batch (one with
        ``image``) also runs the image/caption branch."""
        kwargs = {}
        if "image" in batch:
            kwargs = {k: batch[k] for k in ("image", "caption_ids", "caption_masks")}
        return model(batch["video"], batch["text_input_ids"], batch["text_input_mask"], generator=generator,
                     **kwargs)

    # ---- loops ----------------------------------------------------------

    def validate(self, save_feats_path: Optional[str] = None) -> dict:
        """Retrieval eval of the model as it stands; {} without a val loader."""
        if self.val_loader is None:
            return {}
        was_training = self.model.training
        self.model.eval()
        try:
            return evaluate_retrieval(
                self.eval_step, self.model, self.val_loader, self.val_valid_len,
                save_feats_path=save_feats_path,
            )
        finally:
            self.model.train(was_training)

    def train(self) -> TrainState:
        state = TrainState(step=0, model=self.model, optimizer=self.optimizer)
        restored = self.ckpt.restore()
        if restored is not None:
            self.model.load_state_dict(restored["model"])
            self.optimizer.load_state_dict(restored["optimizer"])
            state.step = int(restored["step"])
        start_step = state.step
        batches = iter(self.train_loader)
        if start_step:
            # the JAX trainer replays the loader from its start; skipping the
            # batches an unbroken run took makes a resumed run equal to it
            LOGGER.info("resuming at step %d: skipping %d train batches", start_step, start_step)
            for _ in range(start_step):
                next(batches)

        if self.cfg.get("validate_at_start", True) and self.val_loader is not None:
            report = self.validate()
            if report:
                self.writer.log_scalar_dict(report.get("t2v", {}), prefix="val_t2v", step=start_step)

        def on_log(step, metrics, sps):
            loss = float(metrics["loss"])
            self.meter(loss)
            LOGGER.info("step %d/%d loss %.4f | %.2f steps/s", step, self.num_train_steps, loss, sps)
            self.writer.log_scalar_dict(
                {"loss": loss, "steps_per_s": sps, "grad_norm": float(metrics["grad_norm"])},
                prefix="train",
                step=step,
            )

        def on_validate(step, state):
            if self.val_loader is None:
                return
            report = self.validate()
            score = report.get("t2v", {}).get("R1", 0.0)
            params = {k: v.detach().cpu() for k, v in state.model.state_dict().items()}
            self.best.maybe_save(step, score, params)
            self.writer.log_scalar_dict(report.get("t2v", {}), prefix="val_t2v", step=step)

        def on_save(step, state):
            self.ckpt.save(step, {
                "step": state.step,
                "model": state.model.state_dict(),
                "optimizer": state.optimizer.state_dict(),
            })

        state = drive_train_loop(
            train_step=self.train_step,
            loader=batches,
            state=state,
            place_batch=self.place_batch,
            seed=int(self.cfg.get("seed", 0)) + 1,
            num_train_steps=self.num_train_steps,
            log_every=int(self.cfg.get("log_steps", 20)),
            valid_every=int(self.cfg.get("valid_steps", 500)),
            save_every=int(self.cfg.get("save_steps", 500)),
            on_log=on_log,
            on_validate=on_validate,
            on_save=on_save,
            profile_dir=f"{self.cfg.get('output_dir', 'output')}/profile",
            profile_start_step=int(self.cfg.get("profile_start_step", 3)),
            profile_num_steps=int(self.cfg.get("profile_steps", 0)),
        )
        self.writer.flush()
        return state
