"""Generic trainer for models that compute their own loss
(``xpretrain_tpu/train/generic_trainer.py``), on one device or on each rank
of a group (as ``ClipVipTrainer``: the model laid out for ``--tp``, ``--cp``
and ``--zero3``, ZeRO-2 under ``--zero2``, rank 0 writes).

The LF-VILA and HD-VILA counterpart of ``ClipVipTrainer``: the step
loop with :func:`make_model_train_step`, the LR schedule, grouped AdamW,
periodic checkpoints and resume, scalar logging, and an optional eval
callback with best-model tracking. As in JAX there is no validation at
start; with ``num_train_steps`` 0 the loop takes no step, so neither the
schedule nor the optimizer is evaluated.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import torch
from torch import nn

from xpretrain_tpu_torch.optim.optimizer import (
    NO_DECAY_DEFAULT,
    build_optimizer,
    cast_params_for_storage,
    master_weights,
    moment_dtype_from_cfg,
    param_dtype_from_cfg,
)
from xpretrain_tpu_torch.optim.schedules import get_schedule
from xpretrain_tpu_torch.parallel.fsdp import apply_layouts, gathered
from xpretrain_tpu_torch.parallel.mesh import is_main_process, process_rank
from xpretrain_tpu_torch.parallel.train_step import TrainState, batch_to_device, make_model_train_step
from xpretrain_tpu_torch.train.checkpoints import BestModelSaver, CheckpointManager
from xpretrain_tpu_torch.train.loop import drive_train_loop
from xpretrain_tpu_torch.train.trainer import shard_optimizer
from xpretrain_tpu_torch.utils.logging import LOGGER, RunningMeter, ScalarWriter


class GenericTrainer:
    """Drive any ``apply_fn(model, batch, generator) -> {..., "loss"}`` model.

    ``param_paths`` maps parameter names to their flax paths, where the
    optimizer's no-decay and freeze patterns are matched (for LF-VILA,
    ``models/lf_vila/convert.py:flax_param_paths``)."""

    def __init__(
        self,
        cfg,
        model: nn.Module,
        apply_fn: Callable[[nn.Module, dict, torch.Generator], dict],
        train_loader,
        eval_fn: Optional[Callable[[nn.Module], dict]] = None,
        metric_keys: tuple[str, ...] = (),
        no_decay_patterns: Optional[Sequence[str]] = None,
        param_paths: Optional[Mapping[str, str]] = None,
        device: torch.device | str = "cuda",
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.layouts = apply_layouts(cfg, model)
        self.model = model
        self.apply_fn = apply_fn
        self.metric_keys = metric_keys
        self.train_loader = train_loader
        self.eval_fn = eval_fn

        out_dir = cfg.get("output_dir", "output")
        main = is_main_process()
        self.ckpt = CheckpointManager(
            f"{out_dir}/ckpt", max_to_keep=2, async_save=bool(cfg.get("async_checkpoint", False)), write=main
        )
        self.best = BestModelSaver(out_dir, write=main)
        self.writer = ScalarWriter(f"{out_dir}/log", process_rank())
        self.meter = RunningMeter("train_loss")

        accum = int(cfg.get("gradient_accumulation_steps", 1))
        num_steps = int(cfg.get("num_train_steps", 1000))
        schedule = get_schedule(
            cfg.get("decay", "cosine"),
            float(cfg.get("learning_rate", 5e-5)),
            num_steps,
            warmup_ratio=float(cfg.get("warmup_ratio", 0.1)),
        )
        self.optimizer, _ = build_optimizer(
            dict(model.named_parameters()),
            schedule,
            weight_decay=float(cfg.get("weight_decay", 0.01)),
            betas=tuple(cfg.get("betas", (0.9, 0.98))),
            lr_mul=float(cfg.get("lr_mul", 1.0)),
            lr_mul_prefix=cfg.get("lr_mul_prefix", ""),
            max_grad_norm=float(cfg.get("grad_norm", 1.0)),
            no_decay_patterns=NO_DECAY_DEFAULT if no_decay_patterns is None else no_decay_patterns,
            grad_accum_steps=accum,
            frozen_patterns=tuple(cfg.get("frozen_patterns", ())),
            moment_dtype=moment_dtype_from_cfg(cfg),
            paths=param_paths,
        )
        pd = param_dtype_from_cfg(cfg)
        if pd is not None:
            # --param_dtype bf16: store the parameters reduced, with fp32
            # masters in the optimizer (optim.master_weights)
            cast_params_for_storage(model, pd)
            self.optimizer = master_weights(self.optimizer)
        self.optimizer = shard_optimizer(cfg, self.optimizer, self.layouts)
        self.num_train_steps = num_steps * accum
        self.steps_per_call = max(1, int(cfg.get("steps_per_call", 1)))
        self.train_step = make_model_train_step(
            apply_fn, self.device, metric_keys=metric_keys, steps_per_call=self.steps_per_call,
        )
        self.place_batch = batch_to_device(self.device)

    def train(self) -> TrainState:
        cfg = self.cfg
        state = TrainState(step=0, model=self.model, optimizer=self.optimizer)
        restored = self.ckpt.restore()
        if restored is not None:
            self.model.load_state_dict(restored["model"])
            self.optimizer.load_state_dict(restored["optimizer"])
            state.step = int(restored["step"])
        else:  # weights loaded into the stored copies since __init__
            self.optimizer.sync_masters()
        batches = iter(self.train_loader)
        if state.step:
            # as ClipVipTrainer: skip the batches an unbroken run took
            LOGGER.info("resuming at step %d: skipping %d train batches", state.step, state.step)
            for _ in range(state.step):
                next(batches)

        def on_log(step, metrics, sps):
            loss = float(metrics["loss"])
            self.meter(loss)
            LOGGER.info("step %d/%d loss %.4f | %.2f steps/s", step, self.num_train_steps, loss, sps)
            scalars = {k: float(v) for k, v in metrics.items() if v.dim() == 0}
            scalars["steps_per_s"] = sps
            self.writer.log_scalar_dict(scalars, prefix="train", step=step)

        def on_validate(step, state):
            if self.eval_fn is None:
                return
            with gathered(state.model):
                report = self.eval_fn(state.model)
            self.best.maybe_save(step, report.get("score", 0.0), state.model)
            self.writer.log_scalar_dict(
                {k: v for k, v in report.items() if isinstance(v, (int, float))}, prefix="val", step=step
            )

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
            seed=int(cfg.get("seed", 0)) + 1,
            num_train_steps=self.num_train_steps,
            steps_per_call=self.steps_per_call,
            log_every=int(cfg.get("log_steps", 20)),
            valid_every=int(cfg.get("valid_steps", 500)),
            save_every=int(cfg.get("save_steps", 500)),
            on_log=on_log,
            on_validate=on_validate,
            on_save=on_save,
            on_step=(lambda step: self.ckpt.poll()) if self.ckpt.async_save else None,
            profile_dir=f"{cfg.get('output_dir', 'output')}/profile",
            profile_start_step=int(cfg.get("profile_start_step", 3)),
            profile_num_steps=int(cfg.get("profile_steps", 0)),
        )
        self.writer.flush()
        self.ckpt.wait()  # drain an in-flight async checkpoint
        return state
