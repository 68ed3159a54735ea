"""Generic trainer for models that compute their own loss
(``xpretrain_tpu/train/generic_trainer.py``), on one device or on each rank
of a data-parallel group; the base of ``train/trainer.py:ClipVipTrainer``.

The step loop with :func:`make_model_train_step`, the LR schedule, grouped
AdamW, periodic checkpoints and resume, scalar logging, and an optional eval
callback with best-model tracking. As in JAX there is no validation at
start; with ``num_train_steps`` 0 the loop takes no step, so neither the
schedule nor the optimizer is evaluated.

In a group (``parallel/mesh.py``) each rank trains on its loader's share of
the global batch; ``--tp``, ``--cp`` and ``--zero3`` lay the model out on
the mesh as JAX's ``resolve_shardings`` does (``parallel/fsdp.py:
apply_layouts``), before the optimizer is built; ``--zero2`` then shards the
state of the leaves the layouts leave whole (``optim/optimizer.py:
zero2_shard``, leaves of at least JAX's 16384 elements); rank 0 alone writes
the scalars, checkpoints (of the gathered state, in the reference layout)
and best models.
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
    zero2_shard,
)
from xpretrain_tpu_torch.optim.schedules import get_schedule
from xpretrain_tpu_torch.parallel.fsdp import apply_layouts, gathered
from xpretrain_tpu_torch.parallel.mesh import is_main_process, process_rank
from xpretrain_tpu_torch.parallel.train_step import TrainState, batch_to_device, make_model_train_step
from xpretrain_tpu_torch.train.checkpoints import BestModelSaver, CheckpointManager
from xpretrain_tpu_torch.train.loop import drive_train_loop
from xpretrain_tpu_torch.utils.logging import LOGGER, RunningMeter, ScalarWriter


class GenericTrainer:
    """Drive any ``apply_fn(model, batch, generator) -> {..., "loss"}`` model.

    ``param_paths`` maps parameter names to their flax paths, where the
    optimizer's no-decay and freeze patterns are matched (for LF-VILA,
    ``models/lf_vila/convert.py:flax_param_paths``). ``metric_keys`` are the
    outputs the step copies into its metrics; every 0-d metric is logged."""

    # What a family sets differently (JAX's two trainers): the defaults of
    # three cfg keys, the train scalars logged (None: every 0-d metric, then
    # steps_per_s), the eval's prefix and whether it also runs at start.
    DEFAULTS = {"learning_rate": 5e-5, "weight_decay": 0.01, "grad_norm": 1.0}
    TRAIN_SCALARS: Optional[tuple[str, ...]] = None
    VAL_PREFIX = "val"
    VALIDATE_AT_START = False

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
            float(cfg.get("learning_rate", self.DEFAULTS["learning_rate"])),
            num_steps,
            warmup_ratio=float(cfg.get("warmup_ratio", 0.1)),
        )
        self.optimizer, _ = build_optimizer(
            dict(model.named_parameters()),
            schedule,
            weight_decay=float(cfg.get("weight_decay", self.DEFAULTS["weight_decay"])),
            betas=tuple(cfg.get("betas", (0.9, 0.98))),
            lr_mul=float(cfg.get("lr_mul", 1.0)),
            lr_mul_prefix=cfg.get("lr_mul_prefix", ""),
            max_grad_norm=float(cfg.get("grad_norm", self.DEFAULTS["grad_norm"])),
            no_decay_patterns=NO_DECAY_DEFAULT if no_decay_patterns is None else no_decay_patterns,
            grad_accum_steps=accum,
            moment_dtype=moment_dtype_from_cfg(cfg),
            paths=param_paths,
            **self._optimizer_options(),
        )
        pd = param_dtype_from_cfg(cfg)
        if pd is not None:
            # --param_dtype bf16: store the parameters reduced, with fp32
            # masters in the optimizer (optim.master_weights)
            cast_params_for_storage(model, pd)
            self.optimizer = master_weights(self.optimizer)
        if self.layouts:
            self.optimizer.set_layouts(self.layouts)
        if cfg.get("zero2", False):
            self.optimizer = zero2_shard(self.optimizer)
        self.num_train_steps = num_steps * accum
        self.steps_per_call = max(1, int(cfg.get("steps_per_call", 1)))
        self.train_step = self._make_train_step()
        self.place_batch = batch_to_device(self.device)

    # ---- what a family overrides --------------------------------------------

    def _optimizer_options(self) -> dict:
        """The family's own ``build_optimizer`` arguments."""
        return {"frozen_patterns": tuple(self.cfg.get("frozen_patterns", ()))}

    def _make_train_step(self):
        return make_model_train_step(
            self.apply_fn, self.device, metric_keys=self.metric_keys, steps_per_call=self.steps_per_call,
        )

    def _val_report(self) -> Optional[tuple[dict, float]]:
        """The eval of the model as it stands: (the scalars logged under
        ``VAL_PREFIX``, the score the best model is chosen by); None without
        an eval."""
        if self.eval_fn is None:
            return None
        with gathered(self.model):
            report = self.eval_fn(self.model)
        return {k: v for k, v in report.items() if isinstance(v, (int, float))}, report.get("score", 0.0)

    # ---- the loop -------------------------------------------------------------

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
            # the JAX trainers replay the loader from its start; skipping the
            # batches an unbroken run took makes a resumed run equal to it
            LOGGER.info("resuming at step %d: skipping %d train batches", state.step, state.step)
            for _ in range(state.step):
                next(batches)

        if self.VALIDATE_AT_START and cfg.get("validate_at_start", True):
            report = self._val_report()
            if report is not None:
                self.writer.log_scalar_dict(report[0], prefix=self.VAL_PREFIX, step=state.step)

        def on_log(step, metrics, sps):
            loss = float(metrics["loss"])
            self.meter(loss)
            LOGGER.info("step %d/%d loss %.4f | %.2f steps/s", step, self.num_train_steps, loss, sps)
            names = self.TRAIN_SCALARS or (*(k for k, v in metrics.items() if v.dim() == 0), "steps_per_s")
            self.writer.log_scalar_dict(
                {k: sps if k == "steps_per_s" else float(metrics[k]) for k in names}, prefix="train", step=step
            )

        def on_validate(step, state):
            report = self._val_report()
            if report is None:
                return
            scalars, score = report
            self.best.maybe_save(step, score, state.model)
            self.writer.log_scalar_dict(scalars, prefix=self.VAL_PREFIX, step=step)

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
