"""Single-device train and eval steps (``xpretrain_tpu/parallel/train_step.py``).

The JAX step is one jitted SPMD program over a mesh; here one card runs it
eagerly, so the global contrastive batch is the local batch. The train step
updates the model's parameters and the optimizer's state in place (JAX
returns new arrays; in place saves a copy of every parameter and moment).
``steps_per_call > 1`` (K steps chained in one ``lax.scan`` dispatch) and the
mesh layouts (tensor parallel, FSDP) are not ported; ``zero2`` shards the
optimizer state over the data axis, which on one device holds everything, so
it is accepted and changes nothing.
"""

from __future__ import annotations

import dataclasses
from typing import Callable

import numpy as np
import torch
from torch import nn

from xpretrain_tpu_torch.optim.optimizer import LOGIT_SCALE_MAX, GroupedAdamW, clamp_logit_scale, global_norm
from xpretrain_tpu_torch.utils.logging import LOGGER


@dataclasses.dataclass
class TrainState:
    """``step`` counts train-step calls; the parameters live in ``model`` and
    the Adam state in ``optimizer``."""

    step: int
    model: nn.Module
    optimizer: GroupedAdamW


def contrastive_loss_from_outputs(outputs: dict, loss_fn: Callable) -> torch.Tensor:
    """Dispatch model outputs into a loss-zoo function by its signature kind."""
    kind = getattr(loss_fn, "signature_kind", "pair_scale")
    if kind == "pair_temp":
        return loss_fn(outputs["vis_features"], outputs["text_features"])
    if kind == "pair_scale":
        return loss_fn(outputs["vis_features"], outputs["text_features"], outputs["logit_scale"])
    if kind == "quad_scale":
        return loss_fn(
            outputs["vis_features"],
            outputs["text_features"],
            outputs.get("img_features", outputs["vis_features"]),
            outputs.get("cap_features", outputs["text_features"]),
            outputs["logit_scale"],
        )
    raise ValueError(f"unknown loss signature {kind!r}")


def batch_to_device(device: torch.device | str) -> Callable[[dict], dict]:
    """numpy batch -> tensors on ``device``, through pinned memory with
    ``non_blocking`` copies on CUDA."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def to_device(x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    def place(batch: dict) -> dict:
        return {k: to_device(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}

    return place


def make_train_step(
    apply_fn: Callable[[nn.Module, dict, torch.Generator], dict],
    loss_fn: Callable,
    device: torch.device | str,
    steps_per_call: int = 1,
    zero2: bool = False,
) -> Callable[[TrainState, dict, int], tuple[TrainState, dict]]:
    """Build ``step(state, batch, seed) -> (state, metrics)``.

    ``apply_fn(model, batch, generator)`` returns the feature dict that
    ``loss_fn`` takes (:func:`contrastive_loss_from_outputs`); ``batch`` holds
    tensors on ``device``; ``seed`` seeds the step's dropout generator. In
    order: clamp logit_scale to [0, ln 200], forward, loss, backward,
    update, clamp. The metrics (``loss``, ``grad_norm`` of the raw
    gradients, ``logit_scale`` of the forward) stay 0-d device tensors, so
    the step does not wait for the card."""
    if steps_per_call > 1:
        raise NotImplementedError(
            "steps_per_call > 1 (K steps in one dispatch) is not ported; run with 1"
        )
    if zero2:
        LOGGER.info("zero2: one device holds the whole optimizer state; nothing to shard")
    device = torch.device(device)

    def step_fn(state: TrainState, batch: dict, seed: int) -> tuple[TrainState, dict]:
        model = state.model
        named = dict(model.named_parameters())
        # clamp before the forward, as the reference does each iteration
        clamp_logit_scale(named, LOGIT_SCALE_MAX)
        model.train()
        for p in named.values():
            p.grad = None
        generator = torch.Generator(device=device).manual_seed(int(seed))
        outputs = apply_fn(model, batch, generator)
        loss = contrastive_loss_from_outputs(outputs, loss_fn)
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in named.values()]
        metrics = {
            "loss": loss.detach(),
            "grad_norm": global_norm(grads),
            "logit_scale": outputs["logit_scale"].detach().clone(),
        }
        # the metric's norm is the one clipping needs: one pass, not two
        state.optimizer.step(grads, metrics["grad_norm"])
        for p in named.values():
            p.grad = None
        clamp_logit_scale(named, LOGIT_SCALE_MAX)
        state.step += 1
        return state, metrics

    return step_fn


def make_model_train_step(
    apply_fn: Callable[[nn.Module, dict, torch.Generator], dict],
    device: torch.device | str,
    loss_key: str = "loss",
    metric_keys: tuple[str, ...] = (),
    steps_per_call: int = 1,
) -> Callable[[TrainState, dict, int], tuple[TrainState, dict]]:
    """Build ``step(state, batch, seed) -> (state, metrics)`` for models that
    compute their own loss (LF-VILA; ``GenericTrainer`` drives it).

    ``apply_fn(model, batch, generator)`` returns a dict holding ``loss_key``;
    the ``metric_keys`` it also holds are copied (detached) into the metrics,
    beside ``loss`` (fp32) and ``grad_norm`` of the raw gradients. In order:
    forward, backward, update."""
    if steps_per_call > 1:
        raise NotImplementedError(
            "steps_per_call > 1 (K steps in one dispatch) is not ported; run with 1"
        )
    device = torch.device(device)

    def step_fn(state: TrainState, batch: dict, seed: int) -> tuple[TrainState, dict]:
        model = state.model
        params = list(model.parameters())
        model.train()
        for p in params:
            p.grad = None
        generator = torch.Generator(device=device).manual_seed(int(seed))
        outputs = apply_fn(model, batch, generator)
        loss = outputs[loss_key].float()
        loss.backward()
        grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
        metrics = {"loss": loss.detach(), "grad_norm": global_norm(grads)}
        for key in metric_keys:
            if key in outputs:
                metrics[key] = outputs[key].detach()
        state.optimizer.step(grads, metrics["grad_norm"])
        for p in params:
            p.grad = None
        state.step += 1
        return state, metrics

    return step_fn


CLIPVIP_EVAL_IO = (("video", "text_input_ids", "text_input_mask"),
                   {"vis_features": "vis_features", "text_features": "text_features"})
# LF-VILA batches and outputs (``_rename`` of ``xpretrain_tpu/cli/run_tasks_lfvila.py``)
LFVILA_EVAL_IO = (("video_frames", "text_ids", "attention_mask"),
                  {"vis_features": "video_global_feat", "text_features": "text_global_feat"})


def make_eval_step(device: torch.device | str, io: tuple = CLIPVIP_EVAL_IO
                   ) -> Callable[[nn.Module, dict], dict]:
    """Forward of one numpy batch on ``device``: ``step(model, batch)``.

    ``io`` is (the batch keys the model takes, in order; {feature name:
    model output key}). The batch goes to the device through pinned memory
    with ``non_blocking`` copies; the forward runs under ``inference_mode``;
    the features come back as fp32 numpy under the names of
    ``xpretrain_tpu_torch.train.evaluate.evaluate_retrieval``."""
    place = batch_to_device(device)
    inputs, outputs = io

    def eval_step(model: nn.Module, batch: dict) -> dict[str, np.ndarray]:
        with torch.inference_mode():
            b = place({k: batch[k] for k in inputs})
            out = model(*(b[k] for k in inputs))
            return {name: out[key].float().cpu().numpy() for name, key in outputs.items()}

    return eval_step
