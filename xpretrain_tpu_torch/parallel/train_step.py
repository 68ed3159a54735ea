"""Single-device eval step (``xpretrain_tpu/parallel/train_step.py``).

The train step comes with the training slice; the mesh-sharded variants
with the multi-card work."""

from __future__ import annotations

from typing import Callable

import numpy as np
import torch
from torch import nn


def make_eval_step(device: torch.device | str) -> Callable[[nn.Module, dict], dict]:
    """Forward of one numpy batch on ``device``: ``step(model, batch)``.

    The batch goes to the device through pinned memory with
    ``non_blocking`` copies; the forward runs under ``inference_mode``; the
    features come back as fp32 numpy, the contract of
    ``xpretrain_tpu.train.evaluate.evaluate_retrieval``."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def to_device(x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    def eval_step(model: nn.Module, batch: dict) -> dict[str, np.ndarray]:
        with torch.inference_mode():
            out = model(
                to_device(batch["video"]),
                to_device(batch["text_input_ids"]),
                to_device(batch["text_input_mask"]),
            )
            return {
                key: out[key].float().cpu().numpy() for key in ("vis_features", "text_features")
            }

    return eval_step
