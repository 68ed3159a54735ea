"""Load the JAX package's CLIP-ViP params into the PyTorch port.

The port names its parameters with the HF-CLIP keys, so its key table is
``xpretrain_tpu/models/clip_vip/convert.py:clip_key_rules`` (copied here: that
module's package imports flax). Each rule maps an HF key to its path in the
flax ``{"params": ...}`` tree and says how the value changes: a flax Dense
kernel [in, out] becomes a Linear weight [out, in]; the patch conv kernel
stays [P, P, 3, D], the layout the port's patchify GEMM reads; everything
else is copied.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

LINEAR = "linear"  # flax Dense kernel [in, out] -> torch Linear weight [out, in]
DIRECT = "direct"  # copied as is, the patch conv kernel [P, P, 3, D] included


def _layer_rules(prefix_t: str, prefix_f: tuple[str, ...], n_layers: int):
    """Per-encoder-layer key mapping rules."""
    rules = {}
    for i in range(n_layers):
        t = f"{prefix_t}.encoder.layers.{i}"
        f = prefix_f + ("encoder", f"layers_{i}")
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            rules[f"{t}.self_attn.{proj}.weight"] = (f + ("self_attn", proj, "kernel"), LINEAR)
            rules[f"{t}.self_attn.{proj}.bias"] = (f + ("self_attn", proj, "bias"), DIRECT)
        for fc in ("fc1", "fc2"):
            rules[f"{t}.mlp.{fc}.weight"] = (f + ("mlp", fc, "kernel"), LINEAR)
            rules[f"{t}.mlp.{fc}.bias"] = (f + ("mlp", fc, "bias"), DIRECT)
        for ln in ("layer_norm1", "layer_norm2"):
            rules[f"{t}.{ln}.weight"] = (f + (ln, "scale"), DIRECT)
            rules[f"{t}.{ln}.bias"] = (f + (ln, "bias"), DIRECT)
    return rules


def clip_key_rules(n_text_layers: int = 12, n_vision_layers: int = 12):
    """HF-CLIP(+ViP) key -> (flax path, transform)."""
    rules: dict[str, tuple[tuple[str, ...], str]] = {
        "logit_scale": (("logit_scale",), DIRECT),
        "text_projection.weight": (("text_projection", "kernel"), LINEAR),
        "visual_projection.weight": (("visual_projection", "kernel"), LINEAR),
        # text tower
        "text_model.embeddings.token_embedding.weight": (
            ("text_model", "embeddings", "token_embedding", "embedding"),
            DIRECT,
        ),
        "text_model.embeddings.position_embedding.weight": (
            ("text_model", "embeddings", "position_embedding"),
            DIRECT,
        ),
        "text_model.final_layer_norm.weight": (("text_model", "final_layer_norm", "scale"), DIRECT),
        "text_model.final_layer_norm.bias": (("text_model", "final_layer_norm", "bias"), DIRECT),
        # vision tower (HF spells it "pre_layrnorm")
        "vision_model.embeddings.class_embedding": (
            ("vision_model", "embeddings", "class_embedding"),
            DIRECT,
        ),
        "vision_model.embeddings.patch_embedding.weight": (
            ("vision_model", "embeddings", "patch_embedding", "kernel"),
            DIRECT,
        ),
        "vision_model.embeddings.position_embedding.weight": (
            ("vision_model", "embeddings", "position_embedding"),
            DIRECT,
        ),
        "vision_model.pre_layrnorm.weight": (("vision_model", "pre_layernorm", "scale"), DIRECT),
        "vision_model.pre_layrnorm.bias": (("vision_model", "pre_layernorm", "bias"), DIRECT),
        "vision_model.post_layernorm.weight": (("vision_model", "post_layernorm", "scale"), DIRECT),
        "vision_model.post_layernorm.bias": (("vision_model", "post_layernorm", "bias"), DIRECT),
        # ViP extras
        "vision_model.embeddings.added_cls": (("vision_model", "embeddings", "added_cls"), DIRECT),
        "vision_model.embeddings.temporal_embedding": (
            ("vision_model", "embeddings", "temporal_embedding"),
            DIRECT,
        ),
    }
    rules.update(_layer_rules("text_model", ("text_model",), n_text_layers))
    rules.update(_layer_rules("vision_model", ("vision_model",), n_vision_layers))
    return rules


def _flatten(tree: Mapping[str, Any], path: tuple[str, ...] = ()) -> dict[tuple[str, ...], np.ndarray]:
    flat = {}
    for key, value in tree.items():
        if isinstance(value, Mapping):
            flat.update(_flatten(value, path + (key,)))
        else:
            flat[path + (key,)] = np.asarray(value)
    return flat


def load_jax_params(model: nn.Module, flax_params: Mapping[str, Any]) -> nn.Module:
    """Load a JAX ``CLIPViPModel`` ``{"params": ...}`` tree of numpy arrays
    into the port's ``CLIPViPModel``.

    Raises on a flax leaf that no rule maps, on any missing or unexpected
    key and on any shape mismatch."""
    cfg = model.config
    rules = clip_key_rules(cfg.text.num_hidden_layers, cfg.vision.num_hidden_layers)
    inverse = {path: (key, kind) for key, (path, kind) in rules.items()}
    state = {}
    for path, value in _flatten(flax_params.get("params", flax_params)).items():
        if path not in inverse:
            raise KeyError(f"no port parameter for flax param {'/'.join(path)}")
        key, kind = inverse[path]
        if kind == LINEAR:
            value = value.T
        state[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    own = model.state_dict()
    missing = sorted(set(own) - set(state))
    unexpected = sorted(set(state) - set(own))
    if missing or unexpected:
        raise KeyError(f"param mismatch: missing {missing[:8]}, unexpected {unexpected[:8]}")
    for key, value in state.items():
        if tuple(own[key].shape) != tuple(value.shape):
            raise ValueError(f"{key}: port shape {tuple(own[key].shape)} != loaded {tuple(value.shape)}")
    model.load_state_dict(state, strict=True)
    return model


def flax_param_paths(config) -> dict[str, str]:
    """Port parameter name -> its "/"-joined path in the flax params tree,
    where the optimizer's label patterns are matched
    (``xpretrain_tpu_torch.optim.optimizer.param_group_labels``)."""
    rules = clip_key_rules(config.text.num_hidden_layers, config.vision.num_hidden_layers)
    return {key: "/".join(path) for key, (path, _kind) in rules.items()}
