"""CLIP-ViP weights into the PyTorch port: the JAX package's params, and
torch CLIP / CLIP-ViP checkpoints.

The port names its parameters with the HF-CLIP keys, so its key table is
``xpretrain_tpu/models/clip_vip/convert.py:clip_key_rules`` (copied here: that
module's package imports flax). Each rule maps an HF key to its path in the
flax ``{"params": ...}`` tree and says how the value changes: a flax Dense
kernel [in, out] becomes a Linear weight [out, in]; the patch conv kernel
stays [P, P, 3, D], the layout the port's patchify GEMM reads; everything
else is copied.

Torch checkpoints (OpenAI/HF CLIP weights as ``VidCLIP`` loads them, ref
``CLIP-ViP/src/modeling/VidCLIP.py:14-18``, and released
``pretrain_clipvip_base_32.pt``-style state dicts under a ``clipmodel.``
prefix, with the ViP extras ``added_cls`` and ``temporal_embedding``) are
already HF-keyed: :func:`merge_pretrained` strips the wrappers, turns the
patch Conv2d weight [D, 3, P, P] into [P, P, 3, D], interpolates a temporal
embedding of another length, and merges shape-tolerantly into the model's
parameters, as the reference's ``load_state_dict_with_mismatch``
(``CLIP-ViP/src/utils/load_save.py:86-115``) and the JAX package's
``merge_pretrained`` do. :func:`load_torch_checkpoint` reads ``.pt`` / ``.bin``
files and, with a reader of its own, ``.safetensors``.
"""

from __future__ import annotations

import json
import re
import struct
from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

from xpretrain_tpu_torch.utils.logging import LOGGER

LINEAR = "linear"  # flax Dense kernel [in, out] -> torch Linear weight [out, in]
DIRECT = "direct"  # copied as is, the patch conv kernel [P, P, 3, D] included
# the one Conv2d of a torch CLIP checkpoint: [D, 3, P, P] there, [P, P, 3, D] in the port
PATCH_KEY = "vision_model.embeddings.patch_embedding.weight"


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


# ---------------------------------------------------------------------------
# torch CLIP / CLIP-ViP checkpoints
# ---------------------------------------------------------------------------

_PREFIX_RE = re.compile(r"^(module\.)?(clipmodel\.)?")


def strip_prefixes(state_dict: Mapping[str, Any]) -> dict[str, np.ndarray]:
    """Strip the DDP (``module.``) and ``VidCLIP`` (``clipmodel.``) wrappers
    and turn tensors into fp32 numpy (other entries into numpy as they are)."""
    out = {}
    for key, value in state_dict.items():
        key = _PREFIX_RE.sub("", key)
        if isinstance(value, torch.Tensor):
            value = value.detach().cpu().float().numpy()
        out[key] = np.asarray(value)
    return out


def _interp_temporal(value: np.ndarray, target_len: int) -> np.ndarray:
    """Linear interpolation of a [1, T, C] temporal embedding to
    ``target_len`` rows (align_corners=False, as the model interpolates at
    run time), in float64 as the JAX package computes it; the merge casts
    the result to fp32."""
    src_len = value.shape[1]
    if src_len == target_len:
        return value
    x = (np.arange(target_len) + 0.5) * src_len / target_len - 0.5
    x = np.clip(x, 0, src_len - 1)
    lo = np.floor(x).astype(int)
    hi = np.minimum(lo + 1, src_len - 1)
    w = (x - lo)[None, :, None]
    return value[:, lo] * (1 - w) + value[:, hi] * w


def merge_pretrained(model: nn.Module, state_dict: Mapping[str, Any]) -> dict[str, list[str]]:
    """Merge a torch CLIP / CLIP-ViP state dict into ``model``'s parameters
    in place, shape-tolerantly (``xpretrain_tpu/models/clip_vip/convert.py:
    torch_clip_to_flax`` then ``merge_pretrained``):

    - ``module.`` / ``clipmodel.`` prefixes go, ``position_ids`` buffers are
      skipped, and a key outside the HF-CLIP(+ViP) table is skipped with a
      warning;
    - a temporal embedding of another length is interpolated to the model's
      ``temporal_size``;
    - a key the model does not hold (``added_cls`` of a model without extra
      proxies) is skipped with a warning, a shape mismatch keeps the model's
      value with a warning, and everything else replaces it (as fp32).

    Returns the keys ``loaded``, ``kept`` (shape mismatch), ``unexpected`` and
    ``unmapped``."""
    cfg = model.config
    rules = clip_key_rules(cfg.text.num_hidden_layers, cfg.vision.num_hidden_layers)
    report: dict[str, list[str]] = {"loaded": [], "kept": [], "unexpected": [], "unmapped": []}
    converted = {}
    for key, value in strip_prefixes(state_dict).items():
        if key == "position_ids" or key.endswith(".position_ids"):
            continue
        if key not in rules:
            report["unmapped"].append(key)
            continue
        if key == PATCH_KEY:
            value = value.transpose(2, 3, 1, 0)  # [D, 3, P, P] -> [P, P, 3, D]
        elif key.endswith("temporal_embedding"):
            value = _interp_temporal(value, cfg.vip.temporal_size)
        converted[key] = value
    if report["unmapped"]:
        LOGGER.warning("converter: %d unmapped keys (first 5: %s)", len(report["unmapped"]), report["unmapped"][:5])
    params = dict(model.named_parameters())
    with torch.no_grad():
        for key, value in converted.items():
            if key not in params:
                LOGGER.warning("merge: unexpected key %s", key)
                report["unexpected"].append(key)
            elif tuple(params[key].shape) != np.shape(value):
                LOGGER.warning("merge: shape mismatch at %s: %s vs %s — keeping init", key,
                               tuple(params[key].shape), np.shape(value))
                report["kept"].append(key)
            else:
                params[key].copy_(torch.from_numpy(np.asarray(value, dtype=np.float32)))
                report["loaded"].append(key)
    return report


def torch_clip_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """The model's parameters as a torch CLIP checkpoint holds them: HF keys,
    the patch weight as a Conv2d weight [D, 3, P, P] (the inverse of
    :func:`merge_pretrained`'s layout change); detached copies on the CPU."""
    out = {}
    for key, p in model.named_parameters():
        value = p.detach().cpu().clone()
        out[key] = value.permute(3, 2, 0, 1).contiguous() if key == PATCH_KEY else value
    return out


# safetensors: an 8-byte little-endian header length, a JSON header of
# {name: {"dtype", "shape", "data_offsets": [begin, end]}} (offsets into the
# data after the header) and an optional "__metadata__", then the raw
# little-endian buffers
_SAFETENSORS_DTYPES = {
    "F64": torch.float64, "F32": torch.float32, "F16": torch.float16, "BF16": torch.bfloat16,
    "I64": torch.int64, "I32": torch.int32, "I16": torch.int16, "I8": torch.int8, "U8": torch.uint8,
    "BOOL": torch.bool,
}


def read_safetensors(path: str) -> dict[str, torch.Tensor]:
    """The tensors of a ``.safetensors`` file, as CPU tensors of their stored
    dtype (bf16 included)."""
    with open(path, "rb") as f:
        data = f.read()
    (n,) = struct.unpack("<Q", data[:8])
    header = json.loads(data[8:8 + n].decode("utf-8"))
    body = memoryview(data)[8 + n:]
    out = {}
    for name, spec in header.items():
        if name == "__metadata__":
            continue
        dtype = _SAFETENSORS_DTYPES.get(spec["dtype"])
        if dtype is None:
            raise ValueError(f"{path}: {name} has dtype {spec['dtype']}, which this reader does not take")
        begin, end = spec["data_offsets"]
        shape = tuple(spec["shape"])
        if end == begin:
            out[name] = torch.empty(shape, dtype=dtype)
        else:
            out[name] = torch.frombuffer(bytearray(body[begin:end]), dtype=dtype).reshape(shape)
    return out


def load_torch_checkpoint(path: str) -> dict[str, np.ndarray]:
    """A ``.pt`` / ``.bin`` / ``.safetensors`` checkpoint as numpy arrays
    (floating tensors as fp32). A torch file is read with
    ``weights_only=False``, as the JAX package reads it (released
    checkpoints carry non-tensor entries), unwrapped from ``state_dict`` and
    ``model`` and stripped of its wrapper prefixes; a safetensors file keeps
    its keys as they are (as in the JAX package)."""
    if path.endswith(".safetensors"):
        return {k: (v.float() if v.is_floating_point() else v).numpy() for k, v in read_safetensors(path).items()}
    sd = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(sd, dict) and "state_dict" in sd:
        sd = sd["state_dict"]
    if isinstance(sd, dict) and "model" in sd and all(
        isinstance(v, torch.Tensor) for v in sd["model"].values()
    ):
        sd = sd["model"]
    return strip_prefixes(sd)
