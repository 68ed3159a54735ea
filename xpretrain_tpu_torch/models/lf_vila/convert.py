"""Load the JAX package's LF-VILA params into the PyTorch port.

The port's LF-VILA modules carry the flax module names (``video_encoder.
layers_3_blocks_1.attn.qkv``, ``text_encoder.encoder.layer_0.attention_self.
query``, ...), so the key table is read off the model itself: each
parameter's flax path is its module path plus the flax leaf name of its
kind, and each kind says how the value changes:

- Linear (flax Dense): kernel [in, out] -> weight [out, in]; bias as is;
- Conv3d (flax Conv): kernel [pd, ph, pw, C, D] -> weight [D, C, pd, ph, pw];
- Embedding (flax Embed): ``embedding`` as is;
- LayerNorm: ``scale`` -> weight, ``bias`` as is;
- any other parameter (``relative_position_bias_table``) as is, by its name.

The table covers whatever the model holds, the BERT pooler and stage-2
layers included when a model builds them, so a load is total both ways: a
flax leaf with no port parameter, or a port parameter with no flax leaf,
raises. ``xpretrain_tpu/models/lf_vila/convert.py`` (torch checkpoints of the
reference into JAX) is another converter and is not ported here.
"""

from __future__ import annotations

from typing import Any, Mapping

import numpy as np
import torch
from torch import nn

LINEAR = "linear"  # flax Dense kernel [in, out] -> torch Linear weight [out, in]
CONV3D = "conv3d"  # flax Conv kernel [pd, ph, pw, C, D] -> torch Conv3d weight [D, C, pd, ph, pw]
DIRECT = "direct"  # copied as is

_LEAVES = {  # module kind -> torch parameter name -> (flax leaf, transform)
    nn.Linear: {"weight": ("kernel", LINEAR), "bias": ("bias", DIRECT)},
    nn.Conv3d: {"weight": ("kernel", CONV3D), "bias": ("bias", DIRECT)},
    nn.Embedding: {"weight": ("embedding", DIRECT)},
    nn.LayerNorm: {"weight": ("scale", DIRECT), "bias": ("bias", DIRECT)},
}


def key_rules(model: nn.Module) -> dict[str, tuple[tuple[str, ...], str]]:
    """Port parameter name -> (flax path, transform), for every parameter."""
    rules = {}
    for module_name, module in model.named_modules():
        prefix = tuple(module_name.split(".")) if module_name else ()
        leaves = next((v for kind, v in _LEAVES.items() if isinstance(module, kind)), {})
        for name, _ in module.named_parameters(recurse=False):
            leaf, kind = leaves.get(name, (name, DIRECT))
            rules[f"{module_name}.{name}" if module_name else name] = (prefix + (leaf,), kind)
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
    """Load a JAX ``{"params": ...}`` tree (numpy or jax arrays) of the module
    the port's ``model`` mirrors (``LfVilaRetrieval``, ``SwinTransformer3D``,
    ``StagedBertModel``, ...) into ``model``.

    Raises on a flax leaf that no parameter maps, on a parameter that no leaf
    fills, and on any shape mismatch."""
    rules = key_rules(model)
    inverse = {path: (key, kind) for key, (path, kind) in rules.items()}
    state = {}
    for path, value in _flatten(flax_params.get("params", flax_params)).items():
        if path not in inverse:
            raise KeyError(f"no port parameter for flax param {'/'.join(path)}")
        key, kind = inverse[path]
        if kind == LINEAR:
            value = value.T
        elif kind == CONV3D:
            value = value.transpose(4, 3, 0, 1, 2)
        state[key] = torch.from_numpy(np.array(value, dtype=np.float32))
    own = dict(model.named_parameters())
    missing = sorted(set(own) - set(state))
    if missing:
        raise KeyError(f"port parameters with no flax param: {missing[:8]} ({len(missing)} in all)")
    with torch.no_grad():
        for key, value in state.items():
            if tuple(own[key].shape) != tuple(value.shape):
                raise ValueError(f"{key}: port shape {tuple(own[key].shape)} != loaded {tuple(value.shape)}")
            own[key].copy_(value)
    return model


def flax_param_paths(model: nn.Module) -> dict[str, str]:
    """Port parameter name -> its "/"-joined path in the flax params tree,
    where the optimizer's label patterns are matched
    (``xpretrain_tpu_torch.optim.optimizer.param_group_labels``)."""
    return {key: "/".join(path) for key, (path, _kind) in key_rules(model).items()}
