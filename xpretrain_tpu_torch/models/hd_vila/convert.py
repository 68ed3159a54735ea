"""HD-VILA parameters into the PyTorch port: the JAX package's params, and the
reference's torch checkpoints.

- :func:`key_rules`, :func:`load_jax_params`, :func:`flax_param_paths` and
  :func:`merge_flax_tree` are the port's flax-path table
  (``models/lf_vila/convert.py``): the port's HD-VILA modules carry the flax
  names, so each parameter's flax path is its module path plus the flax leaf
  of its kind. Conv2d weights are OIHW here and HWIO in flax;
  ``FrozenBatchNorm``'s ``scale``/``bias``/``mean``/``var`` and the
  TimeSformer and visual-embedding arrays go across by name.
- :func:`resnet_torch_to_flax`, :func:`hdvila_e2e_torch_to_flax` and
  :func:`timesformer_torch_to_flax` are copies of the JAX package's
  converters (``xpretrain_tpu/models/hd_vila/convert.py``): a reference
  checkpoint (torchvision/mmdet ResNet, the feature-level TimeSformer, the
  whole ``HDVILA`` e2e model) becomes the flax-path tree that
  ``merge_flax_tree`` places.
- :func:`hdvila_e2e_state_dict` goes the other way: a port
  ``HdVilaPretrainModel`` as a reference ``HDVILA`` state dict, which
  ``--e2e_weights_path`` loads back.
"""

from __future__ import annotations

import re
from typing import Mapping

import torch
from torch import nn

from xpretrain_tpu_torch.models.bert_convert import _EMB, _LAYER, bert_torch_to_flax
from xpretrain_tpu_torch.models.lf_vila.convert import (  # noqa: F401  (the table, shared)
    _np,
    _set,
    flax_param_paths,
    key_rules,
    load_jax_params,
    merge_flax_tree,
)
from xpretrain_tpu_torch.utils.logging import LOGGER


_BN_MAP = {"weight": "scale", "bias": "bias", "running_mean": "mean", "running_var": "var"}


def resnet_torch_to_flax(state_dict: Mapping) -> dict:
    """torchvision/mmdet ResNet state_dict -> the flax-path tree."""
    params: dict = {}
    unused = []
    for key, value in state_dict.items():
        v = _np(value)
        if key == "conv1.weight":
            _set(params, ("conv1", "kernel"), v.transpose(2, 3, 1, 0))
        elif m := re.match(r"bn1\.(\w+)$", key):
            if m.group(1) in _BN_MAP:
                _set(params, ("bn1", _BN_MAP[m.group(1)]), v)
        elif m := re.match(r"layer(\d)\.(\d+)\.conv(\d)\.weight", key):
            s, b, c = m.groups()
            _set(params, (f"layer{s}_{b}", f"conv{c}", "kernel"), v.transpose(2, 3, 1, 0))
        elif m := re.match(r"layer(\d)\.(\d+)\.bn(\d)\.(\w+)", key):
            s, b, c, w = m.groups()
            if w in _BN_MAP:
                _set(params, (f"layer{s}_{b}", f"bn{c}", _BN_MAP[w]), v)
        elif m := re.match(r"layer(\d)\.(\d+)\.downsample\.0\.weight", key):
            s, b = m.groups()
            _set(params, (f"layer{s}_{b}", "downsample_conv", "kernel"), v.transpose(2, 3, 1, 0))
        elif m := re.match(r"layer(\d)\.(\d+)\.downsample\.1\.(\w+)", key):
            s, b, w = m.groups()
            if w in _BN_MAP:
                _set(params, (f"layer{s}_{b}", "downsample_bn", _BN_MAP[w]), v)
        elif "num_batches_tracked" in key or key.startswith("fc."):
            continue
        else:
            unused.append(key)
    if unused:
        LOGGER.warning("resnet converter: %d unmapped keys (first 5: %s)", len(unused), unused[:5])
    return params


_GRID_CONVS = (
    ("grid_encoder", "grid_encoder_conv"),
    ("grid_encoder_low", "grid_encoder_low_conv"),
    ("grid_encoder_combine", "grid_encoder_combine_conv"),
)


def hdvila_e2e_torch_to_flax(state_dict: Mapping) -> dict:
    """Full HDVILA e2e checkpoint -> {encoder: ..., transformer: ...} flax trees.

    Routes the reference module prefixes (``e2e_model.py:34-47,63``):
    ``cnn.* / cnn_low.*`` -> ResNets, ``grid_encoder*.0.*`` -> the 1x1 convs,
    ``timesformer.*`` -> TimeSformer, ``transformer.*`` -> the two-stage BERT
    + heads (via the shared BERT converter).
    """
    groups: dict[str, dict] = {}
    for key, value in state_dict.items():
        prefix, _, rest = key.partition(".")
        groups.setdefault(prefix, {})[rest] = value

    encoder: dict = {}
    if "cnn" in groups:
        encoder["cnn"] = resnet_torch_to_flax(groups["cnn"])
    if "cnn_low" in groups:
        encoder["cnn_low"] = resnet_torch_to_flax(groups["cnn_low"])
    for tname, fname in _GRID_CONVS:
        if tname in groups and "0.weight" in groups[tname]:
            encoder[fname] = {"kernel": _np(groups[tname]["0.weight"]).transpose(2, 3, 1, 0)}
    if "timesformer" in groups:
        encoder["timesformer"] = timesformer_torch_to_flax(groups["timesformer"])

    transformer: dict = {}
    if "transformer" in groups:
        t = groups["transformer"]
        bert_sd = {k: v for k, v in t.items() if k.startswith("bert.") and not k.startswith(
            ("bert.pooler1", "bert.pooler2", "bert.visual_embeddings"))}
        bert_tree, _pooler, _ = bert_torch_to_flax(bert_sd, prefix="bert.")
        base: dict = {"bert": bert_tree}
        for pooler_name in ("pooler1", "pooler2"):
            wkey, bkey = f"bert.{pooler_name}.dense.weight", f"bert.{pooler_name}.dense.bias"
            if wkey in t:
                base[pooler_name] = {"dense": {"kernel": _np(t[wkey]).T, "bias": _np(t[bkey])}}
        vis: dict = {}
        for emb in ("row_position_embeddings", "col_position_embeddings"):
            k = f"bert.visual_embeddings.{emb}.weight"
            if k in t:
                vis[emb] = {"embedding": _np(t[k])}
        if "bert.visual_embeddings.token_type_embeddings.weight" in t:
            vis["token_type_embedding"] = _np(
                t["bert.visual_embeddings.token_type_embeddings.weight"]
            ).reshape(1, 1, -1)
        if "bert.visual_embeddings.LayerNorm.weight" in t:
            vis["LayerNorm"] = {
                "scale": _np(t["bert.visual_embeddings.LayerNorm.weight"]),
                "bias": _np(t["bert.visual_embeddings.LayerNorm.bias"]),
            }
        if vis:
            base["visual_embeddings"] = vis
        transformer["bert_model"] = base
        _, _, mlm = bert_torch_to_flax({k: v for k, v in t.items() if k.startswith("cls.")}, prefix="")
        if mlm:
            transformer["cls"] = mlm
        for proj in ("t_proj", "v_proj"):
            if f"{proj}.weight" in t:
                transformer[proj] = {
                    "kernel": _np(t[f"{proj}.weight"]).T,
                    "bias": _np(t[f"{proj}.bias"]),
                }
        if "cls.seq_relationship.weight" in t:
            transformer["seq_relationship"] = {
                "kernel": _np(t["cls.seq_relationship.weight"]).T,
                "bias": _np(t["cls.seq_relationship.bias"]),
            }
    return {"encoder": encoder, "transformer": transformer}


_TS_TABLE = {
    "norm1.weight": ("norm1", "scale"),
    "norm1.bias": ("norm1", "bias"),
    "norm2.weight": ("norm2", "scale"),
    "norm2.bias": ("norm2", "bias"),
    "temporal_norm1.weight": ("temporal_norm1", "scale"),
    "temporal_norm1.bias": ("temporal_norm1", "bias"),
    "attn.qkv.weight": ("attn", "qkv", "kernel"),
    "attn.qkv.bias": ("attn", "qkv", "bias"),
    "attn.proj.weight": ("attn", "proj", "kernel"),
    "attn.proj.bias": ("attn", "proj", "bias"),
    "temporal_attn.qkv.weight": ("temporal_attn", "qkv", "kernel"),
    "temporal_attn.qkv.bias": ("temporal_attn", "qkv", "bias"),
    "temporal_attn.proj.weight": ("temporal_attn", "proj", "kernel"),
    "temporal_attn.proj.bias": ("temporal_attn", "proj", "bias"),
    "temporal_fc.weight": ("temporal_fc", "kernel"),
    "temporal_fc.bias": ("temporal_fc", "bias"),
    "mlp.fc1.weight": ("mlp_fc1", "kernel"),
    "mlp.fc1.bias": ("mlp_fc1", "bias"),
    "mlp.fc2.weight": ("mlp_fc2", "kernel"),
    "mlp.fc2.bias": ("mlp_fc2", "bias"),
}


def timesformer_torch_to_flax(state_dict: Mapping) -> dict:
    """Reference TimeSformer state_dict -> the flax-path tree."""
    params: dict = {}
    unused = []
    for key, value in state_dict.items():
        v = _np(value)
        if key in ("pos_embed", "time_embed"):
            _set(params, (key,), v)
        elif re.match(r"norm\.(weight|bias)", key):
            continue  # dead param: the reference never applies its final norm
        elif m := re.match(r"blocks\.(\d+)\.(.+)", key):
            i, rest = m.groups()
            if rest not in _TS_TABLE:
                unused.append(key)
                continue
            if rest.endswith("weight") and "norm" not in rest:
                v = v.T
            _set(params, (f"blocks_{i}",) + _TS_TABLE[rest], v)
        else:
            unused.append(key)
    if unused:
        LOGGER.warning("timesformer converter: %d unmapped (first 5: %s)", len(unused), unused[:5])
    return params


# ---------------------------------------------------------------------------
# A port model as a reference HDVILA state dict
# ---------------------------------------------------------------------------

_BN_INV = {flax: torch_name for torch_name, flax in _BN_MAP.items()}
_TS_INV = {flax: key for key, flax in _TS_TABLE.items()}
_EMB_INV = {flax[1:]: key for key, flax in _EMB.items() if "gamma" not in key and "beta" not in key}
_LAYER_INV = {flax: key for key, flax in _LAYER.items()}
_MLM_INV = {
    ("transform_dense", "kernel"): "predictions.transform.dense.weight",
    ("transform_dense", "bias"): "predictions.transform.dense.bias",
    ("transform_LayerNorm", "scale"): "predictions.transform.LayerNorm.weight",
    ("transform_LayerNorm", "bias"): "predictions.transform.LayerNorm.bias",
    ("decoder", "kernel"): "predictions.decoder.weight",
    ("decoder", "bias"): "predictions.decoder.bias",
}
_DENSE = {"kernel": "weight", "bias": "bias"}


def _resnet_key(path: tuple[str, ...]) -> str:
    if path == ("conv1", "kernel"):
        return "conv1.weight"
    if path[0] == "bn1":
        return f"bn1.{_BN_INV[path[1]]}"
    stage, block = re.fullmatch(r"layer(\d)_(\d+)", path[0]).groups()
    module, leaf = path[1], path[2]
    if module == "downsample_conv":
        return f"layer{stage}.{block}.downsample.0.weight"
    if module == "downsample_bn":
        return f"layer{stage}.{block}.downsample.1.{_BN_INV[leaf]}"
    if module.startswith("conv"):
        return f"layer{stage}.{block}.{module}.weight"
    return f"layer{stage}.{block}.{module}.{_BN_INV[leaf]}"


def _reference_key(path: tuple[str, ...]) -> str:
    """The reference ``HDVILA`` state-dict key of a flax path of
    ``HdVilaPretrainModel``."""
    top, sub, rest = path[0], path[1], path[2:]
    if top == "encoder":
        if sub in ("cnn", "cnn_low"):
            return f"{sub}.{_resnet_key(rest)}"
        if sub == "timesformer":
            if rest[0] in ("pos_embed", "time_embed"):
                return f"timesformer.{rest[0]}"
            return f"timesformer.blocks.{rest[0].split('_')[1]}.{_TS_INV[rest[1:]]}"
        return f"{dict((f, t) for t, f in _GRID_CONVS)[sub]}.0.weight"
    if sub == "bert_model":
        module, rest = rest[0], rest[1:]
        if module == "bert":
            if rest[0] == "embeddings":
                return f"transformer.bert.embeddings.{_EMB_INV[rest[1:]]}"
            return f"transformer.bert.encoder.layer.{rest[1].split('_')[1]}.{_LAYER_INV[rest[2:]]}"
        if module in ("pooler1", "pooler2"):
            return f"transformer.bert.{module}.dense.{_DENSE[rest[1]]}"
        if rest[0] == "token_type_embedding":
            return "transformer.bert.visual_embeddings.token_type_embeddings.weight"
        leaf = {"embedding": "weight", "scale": "weight", "bias": "bias"}[rest[1]]
        return f"transformer.bert.visual_embeddings.{rest[0]}.{leaf}"
    if sub == "cls":
        return f"transformer.cls.{_MLM_INV[rest]}"
    if sub == "seq_relationship":
        return f"transformer.cls.seq_relationship.{_DENSE[rest[0]]}"
    return f"transformer.{sub}.{_DENSE[rest[0]]}"  # t_proj, v_proj


def hdvila_e2e_state_dict(model: nn.Module) -> dict[str, torch.Tensor]:
    """A port ``HdVilaPretrainModel`` (``encoder`` + ``transformer``) as a
    reference ``HDVILA`` state dict (CPU fp32 copies): the keys that
    :func:`hdvila_e2e_torch_to_flax` reads, in the reference's torch layouts
    (Linear [out, in], Conv2d OIHW), which are the port's own; the visual
    token-type embedding is [1, C] there."""
    params = dict(model.named_parameters())
    out = {}
    for name, (path, _kind) in key_rules(model).items():
        value = params[name].detach().float().cpu().clone()
        key = _reference_key(path)
        out[key] = value.reshape(1, -1) if path[-1] == "token_type_embedding" else value
    return out
