"""Reference-layout weight writers: flax-path trees to the reference
families' torch state dicts (the port's copy of
``xpretrain_tpu/models/export.py``).

The port's modules carry the flax module names, and its converters read the
reference's torch checkpoints into flax-path trees
(``models/bert_convert.py:bert_torch_to_flax``,
``models/lf_vila/convert.py:lfvila_torch_to_flax``). The writers here are
their inverses, producing reference-keyed numpy state dicts
(``LF-VILA/src/models/lfvila_pretrain.py:51-78``'s layout, HF BERT's,
``hd-vila/src/modeling/e2e_model.py``'s):

- :func:`bert_flax_to_torch`, :func:`swin3d_flax_to_torch`,
  :func:`lfvila_flax_to_torch`: copies of the JAX writers;
- :func:`resnet_flax_to_torch`, :func:`timesformer_flax_to_torch`,
  :func:`hdvila_e2e_flax_to_torch`: the same for HD-VILA, over the key table
  of ``models/hd_vila/convert.py`` (whose :func:`hdvila_e2e_state_dict`
  writes a port model directly);
- :func:`flax_params` turns a port model into its flax-path tree, so
  ``lfvila_flax_to_torch(flax_params(model))`` is an LF-VILA model as a
  reference checkpoint, which ``--model_weight`` loads back.

CLIP-ViP's writer is ``models/clip_vip/convert.py:torch_clip_state_dict``,
re-exported here. All tree writers return plain numpy; tensorize with
``{k: torch.from_numpy(v) for k, v in sd.items()}``.
"""

from __future__ import annotations

from typing import Mapping

import numpy as np
from torch import nn

from xpretrain_tpu_torch.models.clip_vip.convert import torch_clip_state_dict  # noqa: F401  (CLIP-ViP's writer)
from xpretrain_tpu_torch.models.hd_vila.convert import (  # noqa: F401  (HD-VILA's model writer)
    _TS_INV,
    _reference_key,
    _resnet_key,
    hdvila_e2e_state_dict,
)
from xpretrain_tpu_torch.models.lf_vila.convert import CONV2D, CONV3D, LINEAR, key_rules


def _flatten(tree: Mapping, prefix: tuple[str, ...] = ()):
    for key, value in tree.items():
        path = prefix + (str(key),)
        if isinstance(value, Mapping):
            yield from _flatten(value, path)
        else:
            yield path, np.asarray(value)


def _conv_back(v: np.ndarray) -> np.ndarray:
    """flax conv kernel -> torch layout ([*k, I, O] -> [O, I, *k])."""
    nd = v.ndim
    return v.transpose((nd - 1, nd - 2) + tuple(range(nd - 2)))


def flax_params(model: nn.Module) -> dict:
    """A port model's parameters as its flax-path tree of fp32 numpy arrays
    in flax layouts (Dense kernels [in, out], Conv kernels channels-last):
    the inverse of ``models/lf_vila/convert.py:load_jax_params``."""
    params = dict(model.named_parameters())
    tree: dict = {}
    for name, (path, kind) in key_rules(model).items():
        value = params[name].detach().float().cpu().numpy()
        if kind == LINEAR:
            value = value.T
        elif kind in (CONV2D, CONV3D):
            value = value.transpose(*range(2, value.ndim), 1, 0)
        node = tree
        for part in path[:-1]:
            node = node.setdefault(part, {})
        node[path[-1]] = np.ascontiguousarray(value)
    return tree


# ---------------------------------------------------------------------------
# BERT (inverse of bert_convert.bert_torch_to_flax)
# ---------------------------------------------------------------------------

_EMB_BACK = {
    ("word_embeddings", "embedding"): "embeddings.word_embeddings.weight",
    ("position_embeddings", "embedding"): "embeddings.position_embeddings.weight",
    ("token_type_embeddings", "embedding"): "embeddings.token_type_embeddings.weight",
    ("LayerNorm", "scale"): "embeddings.LayerNorm.weight",
    ("LayerNorm", "bias"): "embeddings.LayerNorm.bias",
}

_LAYER_BACK = {
    ("attention_self", "query", "kernel"): ("attention.self.query.weight", True),
    ("attention_self", "query", "bias"): ("attention.self.query.bias", False),
    ("attention_self", "key", "kernel"): ("attention.self.key.weight", True),
    ("attention_self", "key", "bias"): ("attention.self.key.bias", False),
    ("attention_self", "value", "kernel"): ("attention.self.value.weight", True),
    ("attention_self", "value", "bias"): ("attention.self.value.bias", False),
    ("attention_output_dense", "kernel"): ("attention.output.dense.weight", True),
    ("attention_output_dense", "bias"): ("attention.output.dense.bias", False),
    ("attention_output_LayerNorm", "scale"): ("attention.output.LayerNorm.weight", False),
    ("attention_output_LayerNorm", "bias"): ("attention.output.LayerNorm.bias", False),
    ("intermediate_dense", "kernel"): ("intermediate.dense.weight", True),
    ("intermediate_dense", "bias"): ("intermediate.dense.bias", False),
    ("output_dense", "kernel"): ("output.dense.weight", True),
    ("output_dense", "bias"): ("output.dense.bias", False),
    ("output_LayerNorm", "scale"): ("output.LayerNorm.weight", False),
    ("output_LayerNorm", "bias"): ("output.LayerNorm.bias", False),
}

_MLM_BACK = {
    ("transform_dense", "kernel"): ("transform.dense.weight", True),
    ("transform_dense", "bias"): ("transform.dense.bias", False),
    ("transform_LayerNorm", "scale"): ("transform.LayerNorm.weight", False),
    ("transform_LayerNorm", "bias"): ("transform.LayerNorm.bias", False),
    ("decoder", "kernel"): ("decoder.weight", True),
    ("decoder", "bias"): ("decoder.bias", False),
}


def _pooler_key(prefix: str, path: tuple[str, ...], v: np.ndarray) -> tuple[str, np.ndarray]:
    kernel = path[-1] == "kernel"
    return f"{prefix}pooler.dense." + ("weight" if kernel else "bias"), v.T if kernel else v


def bert_flax_to_torch(
    bert: Mapping,
    pooler: Mapping | None = None,
    mlm: Mapping | None = None,
    prefix: str = "bert.",
    mlm_prefix: str = "cls.predictions.",
) -> dict[str, np.ndarray]:
    """StagedBertModel (+pooler, +MLM head) trees -> HF-BERT-named dict."""
    out: dict[str, np.ndarray] = {}
    for path, v in _flatten(bert):
        if path[0] == "embeddings" and path[1:] in _EMB_BACK:
            out[prefix + _EMB_BACK[path[1:]]] = v
        elif path[0] == "encoder" and path[1].startswith("layer_"):
            rest = _LAYER_BACK.get(path[2:])
            if rest is None:
                continue
            key, transpose = rest
            out[f"{prefix}encoder.layer.{path[1][len('layer_'):]}.{key}"] = v.T if transpose else v
        elif path[0] == "pooler":  # pooler stored inside the bert tree
            key, value = _pooler_key(prefix, path, v)
            out[key] = value
    for path, v in _flatten(pooler or {}):
        key, value = _pooler_key(prefix, path, v)
        out[key] = value
    for path, v in _flatten(mlm or {}):
        rest = _MLM_BACK.get(path)
        if rest is None:
            continue
        key, transpose = rest
        out[mlm_prefix + key] = v.T if transpose else v
        if path == ("decoder", "bias"):
            # HF BERT keeps a standalone tied copy at cls.predictions.bias
            out[mlm_prefix + "bias"] = v
    return out


# ---------------------------------------------------------------------------
# LF-VILA (inverse of lf_vila.convert.swin3d_torch_to_flax / lfvila_torch_to_flax)
# ---------------------------------------------------------------------------

_SWIN_BLOCK_BACK = {
    ("norm1", "scale"): ("norm1.weight", False),
    ("norm1", "bias"): ("norm1.bias", False),
    ("norm2", "scale"): ("norm2.weight", False),
    ("norm2", "bias"): ("norm2.bias", False),
    ("attn", "qkv", "kernel"): ("attn.qkv.weight", True),
    ("attn", "qkv", "bias"): ("attn.qkv.bias", False),
    ("attn", "proj", "kernel"): ("attn.proj.weight", True),
    ("attn", "proj", "bias"): ("attn.proj.bias", False),
    ("attn", "relative_position_bias_table"): ("attn.relative_position_bias_table", False),
    ("mlp_fc1", "kernel"): ("mlp.fc1.weight", True),
    ("mlp_fc1", "bias"): ("mlp.fc1.bias", False),
    ("mlp_fc2", "kernel"): ("mlp.fc2.weight", True),
    ("mlp_fc2", "bias"): ("mlp.fc2.bias", False),
}


def _merge_key(path: tuple[str, ...], v: np.ndarray) -> tuple[str, np.ndarray]:
    """A PatchMerging leaf: ``reduction`` (Dense, no bias) or ``norm``."""
    if path[1] == "reduction":
        return "reduction.weight", v.T
    return "norm." + ("weight" if path[2] == "scale" else "bias"), v


def swin3d_flax_to_torch(params: Mapping) -> dict[str, np.ndarray]:
    """Inverse of ``lf_vila.convert.swin3d_torch_to_flax``."""
    out: dict[str, np.ndarray] = {}
    for path, v in _flatten(params):
        top = path[0]
        if top == "patch_embed":
            if path[1:] == ("proj", "kernel"):
                out["patch_embed.proj.weight"] = _conv_back(v)
            elif path[1:] == ("proj", "bias"):
                out["patch_embed.proj.bias"] = v
            elif path[1] == "norm":
                out["patch_embed.norm." + ("weight" if path[2] == "scale" else "bias")] = v
        elif top.startswith("layers_") and "_blocks_" in top:
            i, b = top[len("layers_"):].split("_blocks_")
            rest = _SWIN_BLOCK_BACK.get(path[1:])
            if rest is None:
                continue
            key, transpose = rest
            out[f"layers.{i}.blocks.{b}.{key}"] = v.T if transpose else v
        elif top.startswith("layers_") and top.endswith("_downsample"):
            key, value = _merge_key(path, v)
            out[f"layers.{top[len('layers_'):-len('_downsample')]}.downsample.{key}"] = value
        elif top == "local_feat_proj":
            key, value = _merge_key(path, v)
            out[f"local_feat_proj.{key}"] = value
        elif top in ("norm", "norm_local"):
            out[f"{top}." + ("weight" if path[1] == "scale" else "bias")] = v
    return out


def _dense(tree: Mapping, name: str) -> dict[str, np.ndarray]:
    return {f"{name}.weight": np.asarray(tree["kernel"]).T, f"{name}.bias": np.asarray(tree["bias"])}


def lfvila_flax_to_torch(params: Mapping) -> dict[str, np.ndarray]:
    """LfVilaPretrain param tree -> reference-keyed state dict
    (inverse of ``lf_vila.convert.lfvila_torch_to_flax``)."""
    out: dict[str, np.ndarray] = {}
    if "video_encoder" in params:
        for k, v in swin3d_flax_to_torch(params["video_encoder"]).items():
            out[f"video_encoder.{k}"] = v
    if "text_encoder" in params:
        te = dict(params["text_encoder"])
        pooler = te.pop("pooler", None)
        out.update(bert_flax_to_torch(
            te, pooler=pooler, mlm=params.get("cls"),
            prefix="text_encoder.bert.", mlm_prefix="text_encoder.cls.predictions.",
        ))
    if "seq_relationship" in params:
        out.update(_dense(params["seq_relationship"], "text_encoder.seq_relationship"))
    for proj in ("video_local_proj", "text_local_proj", "video_global_proj", "text_global_proj"):
        if proj in params:
            out.update(_dense(params[proj], proj))
    if "sent_embedding" in params:
        s = params["sent_embedding"]
        out["sent_embedding.position_embeddings.weight"] = np.asarray(s["position_embeddings"]["embedding"])
        out["sent_embedding.segment_embeddings.weight"] = np.asarray(s["segment_embeddings"]["embedding"])
        out["sent_embedding.norm.weight"] = np.asarray(s["norm"]["scale"])
        out["sent_embedding.norm.bias"] = np.asarray(s["norm"]["bias"])
    if "video_token_pos" in params:
        v = params["video_token_pos"]
        out["video_token_pos.s_pos_embed"] = np.asarray(v["s_pos_embed"])
        out["video_token_pos.t_pos_embed"] = np.asarray(v["t_pos_embed"])
        out["video_token_pos.norm.weight"] = np.asarray(v["norm"]["scale"])
        out["video_token_pos.norm.bias"] = np.asarray(v["norm"]["bias"])
    return out


# ---------------------------------------------------------------------------
# HD-VILA (inverse of hd_vila.convert.*_torch_to_flax, on its key table)
# ---------------------------------------------------------------------------


def _torch_layout(path: tuple[str, ...], v: np.ndarray) -> np.ndarray:
    """A flax leaf in the reference's torch layout: Conv kernels OIHW,
    Dense kernels [out, in], the visual token-type embedding [1, C]."""
    if path[-1] == "kernel":
        return _conv_back(v) if v.ndim == 4 else v.T
    if path[-1] == "token_type_embedding":
        return v.reshape(1, -1)
    return v


def resnet_flax_to_torch(params: Mapping) -> dict[str, np.ndarray]:
    """Inverse of ``hd_vila.convert.resnet_torch_to_flax``."""
    return {_resnet_key(path): _torch_layout(path, v) for path, v in _flatten(params)}


def timesformer_flax_to_torch(params: Mapping) -> dict[str, np.ndarray]:
    """Inverse of ``hd_vila.convert.timesformer_torch_to_flax``."""
    out: dict[str, np.ndarray] = {}
    for path, v in _flatten(params):
        if path[0] in ("pos_embed", "time_embed"):
            out[path[0]] = v
        elif path[0].startswith("blocks_") and path[1:] in _TS_INV:
            out[f"blocks.{path[0][len('blocks_'):]}.{_TS_INV[path[1:]]}"] = _torch_layout(path, v)
    return out


def hdvila_e2e_flax_to_torch(params: Mapping) -> dict[str, np.ndarray]:
    """{encoder, transformer} trees -> reference e2e state dict
    (inverse of ``hd_vila.convert.hdvila_e2e_torch_to_flax``)."""
    out = {_reference_key(path): _torch_layout(path, v) for path, v in _flatten(params)}
    if "transformer.cls.predictions.decoder.bias" in out:
        # HF BERT keeps a standalone tied copy at cls.predictions.bias
        out["transformer.cls.predictions.bias"] = out["transformer.cls.predictions.decoder.bias"]
    return out
