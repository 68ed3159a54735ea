"""Load the JAX package's LF-VILA params into the PyTorch port.

The port's LF-VILA modules carry the flax module names (``video_encoder.
layers_3_blocks_1.attn.qkv``, ``text_encoder.encoder.layer_0.attention_self.
query``, ...), so the key table is read off the model itself: each
parameter's flax path is its module path plus the flax leaf name of its
kind, and each kind says how the value changes:

- Linear (flax Dense): kernel [in, out] -> weight [out, in]; bias as is;
- Conv3d (flax Conv): kernel [pd, ph, pw, C, D] -> weight [D, C, pd, ph, pw];
- Conv2d (flax Conv, HD-VILA's ResNets): kernel [kh, kw, C, D] (HWIO) ->
  weight [D, C, kh, kw] (OIHW);
- Embedding (flax Embed): ``embedding`` as is;
- LayerNorm: ``scale`` -> weight, ``bias`` as is;
- any other parameter (``relative_position_bias_table``) as is, by its name.

The table covers whatever the model holds, the BERT pooler and stage-2
layers included when a model builds them, so :func:`load_jax_params` is
total both ways: a flax leaf with no port parameter, or a port parameter
with no flax leaf, raises. :func:`merge_flax_tree` is its partial,
shape-tolerant sibling, the merge of a pretrained checkpoint.

The reference's torch checkpoints come in through the JAX package's
converters, copied here (``xpretrain_tpu/models/lf_vila/convert.py``):
:func:`swin3d_torch_to_flax` and :func:`lfvila_torch_to_flax` map them to the
flax-path tree, and :func:`inflate_swin2d_to_3d` turns an ImageNet 2-D Swin
into the 3-D HTWA layout first (ref ``LF-VILA/src/utils/load.py:94-240``).
Its bias-table resize is bicubic through ``F.interpolate`` and has no
fallback (the JAX copy falls back to nearest-neighbour indexing without
cv2).
"""

from __future__ import annotations

import re
from typing import Any, Mapping

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xpretrain_tpu_torch.models.bert_convert import bert_torch_to_flax
from xpretrain_tpu_torch.utils.logging import LOGGER

LINEAR = "linear"  # flax Dense kernel [in, out] -> torch Linear weight [out, in]
CONV3D = "conv3d"  # flax Conv kernel [pd, ph, pw, C, D] -> torch Conv3d weight [D, C, pd, ph, pw]
CONV2D = "conv2d"  # flax Conv kernel [kh, kw, C, D] -> torch Conv2d weight [D, C, kh, kw]
DIRECT = "direct"  # copied as is

_LEAVES = {  # module kind -> torch parameter name -> (flax leaf, transform)
    nn.Linear: {"weight": ("kernel", LINEAR), "bias": ("bias", DIRECT)},
    nn.Conv3d: {"weight": ("kernel", CONV3D), "bias": ("bias", DIRECT)},
    nn.Conv2d: {"weight": ("kernel", CONV2D), "bias": ("bias", DIRECT)},
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


def _to_port(value: np.ndarray, kind: str) -> torch.Tensor:
    """A flax leaf as the fp32 tensor of its port parameter's layout."""
    if kind == LINEAR:
        value = value.T
    elif kind == CONV3D:
        value = value.transpose(4, 3, 0, 1, 2)
    elif kind == CONV2D:
        value = value.transpose(3, 2, 0, 1)
    return torch.from_numpy(np.array(value, dtype=np.float32))


def load_jax_params(model: nn.Module, flax_params: Mapping[str, Any]) -> nn.Module:
    """Load a JAX ``{"params": ...}`` tree (numpy or jax arrays) of the module
    the port's ``model`` mirrors (``LfVilaRetrieval``, ``SwinTransformer3D``,
    ``StagedBertModel``, HD-VILA's ``HdVilaPretrainModel``, ...) into ``model``.

    Raises on a flax leaf that no parameter maps, on a parameter that no leaf
    fills, and on any shape mismatch."""
    rules = key_rules(model)
    inverse = {path: (key, kind) for key, (path, kind) in rules.items()}
    state = {}
    for path, value in _flatten(flax_params.get("params", flax_params)).items():
        if path not in inverse:
            raise KeyError(f"no port parameter for flax param {'/'.join(path)}")
        key, kind = inverse[path]
        state[key] = _to_port(value, kind)
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


def merge_flax_tree(model: nn.Module, tree: Mapping[str, Any], scope: tuple[str, ...] = ()) -> None:
    """Merge a converted flax-path tree into ``model``'s parameters in place,
    under ``scope`` (a module path such as ``("text_encoder",)``), shape-
    tolerantly: the port's ``xpretrain_tpu/models/pretrained.py:merge_into``.

    A leaf with no parameter at its path is skipped with a warning, a shape
    mismatch keeps the model's value with a warning, everything else
    replaces it (as fp32). A scope the model does not hold loads nothing,
    with a warning."""
    rules = key_rules(model)
    if scope and not any(path[:len(scope)] == scope for path, _ in rules.values()):
        LOGGER.warning("merge: scope %r not in params — nothing loaded", "/".join(scope))
        return
    inverse = {path: (key, kind) for key, (path, kind) in rules.items()}
    params = dict(model.named_parameters())
    with torch.no_grad():
        for path, value in _flatten(tree).items():
            path = scope + path
            if path not in inverse:
                LOGGER.warning("merge: unexpected key %s — skipped", "/".join(path))
                continue
            key, kind = inverse[path]
            value = _to_port(value, kind)
            if tuple(params[key].shape) != tuple(value.shape):
                LOGGER.warning("merge: shape mismatch at %s: %s vs %s — keeping init", "/".join(path),
                               tuple(params[key].shape), tuple(value.shape))
                continue
            params[key].copy_(value)


# ---------------------------------------------------------------------------
# The reference's torch checkpoints -> flax-path trees (the JAX package's
# converters, copied)
# ---------------------------------------------------------------------------


def _np(value) -> np.ndarray:
    if isinstance(value, torch.Tensor):
        value = value.detach().cpu().float().numpy()
    return np.asarray(value)


def _set(tree: dict, path: tuple[str, ...], value: np.ndarray) -> None:
    node = tree
    for part in path[:-1]:
        node = node.setdefault(part, {})
    node[path[-1]] = value


def swin3d_torch_to_flax(state_dict: Mapping) -> dict:
    """Map a SwinTransformer3D torch state_dict onto the flax-path tree."""
    params: dict = {}
    unused = []
    for key, value in state_dict.items():
        v = _np(value)
        if key == "patch_embed.proj.weight":
            _set(params, ("patch_embed", "proj", "kernel"), v.transpose(2, 3, 4, 1, 0))
        elif key == "patch_embed.proj.bias":
            _set(params, ("patch_embed", "proj", "bias"), v)
        elif key == "patch_embed.norm.weight":
            _set(params, ("patch_embed", "norm", "scale"), v)
        elif key == "patch_embed.norm.bias":
            _set(params, ("patch_embed", "norm", "bias"), v)
        elif m := re.match(r"layers\.(\d+)\.blocks\.(\d+)\.(.+)", key):
            i, b, rest = m.group(1), m.group(2), m.group(3)
            base = (f"layers_{i}_blocks_{b}",)
            _map_block_param(params, base, rest, v, unused, key)
        elif m := re.match(r"layers\.(\d+)\.downsample\.(norm|reduction)\.(weight|bias)", key):
            i, mod, wb = m.groups()
            _map_merge_param(params, (f"layers_{i}_downsample",), mod, wb, v)
        elif m := re.match(r"local_feat_proj\.(norm|reduction)\.(weight|bias)", key):
            mod, wb = m.groups()
            _map_merge_param(params, ("local_feat_proj",), mod, wb, v)
        elif m := re.match(r"(norm|norm_local)\.(weight|bias)", key):
            mod, wb = m.groups()
            _set(params, (mod, "scale" if wb == "weight" else "bias"), v)
        elif "relative_position_index" in key:
            continue  # static buffer, recomputed
        else:
            unused.append(key)
    if unused:
        LOGGER.warning("swin3d converter: %d unmapped keys (first 5: %s)", len(unused), unused[:5])
    return params


_BLOCK_TABLE = {
    "norm1.weight": ("norm1", "scale", None),
    "norm1.bias": ("norm1", "bias", None),
    "norm2.weight": ("norm2", "scale", None),
    "norm2.bias": ("norm2", "bias", None),
    "attn.qkv.weight": ("attn", "qkv", "kernel"),
    "attn.qkv.bias": ("attn", "qkv", "bias"),
    "attn.proj.weight": ("attn", "proj", "kernel"),
    "attn.proj.bias": ("attn", "proj", "bias"),
    "attn.relative_position_bias_table": ("attn", "relative_position_bias_table", None),
    "mlp.fc1.weight": ("mlp_fc1", "kernel", None),
    "mlp.fc1.bias": ("mlp_fc1", "bias", None),
    "mlp.fc2.weight": ("mlp_fc2", "kernel", None),
    "mlp.fc2.bias": ("mlp_fc2", "bias", None),
}


def _map_block_param(params, base, rest, v, unused, key):
    if rest not in _BLOCK_TABLE:
        if "relative_position_index" not in rest:
            unused.append(key)
        return
    a, b, c = _BLOCK_TABLE[rest]
    path = base + ((a, b) if c is None else (a, b, c))
    if rest.endswith("weight") and ("qkv" in rest or "proj" in rest or "fc" in rest):
        v = v.T
    _set(params, path, v)


def _map_merge_param(params, base, mod, wb, v):
    if mod == "reduction":
        _set(params, base + ("reduction", "kernel"), v.T)
    else:
        _set(params, base + ("norm", "scale" if wb == "weight" else "bias"), v)


def lfvila_torch_to_flax(state_dict: Mapping) -> dict:
    """Full LFVILA_Pretrain checkpoint -> the ``LfVilaPretrain`` flax-path tree.

    Routes the reference module prefixes (``lfvila_pretrain.py:51-78``):
    ``video_encoder.*`` -> Swin3D, ``text_encoder.bert.*`` -> staged BERT
    (+pooler), ``text_encoder.cls.*`` -> MLM head, ``text_encoder.
    seq_relationship`` + the four projections + ``sent_embedding`` +
    ``video_token_pos`` -> their modules.
    """
    groups: dict[str, dict] = {}
    for key, value in state_dict.items():
        prefix, _, rest = key.partition(".")
        groups.setdefault(prefix, {})[rest] = value

    params: dict = {}
    if "video_encoder" in groups:
        params["video_encoder"] = swin3d_torch_to_flax(groups["video_encoder"])
    if "text_encoder" in groups:
        t = groups["text_encoder"]
        bert_tree, pooler, mlm = bert_torch_to_flax(t, prefix="bert.")
        if pooler:
            bert_tree["pooler"] = pooler
        params["text_encoder"] = bert_tree
        if mlm:
            params["cls"] = mlm
        if "seq_relationship.weight" in t:
            params["seq_relationship"] = {
                "kernel": _np(t["seq_relationship.weight"]).T,
                "bias": _np(t["seq_relationship.bias"]),
            }
    for proj in ("video_local_proj", "text_local_proj", "video_global_proj", "text_global_proj"):
        if proj in groups and "weight" in groups[proj]:
            params[proj] = {
                "kernel": _np(groups[proj]["weight"]).T,
                "bias": _np(groups[proj]["bias"]),
            }
    if "sent_embedding" in groups:
        s = groups["sent_embedding"]
        params["sent_embedding"] = {
            "position_embeddings": {"embedding": _np(s["position_embeddings.weight"])},
            "segment_embeddings": {"embedding": _np(s["segment_embeddings.weight"])},
            "norm": {"scale": _np(s["norm.weight"]), "bias": _np(s["norm.bias"])},
        }
    if "video_token_pos" in groups:
        v = groups["video_token_pos"]
        params["video_token_pos"] = {
            "s_pos_embed": _np(v["s_pos_embed"]),
            "t_pos_embed": _np(v["t_pos_embed"]),
            "norm": {"scale": _np(v["norm.weight"]), "bias": _np(v["norm.bias"])},
        }
    return params


_BLOCK_RE = re.compile(r"^(layers\.\d+\.blocks\.\d+\.)")
_DOWN_RE = re.compile(r"^(layers\.\d+\.downsample\.)")


def _positional_remap(keys, origin_re, target_prefixes):
    """Reference-style positional (stage, block) remapping (``load.py:111-180``).

    Origin prefixes matching ``origin_re`` are sorted by (stage, block) and
    mapped one-to-one onto ``target_prefixes`` (already in target order) —
    the 4-stage 2-D Swin layout folds onto the 6-stage HTWA layout because
    both flatten to the same 24-block (head-width-compatible) sequence.
    """
    origin = sorted(
        {m.group(1) for k in keys if (m := origin_re.match(k))},
        key=lambda p: tuple(int(x) for x in re.findall(r"\d+", p)),
    )
    n = min(len(origin), len(target_prefixes))
    if len(origin) != len(target_prefixes):
        LOGGER.warning(
            "swin2d inflation: %d source vs %d target prefixes for %s — mapping first %d",
            len(origin), len(target_prefixes), origin_re.pattern, n,
        )
    return {origin[i]: target_prefixes[i] for i in range(n)}


def _resize_bias_table_spatial(v: np.ndarray, wh: int, ww: int) -> np.ndarray:
    """[(2h-1)(2w-1), H] square spatial table -> (2wh-1, 2ww-1, H), fp32.

    Bicubic (a = -0.75, half-pixel centres, edges clamped): the JAX copy's
    ``cv2.resize(..., INTER_CUBIC)``, here ``F.interpolate(mode="bicubic",
    align_corners=False)``, which agrees with it to float rounding."""
    n2d, heads = v.shape
    side = int(round(np.sqrt(n2d)))
    table = v.reshape(side, side, heads)
    sh, sw = 2 * wh - 1, 2 * ww - 1
    if (side, side) != (sh, sw):
        t = torch.from_numpy(np.ascontiguousarray(table, dtype=np.float32)).permute(2, 0, 1)[None]
        t = F.interpolate(t, size=(sh, sw), mode="bicubic", align_corners=False)
        table = t[0].permute(1, 2, 0).numpy()
    return table


def inflate_swin2d_to_3d(
    state_dict_2d: Mapping,
    windows3d,
    depths3d: tuple = (2, 2, 14, 2, 2, 2),
    downsample_stages3d: tuple = (0, 1, 4),
    patch_size3d: tuple[int, int, int] = (1, 8, 8),
) -> dict[str, np.ndarray]:
    """Inflate 2-D (ImageNet Swin) weights into the 3-D HTWA layout, in
    torch-key space (ref ``load.py:94-240``):

    - **(stage, block) remapping**: the 2-D checkpoint's 4-stage layout
      (e.g. depths [2,2,18,2]) is folded positionally onto the 6-stage HTWA
      layout ``depths3d`` (ref ``load.py:111-147``); downsample modules map
      positionally onto ``downsample_stages3d`` (ref ``load.py:151-180``).
    - ``local_feat_proj.*`` is seeded from the 2-D stage-2 downsample and
      ``norm_local.*`` from the final norm (ref ``load.py:108-113``).
    - Relative position bias tables are inflated **per target stage** with
      that stage's window from ``windows3d`` (ref ``load.py:212-216``):
      bicubic spatial resize to (2wh-1)(2ww-1) then tiled (2wd-1)x along the
      temporal axis.
    - ``patch_embed.proj.weight`` [O,I,kh,kw] -> [O,I,kd,kh',kw'] tiled over
      the temporal extent kd and, when the 3-D spatial patch is an integer
      multiple of the 2-D one (8x8 vs 4x4), tiled spatially — divided by the
      total tile count (ref ``load.py:230-238``).

    ``windows3d`` is the per-stage window tuple (``Swin3DConfig.window_size``);
    a single ``(wd, wh, ww)`` is broadcast to every stage. The result feeds
    :func:`swin3d_torch_to_flax`.
    """
    if windows3d and isinstance(windows3d[0], int):
        windows3d = tuple(tuple(windows3d) for _ in depths3d)
    windows3d = tuple(tuple(w) for w in windows3d)
    if len(windows3d) != len(depths3d):
        raise ValueError(f"{len(windows3d)} windows for {len(depths3d)} stages")

    sd = {k: _np(v) for k, v in state_dict_2d.items()}
    # seed the HTWA-only modules from their 2-D analogues (ref load.py:108-113)
    for src, dst in (
        ("layers.2.downsample.reduction.weight", "local_feat_proj.reduction.weight"),
        ("layers.2.downsample.norm.weight", "local_feat_proj.norm.weight"),
        ("layers.2.downsample.norm.bias", "local_feat_proj.norm.bias"),
        ("norm.weight", "norm_local.weight"),
        ("norm.bias", "norm_local.bias"),
    ):
        if src in sd:
            sd[dst] = sd[src]

    block_targets = [f"layers.{i}.blocks.{b}." for i, d in enumerate(depths3d) for b in range(d)]
    down_targets = [f"layers.{i}.downsample." for i in sorted(downsample_stages3d)]
    remap = _positional_remap(sd, _BLOCK_RE, block_targets)
    remap.update(_positional_remap(sd, _DOWN_RE, down_targets))

    out: dict[str, np.ndarray] = {}
    for key, v in sd.items():
        if "relative_position_index" in key or "attn_mask" in key:
            continue
        if m := (_BLOCK_RE.match(key) or _DOWN_RE.match(key)):
            if m.group(1) not in remap:
                continue  # beyond the target layout (warned in _positional_remap)
            key = remap[m.group(1)] + key[len(m.group(1)):]
        if key == "patch_embed.proj.weight":
            kd, kh3, kw3 = patch_size3d
            kh, kw = v.shape[-2:]
            rh, rw = (kh3 // kh, kw3 // kw) if (kh3 % kh == 0 and kw3 % kw == 0) else (1, 1)
            if (rh * kh, rw * kw) != (kh3, kw3):
                LOGGER.warning(
                    "swin2d inflation: 2-D patch %dx%d not tileable to %dx%d — "
                    "keeping 2-D spatial kernel (merge will skip on mismatch)",
                    kh, kw, kh3, kw3,
                )
            out[key] = np.tile(v[:, :, None], (1, 1, kd, rh, rw)) / (kd * rh * rw)
        elif key.endswith("relative_position_bias_table"):
            stage = int(key.split(".")[1])
            wd, wh, ww = windows3d[stage]
            table = _resize_bias_table_spatial(v, wh, ww)
            sh, sw = 2 * wh - 1, 2 * ww - 1
            heads = table.shape[-1]
            out[key] = np.tile(table.reshape(1, sh * sw, heads), (2 * wd - 1, 1, 1)).reshape(-1, heads)
        else:
            out[key] = v
    return out
