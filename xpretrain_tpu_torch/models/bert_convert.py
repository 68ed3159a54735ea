"""HF BERT checkpoint -> ``StagedBertModel`` flax-path tree (the port's copy
of ``xpretrain_tpu/models/bert_convert.py``).

Covers the text-tower loading paths of HD-VILA (BERT-large into the
two-stage model, ``hd-vila/src/pretrain/run_pretrain_stage1_group.py:94-138``)
and LF-VILA (``LF-VILA/src/run_pretrain.py:52-77``), plus MLM/pooler heads.
The trees are keyed by the flax module paths, which the port's modules
carry too: ``xpretrain_tpu_torch.models.lf_vila.convert.merge_flax_tree``
places them.
"""

from __future__ import annotations

import re
from typing import Mapping

import numpy as np

import torch

from xpretrain_tpu_torch.utils.logging import LOGGER


def _np(v) -> np.ndarray:
    if isinstance(v, torch.Tensor):
        v = v.detach().cpu().float().numpy()
    return np.asarray(v)


def _set(tree: dict, path: tuple[str, ...], value) -> None:
    node = tree
    for p in path[:-1]:
        node = node.setdefault(p, {})
    node[path[-1]] = value


_EMB = {
    "word_embeddings.weight": ("embeddings", "word_embeddings", "embedding"),
    "position_embeddings.weight": ("embeddings", "position_embeddings", "embedding"),
    "token_type_embeddings.weight": ("embeddings", "token_type_embeddings", "embedding"),
    "LayerNorm.weight": ("embeddings", "LayerNorm", "scale"),
    "LayerNorm.bias": ("embeddings", "LayerNorm", "bias"),
    # some forks name it LayerNorm.gamma/beta
    "LayerNorm.gamma": ("embeddings", "LayerNorm", "scale"),
    "LayerNorm.beta": ("embeddings", "LayerNorm", "bias"),
}

_LAYER = {
    "attention.self.query.weight": ("attention_self", "query", "kernel"),
    "attention.self.query.bias": ("attention_self", "query", "bias"),
    "attention.self.key.weight": ("attention_self", "key", "kernel"),
    "attention.self.key.bias": ("attention_self", "key", "bias"),
    "attention.self.value.weight": ("attention_self", "value", "kernel"),
    "attention.self.value.bias": ("attention_self", "value", "bias"),
    "attention.output.dense.weight": ("attention_output_dense", "kernel"),
    "attention.output.dense.bias": ("attention_output_dense", "bias"),
    "attention.output.LayerNorm.weight": ("attention_output_LayerNorm", "scale"),
    "attention.output.LayerNorm.bias": ("attention_output_LayerNorm", "bias"),
    "intermediate.dense.weight": ("intermediate_dense", "kernel"),
    "intermediate.dense.bias": ("intermediate_dense", "bias"),
    "output.dense.weight": ("output_dense", "kernel"),
    "output.dense.bias": ("output_dense", "bias"),
    "output.LayerNorm.weight": ("output_LayerNorm", "scale"),
    "output.LayerNorm.bias": ("output_LayerNorm", "bias"),
}


def bert_torch_to_flax(
    state_dict: Mapping, prefix: str = "bert."
) -> tuple[dict, dict, dict]:
    """-> (bert_params, pooler_params, mlm_head_params).

    ``bert_params`` fits :class:`StagedBertModel`'s ``embeddings``/``encoder``
    scopes; pooler and MLM head trees match :class:`BertPooler` /
    :class:`BertMLMHead`.
    """
    bert: dict = {}
    pooler: dict = {}
    mlm: dict = {}
    unused = []
    for key, value in state_dict.items():
        v = _np(value)
        k = key[len(prefix):] if prefix and key.startswith(prefix) else key
        if k.startswith("embeddings."):
            sub = k[len("embeddings."):]
            if sub in _EMB:
                _set(bert, _EMB[sub], v)
            elif "position_ids" not in sub:
                unused.append(key)
        elif m := re.match(r"encoder\.layer\.(\d+)\.(.+)", k):
            i, rest = m.groups()
            if rest in _LAYER:
                path = ("encoder", f"layer_{i}") + _LAYER[rest]
                if rest.endswith("dense.weight") or re.search(r"(query|key|value)\.weight$", rest):
                    v = v.T
                _set(bert, path, v)
            else:
                unused.append(key)
        elif k in ("pooler.dense.weight", "pooler.dense.bias"):
            _set(pooler, ("dense", "kernel" if k.endswith("weight") else "bias"),
                 v.T if k.endswith("weight") else v)
        elif m := re.match(r"(?:cls\.predictions|predictions)\.(.+)", key):
            rest = m.group(1)
            table = {
                "transform.dense.weight": ("transform_dense", "kernel"),
                "transform.dense.bias": ("transform_dense", "bias"),
                "transform.LayerNorm.weight": ("transform_LayerNorm", "scale"),
                "transform.LayerNorm.bias": ("transform_LayerNorm", "bias"),
                "decoder.weight": ("decoder", "kernel"),
                "decoder.bias": ("decoder", "bias"),
                "bias": ("decoder", "bias"),
            }
            if rest in table:
                if rest.endswith("weight") and "LayerNorm" not in rest:
                    v = v.T
                _set(mlm, table[rest], v)
            else:
                unused.append(key)
        elif "position_ids" in key:
            continue
        else:
            unused.append(key)
    if unused:
        LOGGER.warning("bert converter: %d unmapped keys (first 5: %s)", len(unused), unused[:5])
    return bert, pooler, mlm
