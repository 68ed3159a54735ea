"""CLI-facing pretrained-weight loading for the HD-VILA and LF-VILA families
(the port's copy of ``xpretrain_tpu/models/pretrained.py``).

HD-VILA: ``--e2e_weights_path`` loads a full reference ``HDVILA`` torch
checkpoint (the stage-2 recipe restores stage-1 e2e weights this way, ref
``run_pretrain_stage2_group.py:138-144``; the fine-tunes restore e2e or task
checkpoints, ``hd-vila/src/utils/load.py``). LF-VILA's WEIGHTS cascade of ``LF-VILA/src/run_pretrain.py:52-77``:
``model_weight`` (full) | ``stage1_model_weight`` (+``bert_weight``) |
``swin_weight`` (2-D inflated when ``pretrained_2d``) + ``bert_weight``.
Each load converts the reference's torch checkpoint to the flax-path tree
(``models/lf_vila/convert.py``, ``models/bert_convert.py``) and merges it
into the model's parameters in place, shape-tolerantly: a mismatch keeps the
init, as the reference's ``load_model_weights_with_mismatch``.
"""

from __future__ import annotations

from typing import Mapping, Optional

from torch import nn

from xpretrain_tpu_torch.models.bert_convert import bert_torch_to_flax
from xpretrain_tpu_torch.models.clip_vip.convert import load_torch_checkpoint
from xpretrain_tpu_torch.models.hd_vila.convert import hdvila_e2e_torch_to_flax
from xpretrain_tpu_torch.models.lf_vila.convert import (
    inflate_swin2d_to_3d,
    lfvila_torch_to_flax,
    merge_flax_tree,
    swin3d_torch_to_flax,
)
from xpretrain_tpu_torch.models.lf_vila.swin3d import Swin3DConfig
from xpretrain_tpu_torch.utils.logging import LOGGER


def merge_into(model: nn.Module, converted: Mapping, scope: str = "") -> None:
    """Shape-tolerant merge of a converted flax-path tree into ``model``, at
    the top or under the module ``scope`` (``merge_flax_tree``)."""
    merge_flax_tree(model, converted, tuple(scope.split("/")) if scope else ())


def load_hdvila_e2e(model: nn.Module, path: str) -> nn.Module:
    """Merge a reference HDVILA e2e torch checkpoint into ``model`` in place.

    The converted tree is ``{"encoder": ..., "transformer": ...}``, the
    submodule names of ``HdVilaPretrainModel``. A task model (QA, multiple
    choice, regression, rerank) holds the staged BERT in its ``head``: the
    pretraining transformer's submodules that the head also has
    (``bert_model``, and the rerank head's ``t_proj``/``v_proj``) go there,
    and the head's own classifier keeps its init. The merge is
    shape-tolerant, as ``merge_into``."""
    converted = dict(hdvila_e2e_torch_to_flax(load_torch_checkpoint(path)))
    children = dict(model.named_children())
    if "transformer" in converted and "transformer" not in children and "head" in children:
        trans = converted.pop("transformer")
        head = {name for name, _ in children["head"].named_children()}
        head |= {name for name, _ in children["head"].named_parameters(recurse=False)}
        routed = {k: v for k, v in trans.items() if k in head}
        if routed:
            converted["head"] = routed
    LOGGER.info("loaded HD-VILA e2e weights from %s", path)
    merge_into(model, converted)
    return model


def _load_bert(model: nn.Module, path: str) -> None:
    bert, pooler, mlm = bert_torch_to_flax(load_torch_checkpoint(path))
    if pooler:
        bert["pooler"] = pooler
    merge_into(model, bert, scope="text_encoder")
    if mlm:
        merge_into(model, mlm, scope="cls")
    LOGGER.info("loaded BERT weights from %s", path)


def load_lfvila_cascade(
    model: nn.Module,
    model_weight: str = "",
    stage1_model_weight: str = "",
    swin_weight: str = "",
    bert_weight: str = "",
    pretrained_2d: bool = True,
    swin_config: Optional[Swin3DConfig] = None,
) -> nn.Module:
    """The reference's WEIGHTS cascade (``run_pretrain.py:52-77``), into
    ``model`` in place.

    Priority: full ``model_weight`` > ``stage1_model_weight`` (bert loaded
    first so stage-1 keys win) > per-encoder ``swin_weight``/``bert_weight``.
    ``swin_config`` (the model's :class:`Swin3DConfig`; default-constructed
    when None) supplies the per-stage windows / depths / downsample stages /
    patch size that drive the 2-D inflation (ref ``load.py:199-238`` reads the
    same geometry off the live model).
    """
    if model_weight:
        merge_into(model, lfvila_torch_to_flax(load_torch_checkpoint(model_weight)))
        LOGGER.info("loaded full LF-VILA weights from %s", model_weight)
        return model

    if stage1_model_weight:
        if bert_weight:
            _load_bert(model, bert_weight)
        merge_into(model, lfvila_torch_to_flax(load_torch_checkpoint(stage1_model_weight)))
        LOGGER.info("loaded LF-VILA stage-1 weights from %s", stage1_model_weight)
        return model

    if swin_weight:
        sd = load_torch_checkpoint(swin_weight)
        if pretrained_2d:
            swin_config = swin_config or Swin3DConfig()
            sd = inflate_swin2d_to_3d(
                sd,
                swin_config.window_size,
                depths3d=tuple(swin_config.depths),
                downsample_stages3d=tuple(swin_config.downsample_stages),
                patch_size3d=tuple(swin_config.patch_size),
            )
        merge_into(model, swin3d_torch_to_flax(sd), scope="video_encoder")
        LOGGER.info("loaded %sSwin weights from %s", "inflated 2-D " if pretrained_2d else "", swin_weight)
    if bert_weight:
        _load_bert(model, bert_weight)
    return model
