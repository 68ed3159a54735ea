"""HD-VILA two-stage BERT transformer + pretraining and task heads (PyTorch).

Counterpart of ``xpretrain_tpu/models/hd_vila/modeling.py`` (ref
``hd-vila/src/modeling/modeling_stage.py``):

- :class:`VisualInputEmbedding`: temporal mean-pool of the grid, learned
  2-D row/col position embeddings, train-time pixel random sampling
  (ref ``:41-154``).
- :class:`HdVilaBaseModel`: ``forward_stage1`` text alone through the first
  half of a BERT (+pooler1); ``forward_stage2`` text + visual through the
  second half (+pooler2) (ref ``:157-312``).
- :class:`HdVilaForPreTraining`: stage-1 ITC features from mean-pooled text
  (``bert_mean``) and the mean-pooled grid through ``t_proj``/``v_proj``;
  stage-2 MLM + ITM over clip-aggregated (mean/max/lse) fusion outputs
  (ref ``:315-462``).
- Task heads: sequence classification, multiple choice, regression and
  retrieval rerank (ref ``:482-751``).

The clip axis stays a leading batch-like axis: every clip fuses with the
(tiled) text on its own, clip-major, then the outputs aggregate over clips.

Flax creates parameters lazily, so a module exists here only where its
flax counterpart is called: a stage-1 pretraining model has the BERT's
first stage, ``pooler1``, ``t_proj`` and ``v_proj`` alone; the fusion half,
``pooler2``, ``visual_embeddings``, ``cls`` and ``seq_relationship`` come
with stage 2 (and every task head fuses). ``models/hd_vila/convert.py``
then loads either tree totally.

Pixel random sampling draws its sorted subset from the ``torch.Generator``
handed to ``forward`` (JAX: ``jax.random.permutation``; the bits differ),
or takes it as ``sample_indices``, which the parity tests pass from JAX's
draw. ``module.training`` stands for flax's ``deterministic=False``.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from xpretrain_tpu_torch.models.bert import BertConfig, BertMLMHead, BertPooler, StagedBertModel
from xpretrain_tpu_torch.models.clip_vip.model import l2_normalize
from xpretrain_tpu_torch.models.common import Embedding, LayerNorm, Linear, dropout
from xpretrain_tpu_torch.ops.losses import global_ratio, itm_loss, mlm_loss


@dataclasses.dataclass(frozen=True)
class HdVilaModelConfig:
    bert: BertConfig = dataclasses.field(default_factory=lambda: BertConfig.bert_large(stage_bounds=(12,)))
    stage: int = 1
    max_grid_row_position_embeddings: int = 100
    max_grid_col_position_embeddings: int = 100
    pixel_random_sampling_size: int = 160
    score_agg_func: str = "mean"  # mean | max | lse
    bert_mean: bool = True
    temp: float = 0.05
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny(**overrides) -> "HdVilaModelConfig":
        base = dict(bert=BertConfig(hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
                                    intermediate_size=128, stage_bounds=(2,), vocab_size=1000))
        base.update(overrides)
        return HdVilaModelConfig(**base)


class VisualInputEmbedding(nn.Module):
    """Grid -> visual token sequence (ref ``modeling_stage.py:41-154``)."""

    def __init__(self, config: HdVilaModelConfig, device=None):
        super().__init__()
        self.config = config
        hidden = config.bert.hidden_size
        self.row_position_embeddings = Embedding(config.max_grid_row_position_embeddings, hidden, config.dtype,
                                                 device)
        self.col_position_embeddings = Embedding(config.max_grid_col_position_embeddings, hidden, config.dtype,
                                                 device)
        self.token_type_embedding = nn.Parameter(torch.zeros(1, 1, hidden, device=device))
        self.LayerNorm = LayerNorm(hidden, config.bert.layer_norm_eps, config.dtype, device)

    def forward(
        self,
        grid: torch.Tensor,  # [B, n_frm, H, W, C]
        generator: Optional[torch.Generator] = None,
        sample: bool = False,
        sample_indices: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Tokens [B, H*W or the sample size, C]. In training with ``sample``
        set, ``pixel_random_sampling_size`` positions (when below H*W) are
        kept: ``sample_indices`` when given, else a sorted draw without
        replacement from ``generator`` (ref ``:79-89``)."""
        cfg = self.config
        grid = grid.mean(dim=1)  # temporal mean pool -> [B, H, W, C]
        B, H, W, C = grid.shape
        row = self.row_position_embeddings(torch.arange(H, device=grid.device))
        col = self.col_position_embeddings(torch.arange(W, device=grid.device))
        tokens = (grid + row[None, :, None] + col[None, None, :]).reshape(B, H * W, C)
        size = cfg.pixel_random_sampling_size
        if self.training and sample and 0 < size < H * W:
            if sample_indices is None:
                device = generator.device if generator is not None else tokens.device
                perm = torch.randperm(H * W, generator=generator, device=device)
                sample_indices = torch.sort(perm[:size]).values
            tokens = tokens[:, torch.as_tensor(sample_indices, device=tokens.device)]
        tokens = self.LayerNorm(tokens + self.token_type_embedding.to(tokens.dtype))
        return dropout(tokens, cfg.bert.hidden_dropout_prob if self.training else 0.0, generator)


class HdVilaBaseModel(nn.Module):
    """Two-stage BERT with separate poolers (ref ``:157-312``); ``fusion``
    builds the second stage, ``pooler2`` and the visual embeddings."""

    def __init__(self, config: HdVilaModelConfig, fusion: bool = True, device=None):
        super().__init__()
        cfg = self.config = config
        self.bert = StagedBertModel(cfg.bert, cfg.dtype, device,
                                    num_layers=None if fusion else cfg.bert.stage_range(0)[1])
        self.pooler1 = BertPooler(cfg.bert.hidden_size, cfg.dtype, device)
        if fusion:
            self.pooler2 = BertPooler(cfg.bert.hidden_size, cfg.dtype, device)
            self.visual_embeddings = VisualInputEmbedding(cfg, device)

    def forward_stage1(self, text_input_ids: torch.Tensor, attention_mask: torch.Tensor,
                       generator: Optional[torch.Generator] = None) -> tuple[torch.Tensor, torch.Tensor]:
        hidden = self.bert(input_ids=text_input_ids, attention_mask=attention_mask, stage=0, generator=generator)
        return hidden, self.pooler1(hidden)

    def forward_stage2(
        self,
        text_hidden: torch.Tensor,  # [clips*B, Lt, C] (text tiled per clip)
        visual_inputs: torch.Tensor,  # [clips*B, n_frm, H, W, C]
        attention_mask: torch.Tensor,  # [clips*B, Lt]
        generator: Optional[torch.Generator] = None,
        sample: bool = False,
        sample_indices: Optional[torch.Tensor] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        visual_tokens = self.visual_embeddings(visual_inputs, generator, sample, sample_indices)
        visual_mask = torch.ones(visual_tokens.shape[:2], dtype=attention_mask.dtype, device=attention_mask.device)
        hidden = self.bert(
            inputs_embeds=torch.cat([text_hidden, visual_tokens], dim=1),
            attention_mask=torch.cat([attention_mask, visual_mask], dim=1),
            stage=1,
            generator=generator,
        )
        return hidden, self.pooler2(hidden)


def _agg_clips(x: torch.Tensor, method: str) -> torch.Tensor:
    if method == "mean":
        return x.mean(dim=0)
    if method == "max":
        return x.max(dim=0).values
    if method == "lse":
        return torch.logsumexp(x, dim=0)
    raise ValueError(f"bad score_agg_func {method!r}")


def _tile_clips(text_hidden: torch.Tensor, mask: torch.Tensor, visual_inputs: torch.Tensor
                ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The text tiled per clip and the grid flattened clip-major:
    ([clips*B, Lt, C], [clips*B, Lt], [clips*B, n_frm, H, W, C])."""
    B, clips = visual_inputs.shape[:2]
    vis = visual_inputs.transpose(0, 1).reshape(clips * B, *visual_inputs.shape[2:])
    return text_hidden.repeat(clips, 1, 1), mask.repeat(clips, 1), vis


def _masked_mean(hidden: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    m = mask[..., None].to(hidden.dtype)
    return (hidden * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)


class HdVilaForPreTraining(nn.Module):
    """ITC (stage 1) + MLM/ITM (stage 2) heads (ref ``:315-462``)."""

    def __init__(self, config: HdVilaModelConfig, device=None):
        super().__init__()
        cfg = self.config = config
        fusion = cfg.stage != 1
        hidden = cfg.bert.hidden_size
        self.bert_model = HdVilaBaseModel(cfg, fusion=fusion, device=device)
        if fusion:
            self.cls = BertMLMHead(cfg.bert, cfg.dtype, device)
            self.seq_relationship = Linear(hidden, 2, dtype=cfg.dtype, device=device)
        self.t_proj = Linear(hidden, hidden, dtype=cfg.dtype, device=device)
        self.v_proj = Linear(hidden, hidden, dtype=cfg.dtype, device=device)

    def _text_features(self, text_hidden: torch.Tensor, pooled1: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.config.bert_mean:
            # masked mean over tokens, then pooler1's dense + tanh (ref :385-387)
            pooled1 = self.bert_model.pooler1(_masked_mean(text_hidden, mask)[:, None])
        return l2_normalize(self.t_proj(pooled1))

    def forward(
        self,
        visual_inputs: torch.Tensor,  # [B, clips, n_frm, H, W, C] from HdVilaEncoder
        text_input_ids: torch.Tensor,
        text_input_mask: torch.Tensor,
        mlm_labels: Optional[torch.Tensor] = None,
        itm_labels: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        sample_indices: Optional[torch.Tensor] = None,
    ) -> dict[str, torch.Tensor]:
        cfg = self.config
        text_hidden, pooled1 = self.bert_model.forward_stage1(text_input_ids, text_input_mask, generator)
        out: dict[str, torch.Tensor] = {
            "text_features": self._text_features(text_hidden, pooled1, text_input_mask),
            # ITC features: the raw grid mean-pooled over (clips, frm, H, W)
            "vis_features": self.project_visual(visual_inputs),
        }
        if cfg.stage == 1:
            return out

        # stage 2: text tiled per clip, each clip fused on its own
        clips, B = visual_inputs.shape[1], visual_inputs.shape[0]
        text_rep, mask_rep, vis_flat = _tile_clips(text_hidden, text_input_mask, visual_inputs)
        seq_out, pooled2 = self.bert_model.forward_stage2(
            text_rep, vis_flat, mask_rep, generator, sample=True, sample_indices=sample_indices)
        Lt = text_input_mask.shape[1]
        seq_out = seq_out.reshape(clips, B, *seq_out.shape[1:])
        out["vtoken_output"] = seq_out[:, :, Lt:]
        mlm_logits = self.cls(_agg_clips(seq_out, cfg.score_agg_func)[:, :Lt])
        itm_logits = self.seq_relationship(_agg_clips(pooled2.reshape(clips, B, -1), cfg.score_agg_func))
        out["mlm_logits"] = mlm_logits
        out["itm_logits"] = itm_logits
        if mlm_labels is not None:
            labels = mlm_labels
            if itm_labels is not None:
                # negative pairs carry no MLM signal (ref :431)
                labels = torch.where(itm_labels[:, None] == 0, torch.full_like(labels, -100), labels)
            out["mlm_loss"] = mlm_loss(mlm_logits, labels)
            sel = labels != -100
            correct = (mlm_logits.argmax(dim=-1) == labels) & sel
            out["mlm_acc"] = global_ratio(correct.sum(), sel.sum())
        if itm_labels is not None:
            out["itm_loss"] = itm_loss(itm_logits, itm_labels)
            out["itm_acc"] = (itm_logits.argmax(dim=-1) == itm_labels).float().mean()
        return out

    def forward_text(self, text_input_ids: torch.Tensor, text_input_mask: torch.Tensor) -> torch.Tensor:
        """Text tower alone: stage-0 BERT -> pooled -> t_proj -> L2 norm (the
        text half of ``forward``'s stage-1 features)."""
        text_hidden, pooled1 = self.bert_model.forward_stage1(text_input_ids, text_input_mask)
        return self._text_features(text_hidden, pooled1, text_input_mask)

    def project_visual(self, visual_inputs: torch.Tensor) -> torch.Tensor:
        """ITC video projection of the encoder grid: mean-pool -> v_proj -> L2."""
        return l2_normalize(self.v_proj(visual_inputs.mean(dim=(1, 2, 3, 4))))


class _MLPHead(nn.Module):
    """flax ``nn.Sequential([Dense(2h), relu, Dense(n)])``: the Dense layers
    are the sequence's items 0 and 2, ``layers_0`` and ``layers_2``."""

    def __init__(self, hidden: int, out: int, dtype: torch.dtype, device=None):
        super().__init__()
        self.layers_0 = Linear(hidden, 2 * hidden, dtype=dtype, device=device)
        self.layers_2 = Linear(2 * hidden, out, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.layers_2(F.relu(self.layers_0(x)))


def _fused_pooled(bert_model: HdVilaBaseModel, visual_inputs, text_input_ids, text_input_mask, generator):
    """Stage 1 on the text, then every clip fused with it: pooler2's output
    [clips*B, C], clip-major, and stage 1's (hidden, pooled)."""
    text_hidden, pooled1 = bert_model.forward_stage1(text_input_ids, text_input_mask, generator)
    text_rep, mask_rep, vis_flat = _tile_clips(text_hidden, text_input_mask, visual_inputs)
    _, pooled2 = bert_model.forward_stage2(text_rep, vis_flat, mask_rep, generator)
    return pooled2, pooled1


class HdVilaForSequenceClassification(nn.Module):
    """QA-as-classification head over the fused [CLS] (ref ``:482-546``)."""

    def __init__(self, config: HdVilaModelConfig, num_labels: int, device=None):
        super().__init__()
        self.config = config
        self.bert_model = HdVilaBaseModel(config, device=device)
        self.classifier = _MLPHead(config.bert.hidden_size, num_labels, config.dtype, device)

    def forward(self, visual_inputs, text_input_ids, text_input_mask, generator=None) -> dict[str, torch.Tensor]:
        B, clips = visual_inputs.shape[:2]
        pooled2, _ = _fused_pooled(self.bert_model, visual_inputs, text_input_ids, text_input_mask, generator)
        # clip aggregation happens on the LOGITS, as the reference's eval
        # pools model logits with score_agg_func before the argmax
        # (run_video_qa.py:270-280)
        pooled = dropout(pooled2, self.config.bert.hidden_dropout_prob if self.training else 0.0, generator)
        logits = self.classifier(pooled).reshape(clips, B, -1)
        return {"logits": _agg_clips(logits, self.config.score_agg_func)}


class HdVilaForMultipleChoice(nn.Module):
    """N-way multiple choice: each choice fused separately (ref ``:549-623``)."""

    def __init__(self, config: HdVilaModelConfig, device=None):
        super().__init__()
        self.config = config
        self.bert_model = HdVilaBaseModel(config, device=device)
        self.classifier = _MLPHead(config.bert.hidden_size, 1, config.dtype, device)

    def forward(self, visual_inputs, text_input_ids, text_input_mask, generator=None) -> dict[str, torch.Tensor]:
        B, n_choice, Lt = text_input_ids.shape
        clips = visual_inputs.shape[1]
        # each sample's clips repeated across its choices
        vis = visual_inputs.repeat_interleave(n_choice, dim=0)  # [B*n_choice, clips, ...]
        pooled2, _ = _fused_pooled(self.bert_model, vis, text_input_ids.reshape(B * n_choice, Lt),
                                   text_input_mask.reshape(B * n_choice, Lt), generator)
        pooled = dropout(pooled2, self.config.bert.hidden_dropout_prob if self.training else 0.0, generator)
        logits = self.classifier(pooled).reshape(clips, B * n_choice)
        return {"logits": _agg_clips(logits, self.config.score_agg_func).reshape(B, n_choice)}


class HdVilaForRegression(nn.Module):
    """Scalar regression head (ref ``:625-678``)."""

    def __init__(self, config: HdVilaModelConfig, device=None):
        super().__init__()
        self.config = config
        self.bert_model = HdVilaBaseModel(config, device=device)
        self.regressor = _MLPHead(config.bert.hidden_size, 1, config.dtype, device)

    def forward(self, visual_inputs, text_input_ids, text_input_mask, generator=None) -> dict[str, torch.Tensor]:
        B, clips = visual_inputs.shape[:2]
        pooled2, _ = _fused_pooled(self.bert_model, visual_inputs, text_input_ids, text_input_mask, generator)
        logits = self.regressor(pooled2).reshape(clips, B)
        return {"logits": _agg_clips(logits, self.config.score_agg_func)}


class HdVilaForVideoTextRetrieval(nn.Module):
    """Fusion-rerank retrieval head (ref ``:694-751``)."""

    def __init__(self, config: HdVilaModelConfig, device=None):
        super().__init__()
        self.config = config
        hidden = config.bert.hidden_size
        self.bert_model = HdVilaBaseModel(config, device=device)
        self.classifier = _MLPHead(hidden, 1, config.dtype, device)
        self.t_proj = Linear(hidden, hidden, dtype=config.dtype, device=device)
        self.v_proj = Linear(hidden, hidden, dtype=config.dtype, device=device)

    def forward(self, visual_inputs, text_input_ids, text_input_mask, generator=None) -> dict[str, torch.Tensor]:
        B, clips = visual_inputs.shape[:2]
        pooled2, pooled1 = _fused_pooled(self.bert_model, visual_inputs, text_input_ids, text_input_mask,
                                         generator)
        logits = self.classifier(pooled2).reshape(clips, B)
        return {
            "logits": _agg_clips(logits, self.config.score_agg_func),
            "text_features": l2_normalize(self.t_proj(pooled1)),
            "vis_features": l2_normalize(self.v_proj(visual_inputs.mean(dim=(1, 2, 3, 4)))),
        }
