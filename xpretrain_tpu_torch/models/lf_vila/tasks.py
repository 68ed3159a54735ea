"""LF-VILA downstream task models (PyTorch).

Counterpart of ``xpretrain_tpu/models/lf_vila/tasks.py``:

- :class:`LfVilaRetrieval`: the stage-1 dual encoder for paragraph-to-video
  retrieval (ref ``lfvila_retrieval.py:19-109``): the Swin3D/HTWA video
  tower, MaxPool(2,3)-downsampled and clip-mean-pooled, against the
  hierarchical text tower (BERT stage 0 per sentence, sentence embeddings, a
  mean-CLS token, BERT stage 1 over the paragraph), both projected and
  L2-normalized, with the fixed-temperature InfoNCE loss.
- :class:`LfVilaQAMultichoice`: per-choice fusion QA with a frame-level span
  classifier (``lfvila_qa_multichoice.py:17-109``).
- :class:`LfVilaQAClassification`: open-ended QA as classification with
  label smoothing (``lfvila_qa_classification.py``).
- :class:`LfVilaVideoClassification`: video-only classification
  (``lfvila_video_classification.py:16-68``).

Flax creates parameters lazily, so a JAX ``LfVilaRetrieval`` has none for
the BERT pooler and the stage-2 (fusion) layers, which retrieval never runs,
while the two QA heads reach both. ``_LfVilaBase`` builds the text encoder to
the end of stage 1 without a pooler, or whole with its pooler when the head
fuses (``fusion=True``), so each port model holds exactly the flax tree's
parameters.

``module.training`` stands for flax's ``deterministic=False``; dropout draws
from the ``torch.Generator`` handed to ``forward``.
"""

from __future__ import annotations

from typing import Optional

import torch
from torch import nn

from xpretrain_tpu_torch.models.bert import StagedBertModel
from xpretrain_tpu_torch.models.clip_vip.model import l2_normalize
from xpretrain_tpu_torch.models.common import Linear, dropout
from xpretrain_tpu_torch.models.lf_vila.pretrain import (
    LfVilaConfig,
    SentEmbedding,
    VideoTokenPos,
    accuracy,
    downsample_video_embd,
    encode_text_stages,
    init_lfvila_weights,
)
from xpretrain_tpu_torch.models.lf_vila.swin3d import SwinTransformer3D
from xpretrain_tpu_torch.ops.losses import label_smoothing_xent, nce_loss, softmax_xent
from xpretrain_tpu_torch.parallel.mesh import gather_rows


class _LfVilaBase(nn.Module):
    """The shared encoders and the MaxPool(2,3) video downsample; with
    ``fusion`` the text encoder has its stage-2 layers and its pooler."""

    def __init__(self, config: LfVilaConfig, device=None, fusion: bool = False):
        super().__init__()
        cfg = self.config = config
        self.video_encoder = SwinTransformer3D(cfg.video, device)
        self.text_encoder = StagedBertModel(cfg.bert, cfg.dtype, device, with_pooler=fusion,
                                            num_layers=None if fusion else cfg.bert.stage_range(1)[1])
        self.sent_embedding = SentEmbedding(cfg.bert, cfg.dtype, device)

    def downsample_video_embd(self, video_embd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, N, H, W, C] -> (clip features [B, sample_clip, C], tokens [B, N, X, C])."""
        return downsample_video_embd(video_embd, self.config.sample_clip)

    def encode_text_global(self, text_ids: torch.Tensor, attention_mask: torch.Tensor,
                           generator: Optional[torch.Generator] = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-sentence stage 0 -> SentEmbedding -> mean-CLS prepend -> stage 1.

        [B, M, L] ids and mask -> (hidden [B, 1+M*L, C], mask [B, 1+M*L])."""
        _, hidden, mask = encode_text_stages(self.text_encoder, self.sent_embedding, text_ids, attention_mask,
                                             generator)
        return hidden, mask

    def fuse(self, video_tokens: torch.Tensor, text_hidden: torch.Tensor, text_mask: torch.Tensor,
             generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """BERT stage 2 over text [B, T, C] then video tokens [B, V, C]."""
        ones = torch.ones(video_tokens.shape[:2], dtype=text_mask.dtype, device=text_mask.device)
        return self.text_encoder(inputs_embeds=torch.cat([text_hidden, video_tokens], dim=1),
                                 attention_mask=torch.cat([text_mask, ones], dim=1), stage=2,
                                 generator=generator)

    def init_weights(self, generator: torch.Generator) -> "_LfVilaBase":
        """Random init from ``generator`` (``pretrain.init_lfvila_weights``)."""
        return init_lfvila_weights(self, generator)


class LfVilaRetrieval(_LfVilaBase):
    """The stage-1 dual encoder with InfoNCE (ref ``lfvila_retrieval.py``)."""

    def __init__(self, config: LfVilaConfig, device=None):
        super().__init__(config, device)
        hidden = config.bert.hidden_size
        self.video_global_proj = Linear(hidden, hidden, dtype=config.dtype, device=device)
        self.text_global_proj = Linear(hidden, hidden, dtype=config.dtype, device=device)

    def forward(
        self,
        video_frames: torch.Tensor,  # fp32 [B, C, N, H, W] or uint8 [B, N, H, W, 3]
        text_ids: torch.Tensor,  # [B, M, L]
        attention_mask: torch.Tensor,  # [B, M, L]
        generator: Optional[torch.Generator] = None,
    ) -> dict[str, torch.Tensor]:
        cfg = self.config
        video_global_embd, _ = self.video_encoder(video_frames, generator)
        clips, _ = self.downsample_video_embd(video_global_embd)
        text_hidden, _ = self.encode_text_global(text_ids, attention_mask, generator)
        video_feat = l2_normalize(self.video_global_proj(clips.mean(dim=1)))
        text_feat = l2_normalize(self.text_global_proj(text_hidden[:, 0]))
        # over the global batch in a data-parallel group (parallel/mesh.py)
        loss = cfg.ct_global_loss_weight * nce_loss(gather_rows(video_feat), gather_rows(text_feat), cfg.temp)
        return {
            "video_global_feat": video_feat,
            "text_global_feat": text_feat,
            "ct_global_loss": loss,
            "loss": loss,
        }

    def forward_video(self, video_frames: torch.Tensor) -> torch.Tensor:
        """The video tower alone: frames -> L2-normalized [B, hidden], the
        same math as the video half of ``forward``."""
        video_global_embd, _ = self.video_encoder(video_frames)
        clips, _ = self.downsample_video_embd(video_global_embd)
        return l2_normalize(self.video_global_proj(clips.mean(dim=1)))

    def forward_text(self, text_ids: torch.Tensor, attention_mask: torch.Tensor) -> torch.Tensor:
        """The text tower alone: [B, M, L] ids + mask -> L2-normalized [B, hidden]."""
        text_hidden, _ = self.encode_text_global(text_ids, attention_mask)
        return l2_normalize(self.text_global_proj(text_hidden[:, 0]))


class LfVilaQAMultichoice(_LfVilaBase):
    """Per-choice fusion and a span classifier (ref ``lfvila_qa_multichoice.py``)."""

    def __init__(self, config: LfVilaConfig, device=None):
        super().__init__(config, device, fusion=True)
        hidden = config.bert.hidden_size
        self.video_token_pos = VideoTokenPos(config.final_num_patches, config.sample_frame, hidden,
                                             config.dtype, device)
        self.classifier = Linear(hidden, 1, dtype=config.dtype, device=device)
        self.span_classifier = Linear(hidden, 2, dtype=config.dtype, device=device)

    def forward(
        self,
        video_frames: torch.Tensor,  # [B, C, N, H, W]
        text_ids: torch.Tensor,  # [B, n_choice, M, L]
        attention_mask: torch.Tensor,
        labels: Optional[torch.Tensor] = None,
        span_labels: Optional[torch.Tensor] = None,  # [B, N]
        span_label_weights: Optional[torch.Tensor] = None,  # [B, N]
        generator: Optional[torch.Generator] = None,
    ) -> dict[str, torch.Tensor]:
        cfg = self.config
        N = video_frames.shape[2]
        video_global_embd, _ = self.video_encoder(video_frames, generator)
        _, video_stage1_embd = self.downsample_video_embd(video_global_embd)
        B, n_choice, M, L = text_ids.shape
        text_hidden, text_mask = self.encode_text_global(
            text_ids.reshape(B * n_choice, M, L), attention_mask.reshape(B * n_choice, M, L), generator)
        video_tokens = self.video_token_pos(video_stage1_embd)
        video_tokens = video_tokens.reshape(B, -1, video_tokens.shape[-1])
        fusion = self.fuse(video_tokens.repeat_interleave(n_choice, dim=0), text_hidden, text_mask, generator)

        # span prediction over the per-frame mean of the final patch tokens,
        # the max over the choices
        P = cfg.final_num_patches
        vid_out = fusion[:, -N * P:].reshape(-1, N, P, fusion.shape[-1]).mean(dim=2)
        span_pred = self.span_classifier(vid_out).reshape(B, n_choice, N, 2).amax(dim=1)  # [B, N, 2]
        rate = cfg.bert.hidden_dropout_prob if self.training else 0.0
        pooled = dropout(self.text_encoder.pool(fusion), rate, generator)
        logits = self.classifier(pooled).reshape(B, n_choice)

        out = {"logits": logits, "span_prediction": span_pred}
        if labels is not None:
            out["loss"] = softmax_xent(logits, labels)
            out["acc"] = accuracy(logits, labels)
        if span_labels is not None:
            flat = span_pred.reshape(-1, 2).float()
            lbl = span_labels.reshape(-1)
            per = torch.logsumexp(flat, dim=-1) - torch.gather(flat, -1, lbl[:, None])[:, 0]
            weights = span_label_weights.reshape(-1) if span_label_weights is not None else 1.0
            out["span_loss"] = torch.mean(per * weights)
            out["span_acc"] = accuracy(flat, lbl)
        return out


class LfVilaQAClassification(_LfVilaBase):
    """Open-ended QA as classification with label smoothing."""

    def __init__(self, config: LfVilaConfig, device=None, num_labels: int = 1000, label_smoothing: float = 0.1):
        super().__init__(config, device, fusion=True)
        hidden = config.bert.hidden_size
        self.label_smoothing = label_smoothing
        self.video_token_pos = VideoTokenPos(config.final_num_patches, config.sample_frame, hidden,
                                             config.dtype, device)
        self.classifier = Linear(hidden, num_labels, dtype=config.dtype, device=device)

    def forward(
        self,
        video_frames: torch.Tensor,
        text_ids: torch.Tensor,  # [B, M, L]
        attention_mask: torch.Tensor,
        labels: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> dict[str, torch.Tensor]:
        video_global_embd, _ = self.video_encoder(video_frames, generator)
        _, video_stage1_embd = self.downsample_video_embd(video_global_embd)
        text_hidden, text_mask = self.encode_text_global(text_ids, attention_mask, generator)
        video_tokens = self.video_token_pos(video_stage1_embd)
        video_tokens = video_tokens.reshape(video_tokens.shape[0], -1, video_tokens.shape[-1])
        fusion = self.fuse(video_tokens, text_hidden, text_mask, generator)
        rate = self.config.bert.hidden_dropout_prob if self.training else 0.0
        logits = self.classifier(dropout(self.text_encoder.pool(fusion), rate, generator))
        out = {"logits": logits}
        if labels is not None:
            out["loss"] = label_smoothing_xent(logits, labels, self.label_smoothing)
            out["acc"] = accuracy(logits, labels)
        return out


class LfVilaVideoClassification(nn.Module):
    """Video-only classification (COIN/LVU, ref ``lfvila_video_classification.py``)."""

    def __init__(self, config: LfVilaConfig, device=None, num_labels: int = 180):
        super().__init__()
        cfg = self.config = config
        hidden = cfg.bert.hidden_size
        self.video_encoder = SwinTransformer3D(cfg.video, device)
        self.video_global_proj = Linear(hidden, hidden, dtype=cfg.dtype, device=device)
        self.video_frame_proj = Linear(hidden, hidden, dtype=cfg.dtype, device=device)
        self.classifier = Linear(hidden, num_labels, dtype=cfg.dtype, device=device)

    def init_weights(self, generator: torch.Generator) -> "LfVilaVideoClassification":
        return init_lfvila_weights(self, generator)

    def forward(self, video_frames: torch.Tensor, labels: Optional[torch.Tensor] = None,
                generator: Optional[torch.Generator] = None) -> dict[str, torch.Tensor]:
        video_global_embd, _ = self.video_encoder(video_frames, generator)
        # the MaxPool(2,3) tokens, one clip: every frame's tokens pooled
        _, x = downsample_video_embd(video_global_embd, 1)
        video_feat = l2_normalize(self.video_global_proj(x.mean(dim=(1, 2))))
        frame_feat = l2_normalize(self.video_frame_proj(x.mean(dim=2)))
        logits = self.classifier(video_feat)
        out = {"video_global_feat": video_feat, "video_frame_feat": frame_feat, "logits": logits}
        if labels is not None:
            out["loss"] = softmax_xent(logits, labels)
            out["acc"] = accuracy(logits, labels)
        return out
