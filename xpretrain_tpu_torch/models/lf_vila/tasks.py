"""LF-VILA paragraph-to-video retrieval (PyTorch).

Counterpart of ``_LfVilaBase`` and ``LfVilaRetrieval`` in
``xpretrain_tpu/models/lf_vila/tasks.py`` (ref LF-VILA
``src/models/lfvila_retrieval.py:19-109``): the Swin3D/HTWA video tower,
MaxPool(2,3)-downsampled and clip-mean-pooled, against the hierarchical
text tower (BERT stage 0 per sentence, sentence embeddings, a mean-CLS token,
BERT stage 1 over the paragraph), both projected and L2-normalized, with the
fixed-temperature InfoNCE loss.

Flax creates parameters lazily, so a JAX ``LfVilaRetrieval`` has none for
the BERT pooler and the stage-2 (fusion) layers, which retrieval never runs;
the port builds the text encoder up to the end of stage 1 and no pooler, so
its parameters are exactly the flax tree's. The QA and video-classification
heads need stage-2 fusion and ``VideoTokenPos`` and come later (ROADMAP).

``module.training`` stands for flax's ``deterministic=False``; dropout draws
from the ``torch.Generator`` handed to ``forward``.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from xpretrain_tpu_torch.models.bert import StagedBertModel
from xpretrain_tpu_torch.models.clip_vip.model import l2_normalize
from xpretrain_tpu_torch.models.common import Linear
from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaConfig, SentEmbedding
from xpretrain_tpu_torch.models.lf_vila.swin3d import SwinTransformer3D
from xpretrain_tpu_torch.ops.losses import nce_loss


class _LfVilaBase(nn.Module):
    """The shared encoders and the MaxPool(2,3) video downsample."""

    def __init__(self, config: LfVilaConfig, device=None):
        super().__init__()
        cfg = self.config = config
        self.video_encoder = SwinTransformer3D(cfg.video, device)
        self.text_encoder = StagedBertModel(cfg.bert, cfg.dtype, device, with_pooler=False,
                                            num_layers=cfg.bert.stage_range(1)[1])
        self.sent_embedding = SentEmbedding(cfg.bert, cfg.dtype, device)

    def downsample_video_embd(self, video_embd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        """[B, N, H, W, C] -> (clip features [B, sample_clip, C], tokens
        [B, N, X, C]): a VALID (2, 3) max-pool with stride 1 over (H, W),
        then the mean over each clip's frames and tokens."""
        B, N, H, W, C = video_embd.shape
        x = video_embd.reshape(B * N, H, W, C).permute(0, 3, 1, 2)
        x = F.max_pool2d(x, (2, 3), stride=1).permute(0, 2, 3, 1)
        x = x.reshape(B, N, -1, C)
        s = self.config.sample_clip
        clips = x.reshape(B, s, N // s, -1, C).mean(dim=(2, 3))
        return clips, x

    def encode_text_global(self, text_ids: torch.Tensor, attention_mask: torch.Tensor,
                           generator: Optional[torch.Generator] = None
                           ) -> tuple[torch.Tensor, torch.Tensor]:
        """Per-sentence stage 0 -> SentEmbedding -> mean-CLS prepend -> stage 1.

        [B, M, L] ids and mask -> (hidden [B, 1+M*L, C], mask [B, 1+M*L])."""
        B, M, L = text_ids.shape
        local = self.text_encoder(
            text_ids.reshape(B * M, L), attention_mask=attention_mask.reshape(B * M, L),
            stage=0, generator=generator,
        ).reshape(B, M, L, -1)
        # the segment id is the sentence index, repeated over its L tokens
        seg_ids = torch.arange(M, device=text_ids.device).repeat_interleave(L)[None].expand(B, -1)
        stream = self.sent_embedding(local.reshape(B, M * L, -1), seg_ids, generator)
        # the mean of the sentences' CLS positions AFTER the sentence embeddings
        cls = stream.reshape(B, M, L, -1)[:, :, 0, :].mean(dim=1)
        hidden = torch.cat([cls[:, None], stream], dim=1)
        ones = torch.ones((B, 1), dtype=attention_mask.dtype, device=attention_mask.device)
        mask = torch.cat([ones, attention_mask.reshape(B, M * L)], dim=1)
        hidden = self.text_encoder(inputs_embeds=hidden, attention_mask=mask, stage=1, generator=generator)
        return hidden, mask

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "_LfVilaBase":
        """Random init from ``generator`` (on the parameters' device), with
        the JAX package's scales: dense and conv kernels N(0, 1/fan_in), zero
        biases, embeddings N(0, 1/features), unit layer norms, relative
        position bias tables N(0, 0.02)."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                module.weight.normal_(0.0, module.in_features**-0.5, generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.Conv3d):
                module.weight.normal_(0.0, module.weight[0].numel() ** -0.5, generator=generator)
                module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                module.weight.normal_(0.0, module.embedding_dim**-0.5, generator=generator)
        for name, p in self.named_parameters():
            if name.endswith("relative_position_bias_table"):
                p.normal_(0.0, 0.02, generator=generator)
        return self


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
        loss = cfg.ct_global_loss_weight * nce_loss(video_feat, text_feat, cfg.temp)
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
