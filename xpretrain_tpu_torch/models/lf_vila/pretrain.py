"""LF-VILA's configuration and sentence embedding (PyTorch).

Counterpart of the parts of ``xpretrain_tpu/models/lf_vila/pretrain.py``
that the retrieval dual encoder uses: :class:`LfVilaConfig` and
:class:`SentEmbedding` (ref ``lfvila_pretrain.py:30-48``). ``VideoTokenPos``
and the two-stage ``LfVilaPretrain`` (MTC, VTM, MLM) come with the training
slice (ROADMAP Queue 1).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from xpretrain_tpu_torch.models.bert import BertConfig
from xpretrain_tpu_torch.models.common import Embedding, LayerNorm, dropout
from xpretrain_tpu_torch.models.lf_vila.swin3d import Swin3DConfig


@dataclasses.dataclass(frozen=True)
class LfVilaConfig:
    video: Swin3DConfig = dataclasses.field(default_factory=Swin3DConfig)
    bert: BertConfig = dataclasses.field(
        default_factory=lambda: BertConfig.bert_large(stage_bounds=(8, 12), type_vocab_size=8)
    )
    stage: int = 1
    sample_clip: int = 4  # sentences/clips per long-form sample
    sample_frame: int = 32
    final_num_patches: int = 6
    temp: float = 0.05
    time_temp: float = 0.05
    num_key: int = 2
    num_value: int = 2
    num_other_neg: int = 3
    use_time_match: bool = True
    ct_global_loss_weight: float = 1.0
    ct_time_loss_weight: float = 1.0
    mlm_loss_weight: float = 1.0
    vtm_loss_weight: float = 10.0
    dtype: torch.dtype = torch.float32

    @staticmethod
    def tiny(**overrides) -> "LfVilaConfig":
        # bert.hidden_size equals the Swin num_features (32 * 2^3 = 256), as
        # in the real config (128 * 2^3 = 1024 = BERT-large's hidden size)
        base = dict(
            video=Swin3DConfig.tiny(),
            bert=BertConfig(
                hidden_size=256,
                num_hidden_layers=6,
                num_attention_heads=4,
                intermediate_size=256,
                stage_bounds=(2, 4),
                type_vocab_size=8,
                vocab_size=1000,
            ),
        )
        base.update(overrides)
        return LfVilaConfig(**base)


class SentEmbedding(nn.Module):
    """Sentence-level position + segment embeddings re-applied over the
    concatenated sentence stream, then LayerNorm (eps of BERT) and dropout."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.config = config
        self.position_embeddings = Embedding(config.max_position_embeddings, config.hidden_size, dtype, device)
        self.segment_embeddings = Embedding(config.type_vocab_size, config.hidden_size, dtype, device)
        self.norm = LayerNorm(config.hidden_size, config.layer_norm_eps, dtype, device)

    def forward(self, inputs_embeds: torch.Tensor, token_type_ids: torch.Tensor,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        positions = torch.arange(inputs_embeds.shape[1], device=inputs_embeds.device)[None]
        x = inputs_embeds + self.position_embeddings(positions) + self.segment_embeddings(token_type_ids)
        x = self.norm(x)
        return dropout(x, self.config.hidden_dropout_prob if self.training else 0.0, generator)
