"""Staged BERT encoder (PyTorch): the text/fusion backbone of LF-VILA.

Counterpart of ``xpretrain_tpu/models/bert.py``. Post-LN blocks with the HF
parameter layout; the layers run in configurable [start, end) stages
(``BertConfig.stage_bounds``): LF-VILA's stage 0 is the per-sentence local
layers, stage 1 the cross-sentence global layers, stage 2 the cross-modal
fusion. ``attention_window > 0`` is the block-local banded attention that
stands for LF-VILA's DeepSpeed block-sparse attention.

As in the flax module, parameters are fp32 and each layer computes in
``dtype``; layer norms (eps 1e-12) and attention scores and softmax run in
fp32, and ``gelu`` is flax's tanh form. Submodules carry the flax names, so
``models/lf_vila/convert.py`` maps parameters by path. BERT attention is
XLA in JAX, not Pallas, so it is ``models.common.dot_attention`` here.

``num_layers`` builds only the first layers: flax creates parameters lazily,
so a model whose forward never reaches a stage (LF-VILA retrieval and stage
2) has none for it, and neither does the port. Dropout applies in training
mode only (``module.training``), drawn from the ``torch.Generator`` handed
to ``forward``.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional

import numpy as np
import torch
from torch import nn

from xpretrain_tpu_torch.models.common import (
    ACT2FN,
    NEG_INF,
    Embedding,
    LayerNorm,
    Linear,
    device_constant,
    dot_attention,
    dropout,
    expand_padding_mask,
)


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 768
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    intermediate_size: int = 3072
    hidden_act: str = "gelu"
    hidden_dropout_prob: float = 0.1
    attention_probs_dropout_prob: float = 0.1
    max_position_embeddings: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12
    # stage split points, e.g. (6,) -> stages [0,6) and [6,12);
    # (8, 12) -> [0,8), [8,12), [12, num_layers)
    stage_bounds: tuple = ()
    attention_window: int = 0  # 0 = dense; >0 = block-local attention

    @staticmethod
    def bert_base(**overrides) -> "BertConfig":
        return BertConfig(**overrides)

    @staticmethod
    def bert_large(**overrides) -> "BertConfig":
        return BertConfig(
            hidden_size=1024,
            num_hidden_layers=24,
            num_attention_heads=16,
            intermediate_size=4096,
            **overrides,
        )

    def stage_range(self, stage: int) -> tuple[int, int]:
        bounds = (0,) + tuple(self.stage_bounds) + (self.num_hidden_layers,)
        return bounds[stage], bounds[stage + 1]


class BertEmbeddings(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.config = config
        self.word_embeddings = Embedding(config.vocab_size, config.hidden_size, dtype, device)
        self.position_embeddings = Embedding(config.max_position_embeddings, config.hidden_size, dtype, device)
        self.token_type_embeddings = Embedding(config.type_vocab_size, config.hidden_size, dtype, device)
        self.LayerNorm = LayerNorm(config.hidden_size, config.layer_norm_eps, dtype, device)

    def forward(
        self,
        input_ids: torch.Tensor,
        token_type_ids: Optional[torch.Tensor] = None,
        position_ids: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if position_ids is None:
            position_ids = torch.arange(input_ids.shape[1], device=input_ids.device)[None]
        if token_type_ids is None:
            token_type_ids = torch.zeros_like(input_ids)
        x = (self.word_embeddings(input_ids) + self.position_embeddings(position_ids)
             + self.token_type_embeddings(token_type_ids))
        x = self.LayerNorm(x)
        return dropout(x, self.config.hidden_dropout_prob if self.training else 0.0, generator)


@functools.lru_cache(maxsize=16)
def _block_local_mask_np(seq_len: int, window: int) -> np.ndarray:
    idx = np.arange(seq_len) // window
    ok = np.abs(idx[:, None] - idx[None, :]) <= 1
    # global attention for block 0 (the CLS block), both directions
    ok[idx == 0] = True
    ok[:, idx == 0] = True
    return np.where(ok, 0.0, NEG_INF).astype(np.float32)[None, None]


def _block_local_mask(seq_len: int, window: int, device=None) -> torch.Tensor:
    """Additive [1, 1, S, S] fp32 mask restricting attention to same/adjacent
    blocks of size ``window``, with block 0 (the CLS block) global."""
    return device_constant(_block_local_mask_np, (seq_len, window), device)


class BertSelfAttention(nn.Module):
    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.query = Linear(h, h, dtype=dtype, device=device)
        self.key = Linear(h, h, dtype=dtype, device=device)
        self.value = Linear(h, h, dtype=dtype, device=device)

    def forward(self, hidden: torch.Tensor, mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        cfg = self.config
        b, s, _ = hidden.shape
        heads = cfg.num_attention_heads
        d = cfg.hidden_size // heads

        def split(x):  # this rank's heads under tensor parallelism
            return x.view(b, s, -1, d).transpose(1, 2)

        q, k, v = split(self.query(hidden)), split(self.key(hidden)), split(self.value(hidden))
        if cfg.attention_window > 0:
            local = _block_local_mask(s, cfg.attention_window, hidden.device)
            mask = local if mask is None else local + mask
        rate = cfg.attention_probs_dropout_prob if self.training else 0.0
        out = dot_attention(q, k, v, d**-0.5, mask, rate, generator)
        return out.transpose(1, 2).reshape(b, s, -1)


class BertLayer(nn.Module):
    """Post-LN BERT block with the HF parameter layout."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.config = config
        h, eps = config.hidden_size, config.layer_norm_eps
        self.attention_self = BertSelfAttention(config, dtype, device)
        self.attention_output_dense = Linear(h, h, dtype=dtype, device=device)
        self.attention_output_LayerNorm = LayerNorm(h, eps, dtype, device)
        self.intermediate_dense = Linear(h, config.intermediate_size, dtype=dtype, device=device)
        self.output_dense = Linear(config.intermediate_size, h, dtype=dtype, device=device)
        self.output_LayerNorm = LayerNorm(h, eps, dtype, device)
        self.act = ACT2FN[config.hidden_act]

    def forward(self, hidden: torch.Tensor, mask: Optional[torch.Tensor],
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        rate = self.config.hidden_dropout_prob if self.training else 0.0
        attn = self.attention_output_dense(self.attention_self(hidden, mask, generator))
        hidden = self.attention_output_LayerNorm(hidden + dropout(attn, rate, generator))
        out = self.output_dense(self.act(self.intermediate_dense(hidden)))
        return self.output_LayerNorm(hidden + dropout(out, rate, generator))


class StagedBertEncoder(nn.Module):
    """BERT encoder whose layers run in configurable [start, end) ranges;
    layer i is the submodule ``layer_{i}``, as in flax."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32, device=None,
                 num_layers: Optional[int] = None):
        super().__init__()
        self.config = config
        self.num_built = config.num_hidden_layers if num_layers is None else int(num_layers)
        for i in range(self.num_built):
            self.add_module(f"layer_{i}", BertLayer(config, dtype, device))

    def forward(
        self,
        hidden: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        stage: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        start, end = (0, self.config.num_hidden_layers) if stage is None else self.config.stage_range(stage)
        if end > self.num_built:
            raise ValueError(f"layers [{start}, {end}) asked for, but only the first {self.num_built} are built")
        for i in range(start, end):
            hidden = getattr(self, f"layer_{i}")(hidden, mask, generator)
        return hidden


class BertPooler(nn.Module):
    def __init__(self, hidden_size: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dense = Linear(hidden_size, hidden_size, dtype=dtype, device=device)

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return torch.tanh(self.dense(hidden[:, 0]))


class BertMLMHead(nn.Module):
    """Transform + decoder to the vocabulary, untied from the word embeddings
    (the reference clones rather than ties its heads,
    ``hd-vila/src/modeling/modeling_stage.py:345-360``)."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        h = config.hidden_size
        self.transform_dense = Linear(h, h, dtype=dtype, device=device)
        self.transform_LayerNorm = LayerNorm(h, config.layer_norm_eps, dtype, device)
        self.decoder = Linear(h, config.vocab_size, dtype=dtype, device=device)
        self.act = ACT2FN[config.hidden_act]

    def forward(self, hidden: torch.Tensor) -> torch.Tensor:
        return self.decoder(self.transform_LayerNorm(self.act(self.transform_dense(hidden))))


class StagedBertModel(nn.Module):
    """Embeddings + staged encoder; ``stage=None`` runs all layers.

    ``inputs_embeds`` bypasses the embedding table for stages that consume
    already-embedded sequences (LF-VILA stages 1 and 2)."""

    def __init__(self, config: BertConfig, dtype: torch.dtype = torch.float32, device=None,
                 with_pooler: bool = False, num_layers: Optional[int] = None):
        super().__init__()
        self.config = config
        self.embeddings = BertEmbeddings(config, dtype, device)
        self.encoder = StagedBertEncoder(config, dtype, device, num_layers)
        self.pooler = BertPooler(config.hidden_size, dtype, device) if with_pooler else None

    def forward(
        self,
        input_ids: Optional[torch.Tensor] = None,
        attention_mask: Optional[torch.Tensor] = None,
        token_type_ids: Optional[torch.Tensor] = None,
        inputs_embeds: Optional[torch.Tensor] = None,
        stage: Optional[int] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        if inputs_embeds is None:
            hidden = self.embeddings(input_ids, token_type_ids, generator=generator)
        else:
            hidden = inputs_embeds
        mask = None if attention_mask is None else expand_padding_mask(attention_mask)
        return self.encoder(hidden, mask, stage, generator)

    def pool(self, hidden: torch.Tensor) -> torch.Tensor:
        if self.pooler is None:
            raise ValueError("this StagedBertModel was built without its pooler (with_pooler=False)")
        return self.pooler(hidden)
