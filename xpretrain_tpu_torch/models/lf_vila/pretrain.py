"""LF-VILA pretraining model (PyTorch): HTWA video encoder + 3-stage BERT +
MTC / VTM / MLM.

Counterpart of ``xpretrain_tpu/models/lf_vila/pretrain.py`` (ref LF-VILA
``src/models/lfvila_pretrain.py:51-285`` and ``text_encoder.py:12-123``):

- Stage 1 (contrastive): Swin3D features are MaxPool(2,3)-downsampled and
  clip-mean-pooled (:func:`downsample_video_embd`); text runs per sentence
  through BERT stage 0, then, with :class:`SentEmbedding` re-applied and a
  mean-CLS token prepended, globally through stage 1
  (:func:`encode_text_stages`). Losses: global InfoNCE + the Multimodal
  Temporal Contrastive loss (``ops.losses.mtc_loss``).
- Stage 2 (fusion): video tokens get :class:`VideoTokenPos`, the first half
  of the batch's video tokens is rolled for VTM negatives, and text + video
  run through BERT stage 2 with the MLM head (positive half only) and the
  VTM head.

Flax creates parameters lazily, so the two stages' trees differ, and
:class:`LfVilaPretrain` builds per stage exactly the modules flax creates: a
stage-1 model has no ``cls``, ``seq_relationship``, pooler,
``video_token_pos`` or stage-2 BERT layers; a stage-2 model has none of the
four local/global projections. ``models/lf_vila/convert.py`` then loads
either tree totally.

``module.training`` stands for flax's ``deterministic=False``; dropout and,
without explicit indices, the MTC clip draws come from the
``torch.Generator`` handed to ``forward``.

In a data-parallel group (``parallel/mesh.py``) the losses are those of the
global batch, as in JAX: the InfoNCE and MTC features are gathered over
ranks, the VTM roll runs over the global batch's first half (each rank gets
the one row that crosses its boundary), and the MLM loss and accuracy divide
by the global count of masked tokens.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
import torch.nn.functional as F
from torch import nn

from xpretrain_tpu_torch.models.bert import BertConfig, BertMLMHead, StagedBertModel
from xpretrain_tpu_torch.models.clip_vip.model import l2_normalize
from xpretrain_tpu_torch.models.common import Embedding, LayerNorm, Linear, dropout
from xpretrain_tpu_torch.models.lf_vila.swin3d import Swin3DConfig, SwinTransformer3D
from xpretrain_tpu_torch.ops.losses import global_ratio, mlm_loss, mtc_loss, nce_loss, softmax_xent
from xpretrain_tpu_torch.parallel.mesh import current_mesh, gather_rows


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
        """Raises on a stream longer than the position table, where flax's
        ``Embed`` would return NaN rows (and a CUDA gather would assert)."""
        if inputs_embeds.shape[1] > self.config.max_position_embeddings:
            raise ValueError(
                f"a paragraph of {inputs_embeds.shape[1]} tokens (sentences x max_txt_len) exceeds the "
                f"{self.config.max_position_embeddings} sentence positions: lower --max_txt_len or the number "
                "of sentences"
            )
        positions = torch.arange(inputs_embeds.shape[1], device=inputs_embeds.device)[None]
        x = inputs_embeds + self.position_embeddings(positions) + self.segment_embeddings(token_type_ids)
        x = self.norm(x)
        return dropout(x, self.config.hidden_dropout_prob if self.training else 0.0, generator)


class VideoTokenPos(nn.Module):
    """Separable spatial + temporal position embeddings for the fusion
    stage's video tokens, then LayerNorm (ref ``lfvila_pretrain.py:18-28``)."""

    def __init__(self, num_patches: int, num_frames: int, hidden_size: int,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.s_pos_embed = nn.Parameter(torch.zeros(1, 1, num_patches, hidden_size, device=device))
        self.t_pos_embed = nn.Parameter(torch.zeros(1, num_frames, 1, hidden_size, device=device))
        self.norm = LayerNorm(hidden_size, 1e-5, dtype, device)

    def forward(self, video_embd: torch.Tensor) -> torch.Tensor:  # [B, N, P, C]
        x = video_embd + self.s_pos_embed.to(video_embd.dtype) + self.t_pos_embed.to(video_embd.dtype)
        return self.norm(x)


def downsample_video_embd(video_embd: torch.Tensor, sample_clip: int) -> tuple[torch.Tensor, torch.Tensor]:
    """[B, N, H, W, C] -> (clip features [B, sample_clip, C], tokens
    [B, N, X, C]): a VALID (2, 3) max-pool with stride 1 over (H, W), then
    the mean over each clip's frames and tokens (ref ``:154-166``)."""
    B, N, H, W, C = video_embd.shape
    x = video_embd.reshape(B * N, H, W, C).permute(0, 3, 1, 2)
    x = F.max_pool2d(x, (2, 3), stride=1).permute(0, 2, 3, 1)
    x = x.reshape(B, N, -1, C)
    clips = x.reshape(B, sample_clip, N // sample_clip, -1, C).mean(dim=(2, 3))
    return clips, x


def encode_text_stages(text_encoder: StagedBertModel, sent_embedding: SentEmbedding, text_ids: torch.Tensor,
                       attention_mask: torch.Tensor, generator: Optional[torch.Generator] = None
                       ) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-sentence BERT stage 0 -> SentEmbedding -> mean-CLS prepend -> stage 1.

    [B, M, L] ids and mask -> (per-sentence hidden [B, M, L, C], global
    hidden [B, 1+M*L, C], global mask [B, 1+M*L])."""
    B, M, L = text_ids.shape
    local = text_encoder(
        text_ids.reshape(B * M, L), attention_mask=attention_mask.reshape(B * M, L),
        stage=0, generator=generator,
    ).reshape(B, M, L, -1)
    # the segment id is the sentence index, repeated over its L tokens (ref :253)
    seg_ids = torch.arange(M, device=text_ids.device).repeat_interleave(L)[None].expand(B, -1)
    stream = sent_embedding(local.reshape(B, M * L, -1), seg_ids, generator)
    # the mean of the sentences' CLS positions AFTER the sentence embeddings
    # (ref lfvila_pretrain.py:203-205 reassigns before taking the mean)
    cls = stream.reshape(B, M, L, -1)[:, :, 0, :].mean(dim=1)
    hidden = torch.cat([cls[:, None], stream], dim=1)
    ones = torch.ones((B, 1), dtype=attention_mask.dtype, device=attention_mask.device)
    mask = torch.cat([ones, attention_mask.reshape(B, M * L)], dim=1)
    hidden = text_encoder(inputs_embeds=hidden, attention_mask=mask, stage=1, generator=generator)
    return local, hidden, mask


def shuffle_embd_for_vtm(video_embd: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Roll the first half of the batch by one to make the VTM negatives
    (label 0); the second half keeps its own video (label 1) (ref ``:168-173``).

    In a group the batch is the global one and ``video_embd`` this rank's
    block of it: a rank's first row takes the previous rank's last row (the
    global first row takes the last row of the first half), so each rank
    exchanges two rows, not its embedding; the exchange carries gradients."""
    mesh = current_mesh()
    if mesh is None:
        B = video_embd.shape[0]
        out = torch.cat([torch.roll(video_embd[: B // 2], 1, dims=0), video_embd[B // 2:]], dim=0)
        labels = torch.cat([torch.zeros(B // 2, dtype=torch.long, device=video_embd.device),
                            torch.ones(B - B // 2, dtype=torch.long, device=video_embd.device)])
        return out, labels
    b, rank = video_embd.shape[0], mesh.rank
    start, half = rank * b, b * mesh.world_size // 2
    wrap = half - 1 - start  # the local index of the first half's last row, if this rank holds it
    held = video_embd[wrap:wrap + 1] if 0 <= wrap < b else torch.zeros_like(video_embd[:1])
    # rank q's last row at 2q, and at 2q + 1 the first half's last row where q holds it
    boundary = gather_rows(torch.cat([video_embd[-1:], held]))
    first = boundary[2 * ((half - 1) // b) + 1] if rank == 0 else boundary[2 * (rank - 1)]
    shifted = torch.cat([first[None], video_embd[:-1]])
    positive = torch.arange(start, start + b, device=video_embd.device) >= half
    out = torch.where(positive.reshape(-1, *([1] * (video_embd.dim() - 1))), video_embd, shifted)
    return out, positive.long()


@torch.no_grad()
def init_lfvila_weights(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random init from ``generator`` (on the parameters' device), with the
    JAX package's scales: dense and conv kernels N(0, 1/fan_in), zero biases,
    embeddings N(0, 1/features), unit layer norms, relative position bias
    tables and ``VideoTokenPos`` embeddings N(0, 0.02)."""
    for module in model.modules():
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
    for name, p in model.named_parameters():
        if name.endswith(("relative_position_bias_table", "s_pos_embed", "t_pos_embed")):
            p.normal_(0.0, 0.02, generator=generator)
    return model


def _first_positive_row(b: int) -> int:
    """The first local row of ``b`` in the global batch's second (VTM
    positive) half: ``b // 2`` without a group."""
    mesh = current_mesh()
    if mesh is None:
        return b // 2
    start, half = mesh.rank * b, b * mesh.world_size // 2
    return min(b, max(0, half - start))


def accuracy(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """The share of rows whose argmax is the label (fp32 scalar)."""
    return (logits.argmax(dim=-1) == labels).float().mean()


class LfVilaPretrain(nn.Module):
    """The two-stage LF-VILA pretraining model, built for ``config.stage``."""

    def __init__(self, config: LfVilaConfig, device=None):
        super().__init__()
        cfg = self.config = config
        if cfg.stage not in (1, 2):
            raise ValueError(f"LF-VILA pretraining has stages 1 and 2, got {cfg.stage}")
        hidden = cfg.bert.hidden_size
        stage1 = cfg.stage == 1
        self.video_encoder = SwinTransformer3D(cfg.video, device)
        # stage 1 never reaches BERT stage 2 or the pooler, so flax has neither
        self.text_encoder = StagedBertModel(cfg.bert, cfg.dtype, device, with_pooler=not stage1,
                                            num_layers=cfg.bert.stage_range(1)[1] if stage1 else None)
        self.sent_embedding = SentEmbedding(cfg.bert, cfg.dtype, device)
        if stage1:
            for name in ("video_local_proj", "text_local_proj", "video_global_proj", "text_global_proj"):
                setattr(self, name, Linear(hidden, hidden, dtype=cfg.dtype, device=device))
        else:
            if cfg.video.num_features != hidden:
                raise ValueError(f"fusion concatenates video tokens of width {cfg.video.num_features} into a "
                                 f"text stream of width {hidden}: they must be equal")
            self.cls = BertMLMHead(cfg.bert, cfg.dtype, device)
            self.seq_relationship = Linear(hidden, 2, dtype=cfg.dtype, device=device)
            self.video_token_pos = VideoTokenPos(cfg.final_num_patches, cfg.sample_frame, hidden, cfg.dtype, device)

    def init_weights(self, generator: torch.Generator) -> "LfVilaPretrain":
        return init_lfvila_weights(self, generator)

    def forward(
        self,
        video_frames: torch.Tensor,  # fp32 [B, C, N, H, W] or uint8 [B, N, H, W, 3]
        text_ids: torch.Tensor,  # [B, M, L]
        attention_mask: torch.Tensor,  # [B, M, L]
        mlm_labels: Optional[torch.Tensor] = None,  # [B, M*L], -100 where not masked
        generator: Optional[torch.Generator] = None,
        mtc_indices: Optional[tuple] = None,  # (key [B, nk], value [B, nv], other [B]) clip indices
    ) -> dict[str, torch.Tensor]:
        """The stage's losses and features. Stage 1 computes ``ct_time_loss``
        when ``use_time_match`` is set and ``generator`` or ``mtc_indices``
        is given (JAX: when an ``mtc_rng`` is), else reports 0."""
        cfg = self.config
        video_global_embd, video_local_embd = self.video_encoder(video_frames, generator)
        local, text_hidden, global_mask = encode_text_stages(
            self.text_encoder, self.sent_embedding, text_ids, attention_mask, generator)
        B, M, L = text_ids.shape
        out: dict[str, torch.Tensor] = {}
        if cfg.stage == 1:
            video_local_feat1, _ = downsample_video_embd(video_local_embd, cfg.sample_clip)
            video_local_feat2, _ = downsample_video_embd(video_global_embd, cfg.sample_clip)
            out["video_local_feat"] = l2_normalize(self.video_local_proj(video_local_feat1))
            out["text_local_feat"] = l2_normalize(self.text_local_proj(local[:, :, 0, :]))
            video_global_feat = l2_normalize(self.video_global_proj(video_local_feat2.mean(dim=1)))
            text_global_feat = l2_normalize(self.text_global_proj(text_hidden[:, 0]))
            out["video_global_feat"] = video_global_feat
            out["text_global_feat"] = text_global_feat
            out["ct_global_loss"] = cfg.ct_global_loss_weight * nce_loss(
                gather_rows(video_global_feat), gather_rows(text_global_feat), cfg.temp)
            if cfg.use_time_match and (generator is not None or mtc_indices is not None):
                out["ct_time_loss"] = cfg.ct_time_loss_weight * mtc_loss(
                    out["video_local_feat"], out["text_local_feat"], generator, cfg.num_key, cfg.num_value,
                    cfg.num_other_neg, cfg.time_temp, indices=mtc_indices,
                )
            else:
                out["ct_time_loss"] = torch.zeros((), device=video_global_feat.device)
            out["loss"] = out["ct_global_loss"] + out["ct_time_loss"]
            return out

        # ---- stage 2: fusion ----
        _, video_stage1_embd = downsample_video_embd(video_global_embd, cfg.sample_clip)
        video_tokens = self.video_token_pos(video_stage1_embd)  # [B, N, P, C]
        video_tokens, vtm_labels = shuffle_embd_for_vtm(video_tokens.reshape(B, -1, video_tokens.shape[-1]))
        ones = torch.ones(video_tokens.shape[:2], dtype=global_mask.dtype, device=global_mask.device)
        fusion = self.text_encoder(
            inputs_embeds=torch.cat([text_hidden, video_tokens], dim=1),
            attention_mask=torch.cat([global_mask, ones], dim=1), stage=2, generator=generator,
        )
        mlm_logits = self.cls(fusion[:, : 1 + M * L])
        vtm_logits = self.seq_relationship(self.text_encoder.pool(fusion))
        out["vtm_logits"] = vtm_logits
        out["mlm_logits"] = mlm_logits
        if mlm_labels is not None:
            # the CLS position is never masked; MLM on the positive (un-rolled)
            # half of the VTM batch only (ref text_encoder.py:88-92), and its
            # accuracy on that half too: this rank's rows of the global half
            keep = _first_positive_row(B)
            full = torch.cat([torch.full((B, 1), -100, dtype=mlm_labels.dtype, device=mlm_labels.device),
                              mlm_labels], dim=1)[keep:]
            logits = mlm_logits[keep:]
            out["mlm_loss"] = cfg.mlm_loss_weight * mlm_loss(logits, full)
            selected = full != -100
            correct = (logits.argmax(dim=-1) == full) & selected
            out["mlm_acc"] = global_ratio(correct.sum(), selected.sum())
        else:
            out["mlm_loss"] = torch.zeros((), device=vtm_logits.device)
            out["mlm_acc"] = torch.zeros((), device=vtm_logits.device)
        out["vtm_loss"] = cfg.vtm_loss_weight * softmax_xent(vtm_logits, vtm_labels)
        out["vtm_acc"] = accuracy(vtm_logits, vtm_labels)
        out["loss"] = out["mlm_loss"] + out["vtm_loss"]
        return out
