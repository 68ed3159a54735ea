"""CLIP-ViP in PyTorch: proxy-token video attention over a CLIP dual encoder.

Counterpart of ``xpretrain_tpu/models/clip_vip/model.py``:

- Video patchify with temporal embeddings and M = 1 + ``add_cls_num`` video
  proxy tokens (ref ``CLIP-ViP/src/modeling/CLIP_ViP.py:142-197``).
- Proxy attention through :func:`xpretrain_tpu_torch.ops.proxy_attention.
  proxy_attention`: the hand-written CUDA kernel on the card, its plain
  version on the CPU (``attention_mode="masked_full"``); or, with
  ``"factorized"``, the reference's two attentions written out with
  ``common.dot_attention`` (:func:`factorized_proxy_attention`), as JAX
  computes them outside Pallas.
- CLIP text tower with causal masking and EOT-argmax pooling.
- Bias-free projections, L2 normalization, learnable ``logit_scale``.
- ``vision_type="mean"`` is the frame-mean baseline (ref ``VidCLIP.py:55-65``).
- Training: ``module.training`` stands for flax's ``deterministic=False``.
  Attention dropout draws from the ``torch.Generator`` handed to ``forward``;
  ``CLIPVipConfig.remat`` recomputes each encoder layer in the backward
  (``torch.utils.checkpoint``, as ``nn.remat`` in the JAX ``Encoder``).

Parameters are fp32 and named with the HF-CLIP keys (``pre_layrnorm`` is
HF's spelling), so ``state_dict()`` keys are those of ``convert.py``'s table;
``CLIPVipConfig.dtype`` is the compute dtype. The patch weight keeps the
flax layout [P, P, 3, D], which the patchify GEMM reads as [P*P*3, D].
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch
from torch import nn

from xpretrain_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD
from xpretrain_tpu_torch.models import common
from xpretrain_tpu_torch.models.common import (
    LayerNorm,
    Linear,
    MultiHeadAttention,
    TransformerMLP,
    dot_attention,
    expand_padding_mask,
    make_causal_mask,
    recomputed,
)
from xpretrain_tpu_torch.ops.patchify import extract_patches_u8, patch_embed_u8
from xpretrain_tpu_torch.ops.proxy_attention import proxy_attention, proxy_bias

# ---------------------------------------------------------------------------
# Configs
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class CLIPTextConfig:
    vocab_size: int = 49408
    hidden_size: int = 512
    intermediate_size: int = 2048
    num_hidden_layers: int = 12
    num_attention_heads: int = 8
    max_position_embeddings: int = 77
    hidden_act: str = "quick_gelu"
    attention_dropout: float = 0.0


@dataclasses.dataclass(frozen=True)
class CLIPVisionConfig:
    hidden_size: int = 768
    intermediate_size: int = 3072
    num_hidden_layers: int = 12
    num_attention_heads: int = 12
    image_size: int = 224
    patch_size: int = 32
    hidden_act: str = "quick_gelu"
    attention_dropout: float = 0.0


@dataclasses.dataclass(frozen=True)
class VipConfig:
    """``vision_additional_config`` of the reference
    (``pretrain_vip_base_32.json:50-56``)."""

    type: str = "ViP"  # "ViP" -> proxy attention; "mean" -> frame-mean baseline
    temporal_size: int = 12
    if_use_temporal_embed: bool = True
    add_cls_num: int = 3
    logit_scale_init_value: float = 4.60
    # "masked_full": one attention over the M+N*L sequence, proxy mask
    # implicit in the kernel. "factorized": the reference's two-attention
    # decomposition (in-frame over [proxies | own frame], then the proxies
    # over everything), the same function through common.dot_attention
    attention_mode: str = "masked_full"


@dataclasses.dataclass(frozen=True)
class CLIPVipConfig:
    text: CLIPTextConfig = dataclasses.field(default_factory=CLIPTextConfig)
    vision: CLIPVisionConfig = dataclasses.field(default_factory=CLIPVisionConfig)
    vip: VipConfig = dataclasses.field(default_factory=VipConfig)
    projection_dim: int = 512
    logit_scale_init_value: float = 2.6592  # HF CLIP default; ViP overrides at load
    dtype: torch.dtype = torch.float32  # compute dtype; parameters stay fp32
    remat: bool = False  # recompute each encoder layer in the backward

    @staticmethod
    def base_patch32(**overrides) -> "CLIPVipConfig":
        return CLIPVipConfig(**overrides)

    @staticmethod
    def base_patch16(**overrides) -> "CLIPVipConfig":
        vision = CLIPVisionConfig(patch_size=16)
        return CLIPVipConfig(vision=vision, **overrides)

    @staticmethod
    def tiny_debug(image_size: int = 32, **overrides) -> "CLIPVipConfig":
        """Small config for smoke tests / debug runs (``--clip_size tiny``)."""
        text = CLIPTextConfig(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, max_position_embeddings=77,
        )
        vision = CLIPVisionConfig(
            hidden_size=64, intermediate_size=128, num_hidden_layers=2,
            num_attention_heads=4, image_size=image_size, patch_size=16,
        )
        return CLIPVipConfig(text=text, vision=vision, projection_dim=32, **overrides)

    @staticmethod
    def large_patch14(**overrides) -> "CLIPVipConfig":
        text = CLIPTextConfig(hidden_size=768, intermediate_size=3072, num_attention_heads=12)
        vision = CLIPVisionConfig(
            hidden_size=1024,
            intermediate_size=4096,
            num_hidden_layers=24,
            num_attention_heads=16,
            patch_size=14,
        )
        return CLIPVipConfig(text=text, vision=vision, projection_dim=768, **overrides)


# ---------------------------------------------------------------------------
# Proxy attention
# ---------------------------------------------------------------------------


def factorized_proxy_attention(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, M: int, N: int, L: int, scale: float,
    dropout_rate: float = 0.0, generator: Optional[torch.Generator] = None,
) -> torch.Tensor:
    """Proxy attention over [B, H, M+N*L, D] as the reference's two attentions
    (JAX ``ProxyAttention._factorized``): each frame's patches attend the M
    proxies and their own frame, with one softmax over the joint M+L keys;
    the proxies attend all M+N*L tokens. Equal to the masked full attention
    (dropout apart); linear in N. Dropout, when given a rate, draws from
    ``generator`` in both attentions."""
    B, H, _, D = q.shape
    frames = lambda t: t[:, :, M:].reshape(B, H, N, L, D)  # noqa: E731
    proxies = lambda t: t[:, :, None, :M].expand(B, H, N, M, D)  # noqa: E731
    k_cat = torch.cat([proxies(k), frames(k)], dim=3)  # [B, H, N, M+L, D]
    v_cat = torch.cat([proxies(v), frames(v)], dim=3)
    in_frame = common.dot_attention(frames(q), k_cat, v_cat, scale, None, dropout_rate, generator)
    cls = common.dot_attention(q[:, :, :M], k, v, scale, None, dropout_rate, generator)  # [B, H, M, D]
    return torch.cat([cls, in_frame.reshape(B, H, N * L, D)], dim=2)


class ProxyAttention(nn.Module):
    """The ViP proxy video attention (ref ``CLIP_ViP.py:332-381``).

    Sequence layout [M proxy tokens | N frames x L patches]: patch tokens
    attend [proxies | own frame], proxies attend everything. In
    ``masked_full`` mode the kernel path runs unless attention dropout is on
    in training; then, on every device, the layer takes JAX's other branch
    (``model.py:216``): ``dot_attention`` over the proxy mask with dropout
    (the kernels apply none; ROADMAP Queue 2 keeps dropout inside them as a
    speed item). ``factorized`` mode computes
    :func:`factorized_proxy_attention` on every device, with dropout in
    training, as JAX does (no kernel)."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 mode: str = "masked_full", device=None, dropout_rate: float = 0.0):
        super().__init__()
        if mode not in ("masked_full", "factorized"):
            raise ValueError(f"proxy attention mode {mode!r}: use 'masked_full' or 'factorized'")
        self.mode = mode
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.q_proj = Linear(embed_dim, embed_dim, dtype=dtype, device=device)
        self.k_proj = Linear(embed_dim, embed_dim, dtype=dtype, device=device)
        self.v_proj = Linear(embed_dim, embed_dim, dtype=dtype, device=device)
        self.out_proj = Linear(embed_dim, embed_dim, dtype=dtype, device=device)

    def forward(
        self,
        hidden_states: torch.Tensor,
        inputs_size: tuple[int, int, int],
        generator: Optional[torch.Generator] = None,
        keep: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        M, N, L = inputs_size
        B, S, _ = hidden_states.shape
        D = self.embed_dim // self.num_heads
        # the kernel takes contiguous [B, H, S, D]; H is this rank's heads
        # under tensor parallelism (the projections' width over D)
        split = lambda x: x.view(B, S, -1, D).transpose(1, 2).contiguous()
        q = split(self.q_proj(hidden_states))
        k = split(self.k_proj(hidden_states))
        v = split(self.v_proj(hidden_states))
        rate = self.dropout_rate if self.training else 0.0
        if self.mode == "factorized":
            if keep is not None:
                raise ValueError("explicit keep masks are taken by the masked_full mode only")
            out = factorized_proxy_attention(q, k, v, M, N, L, D**-0.5, rate, generator)
        elif rate > 0.0:
            out = dot_attention(q, k, v, D**-0.5, proxy_bias(S, M, L, q.device),
                                self.dropout_rate, generator, keep)
        else:
            out = proxy_attention(q, k, v, M, N, L, D**-0.5)
        return self.out_proj(out.transpose(1, 2).reshape(B, S, -1))


# ---------------------------------------------------------------------------
# Embeddings
# ---------------------------------------------------------------------------


class PatchEmbedding(nn.Module):
    """Patchify-as-matmul over a [P, P, 3, D] weight, two input paths:

    - raw uint8 NHWC frames, /255 + mean/std folded into the weights (the
      device-ingest path);
    - fp32 NCHW frames, already normalized on the host.
    """

    def __init__(self, patch_size: int, embed_dim: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__()
        self.patch_size = patch_size
        self.compute_dtype = dtype
        self.weight = nn.Parameter(torch.empty(patch_size, patch_size, 3, embed_dim, device=device))

    def forward(self, frames: torch.Tensor, mean=None, std=None) -> torch.Tensor:
        P = self.patch_size
        dt = self.compute_dtype
        if frames.dtype == torch.uint8:
            return patch_embed_u8(frames, self.weight, mean, std, dt)
        x = frames.permute(0, 2, 3, 1)  # NCHW -> NHWC
        patches = extract_patches_u8(x, P)  # the same reshape, any dtype
        w = self.weight.reshape(P * P * 3, -1)
        return torch.matmul(patches.to(dt), w.to(dt))


class VipVisionEmbeddings(nn.Module):
    """Video patchify + temporal/spatial embeds + proxy tokens
    (ref ``CLIP_ViP.py:142-197``). Takes fp32 [B,T,C,H,W] (pre-normalized)
    or raw uint8 [B,T,H,W,3]."""

    def __init__(self, config: CLIPVisionConfig, vip: VipConfig,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.config = config
        self.vip = vip
        self.compute_dtype = dtype
        D = config.hidden_size
        self.n_patches = (config.image_size // config.patch_size) ** 2
        self.class_embedding = nn.Parameter(torch.empty(D, device=device))
        if vip.add_cls_num > 0:
            self.added_cls = nn.Parameter(torch.empty(vip.add_cls_num, D, device=device))
        else:
            self.added_cls = None
        self.patch_embedding = PatchEmbedding(config.patch_size, D, dtype, device=device)
        self.position_embedding = nn.Embedding(self.n_patches + 1, D, device=device)
        if vip.if_use_temporal_embed:
            self.temporal_embedding = nn.Parameter(
                torch.zeros(1, vip.temporal_size, D, device=device)
            )
        else:
            self.temporal_embedding = None

    def _time_embed(self, T: int) -> torch.Tensor:
        """[1, T, D] temporal embedding, linearly interpolated over time when
        T != temporal_size (F.interpolate(mode="linear", align_corners=False)
        at ref CLIP_ViP.py:170-176), as an explicit gather + lerp."""
        emb = self.temporal_embedding
        src = self.vip.temporal_size
        if T == src:
            return emb
        x = (torch.arange(T, dtype=torch.float32, device=emb.device) + 0.5) * src / T - 0.5
        x = x.clamp(0, src - 1)
        lo = torch.floor(x).long()
        hi = torch.clamp(lo + 1, max=src - 1)
        w = (x - lo)[None, :, None]
        return emb[:, lo] * (1 - w) + emb[:, hi] * w

    def forward(self, pixel_values: torch.Tensor) -> tuple[torch.Tensor, tuple[int, int, int]]:
        if pixel_values.dtype == torch.uint8:
            B, T, Hh, Ww, C = pixel_values.shape
            patches = self.patch_embedding(
                pixel_values.reshape(B * T, Hh, Ww, C), mean=CLIP_MEAN, std=CLIP_STD
            )
        else:
            B, T, C, Hh, Ww = pixel_values.shape
            patches = self.patch_embedding(pixel_values.reshape(B * T, C, Hh, Ww))
        D = self.config.hidden_size
        L = patches.shape[1]
        patches = patches.reshape(B, T, L, D)
        if self.temporal_embedding is not None:
            patches = patches + self._time_embed(T)[:, :, None].to(patches.dtype)
        if L != self.n_patches:
            raise ValueError(
                f"input yields {L} patches/frame but config.image_size="
                f"{self.config.image_size} with patch_size={self.config.patch_size} trains "
                f"{self.n_patches} spatial positions — resize inputs or the config"
            )
        pos = self.position_embedding.weight
        patches = patches + pos[None, None, 1:].to(patches.dtype)
        cls = (self.class_embedding + pos[0]).to(patches.dtype).expand(B, 1, D)
        head = [cls]
        if self.added_cls is not None:
            extra = (self.added_cls + pos[0]).to(patches.dtype)
            head.append(extra.expand(B, self.vip.add_cls_num, D))
        M = 1 + self.vip.add_cls_num
        embeds = torch.cat(head + [patches.reshape(B, T * L, D)], dim=1)
        return embeds, (M, T, L)


class TextEmbeddings(nn.Module):
    def __init__(self, config: CLIPTextConfig, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.compute_dtype = dtype
        self.token_embedding = nn.Embedding(config.vocab_size, config.hidden_size, device=device)
        self.position_embedding = nn.Embedding(
            config.max_position_embeddings, config.hidden_size, device=device
        )

    def forward(self, input_ids: torch.Tensor) -> torch.Tensor:
        tok = self.token_embedding(input_ids).to(self.compute_dtype)
        pos = self.position_embedding.weight[: input_ids.shape[1]]
        return tok + pos[None].to(tok.dtype)


# ---------------------------------------------------------------------------
# Encoder
# ---------------------------------------------------------------------------


class EncoderLayer(nn.Module):
    """Pre-LN transformer block; proxy attention when ``use_proxy``."""

    def __init__(self, hidden_size: int, num_heads: int, intermediate_size: int,
                 hidden_act: str = "quick_gelu", use_proxy: bool = False,
                 dtype: torch.dtype = torch.float32, proxy_mode: str = "masked_full",
                 device=None, attention_dropout: float = 0.0):
        super().__init__()
        self.use_proxy = use_proxy
        self.layer_norm1 = LayerNorm(hidden_size, dtype=dtype, device=device)
        if use_proxy:
            self.self_attn = ProxyAttention(hidden_size, num_heads, dtype, proxy_mode, device,
                                            attention_dropout)
        else:
            self.self_attn = MultiHeadAttention(hidden_size, num_heads, dtype, device,
                                                attention_dropout)
        self.layer_norm2 = LayerNorm(hidden_size, dtype=dtype, device=device)
        self.mlp = TransformerMLP(hidden_size, intermediate_size, hidden_act, dtype, device)

    def forward(
        self,
        hidden_states: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        inputs_size: Optional[tuple[int, int, int]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        x = self.layer_norm1(hidden_states)
        if self.use_proxy:
            x = self.self_attn(x, inputs_size, generator)
        else:
            x = self.self_attn(x, mask, generator)
        hidden_states = hidden_states + x
        return hidden_states + self.mlp(self.layer_norm2(hidden_states))


class Encoder(nn.Module):
    """A stack of ``EncoderLayer``; with ``remat`` each layer keeps only its
    input for the backward and recomputes the rest (``torch.utils.checkpoint``)."""

    def __init__(self, num_layers: int, hidden_size: int, num_heads: int,
                 intermediate_size: int, hidden_act: str = "quick_gelu",
                 use_proxy: bool = False, dtype: torch.dtype = torch.float32,
                 proxy_mode: str = "masked_full", device=None,
                 attention_dropout: float = 0.0, remat: bool = False):
        super().__init__()
        self.remat = remat
        self.layers = nn.ModuleList(
            EncoderLayer(hidden_size, num_heads, intermediate_size, hidden_act,
                         use_proxy, dtype, proxy_mode, device, attention_dropout)
            for _ in range(num_layers)
        )

    def forward(
        self,
        hidden_states: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        inputs_size: Optional[tuple[int, int, int]] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        for layer in self.layers:
            if self.remat and torch.is_grad_enabled():
                # the recompute takes the forward's dropout masks
                hidden_states = recomputed(layer, generator, hidden_states, mask, inputs_size)
            else:
                hidden_states = layer(hidden_states, mask, inputs_size, generator)
        return hidden_states


# ---------------------------------------------------------------------------
# Towers
# ---------------------------------------------------------------------------


class TextTransformer(nn.Module):
    def __init__(self, config: CLIPTextConfig, dtype: torch.dtype = torch.float32, device=None,
                 remat: bool = False):
        super().__init__()
        self.embeddings = TextEmbeddings(config, dtype, device)
        self.encoder = Encoder(
            config.num_hidden_layers, config.hidden_size, config.num_attention_heads,
            config.intermediate_size, config.hidden_act, use_proxy=False, dtype=dtype,
            device=device, attention_dropout=config.attention_dropout, remat=remat,
        )
        self.final_layer_norm = LayerNorm(config.hidden_size, dtype=dtype, device=device)

    def forward(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> tuple[torch.Tensor, torch.Tensor]:
        x = self.embeddings(input_ids)
        mask = make_causal_mask(input_ids.shape[1], device=input_ids.device)
        if attention_mask is not None:
            mask = mask + expand_padding_mask(attention_mask)
        x = self.final_layer_norm(self.encoder(x, mask=mask, generator=generator))
        # EOT pooling: the EOT token has the highest id in CLIP's vocab
        # (ref CLIP_ViP.py:776); argmax returns the first maximum
        eot = torch.argmax(input_ids, dim=-1)
        pooled = x[torch.arange(x.shape[0], device=x.device), eot]
        return x, pooled


class VipVisionTransformer(nn.Module):
    def __init__(self, config: CLIPVisionConfig, vip: VipConfig,
                 dtype: torch.dtype = torch.float32, device=None, remat: bool = False):
        super().__init__()
        self.use_proxy = vip.type == "ViP"
        self.embeddings = VipVisionEmbeddings(config, vip, dtype, device)
        self.pre_layrnorm = LayerNorm(config.hidden_size, dtype=dtype, device=device)
        self.encoder = Encoder(
            config.num_hidden_layers, config.hidden_size, config.num_attention_heads,
            config.intermediate_size, config.hidden_act, use_proxy=self.use_proxy,
            dtype=dtype, proxy_mode=vip.attention_mode, device=device,
            attention_dropout=config.attention_dropout, remat=remat,
        )
        self.post_layernorm = LayerNorm(config.hidden_size, dtype=dtype, device=device)

    def forward(
        self, pixel_values: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> tuple[torch.Tensor, torch.Tensor]:
        embeds, inputs_size = self.embeddings(pixel_values)
        x = self.pre_layrnorm(embeds)
        x = self.encoder(x, inputs_size=inputs_size if self.use_proxy else None,
                         generator=generator)
        return x, self.post_layernorm(x[:, 0])


# ---------------------------------------------------------------------------
# Full model
# ---------------------------------------------------------------------------


def l2_normalize(x: torch.Tensor, dim: int = -1, eps: float = 1e-12) -> torch.Tensor:
    xf = x.float()
    norm = torch.linalg.vector_norm(xf, dim=dim, keepdim=True)
    return (xf / norm.clamp_min(eps)).to(x.dtype)


class CLIPViPModel(nn.Module):
    """Dual-tower video CLIP with proxy attention (the ``VidCLIP`` surface,
    ref ``VidCLIP.py:32-81``): normalized ``text_features`` /
    ``vis_features`` plus ``logit_scale``, and with ``image`` the
    pretraining branch's ``img_features`` / ``cap_features``."""

    def __init__(self, config: CLIPVipConfig, device=None):
        super().__init__()
        self.config = config
        dt = config.dtype
        self.text_model = TextTransformer(config.text, dt, device, config.remat)
        self.vision_model = VipVisionTransformer(config.vision, config.vip, dt, device,
                                                 config.remat)
        self.visual_projection = Linear(
            config.vision.hidden_size, config.projection_dim, bias=False, dtype=dt, device=device
        )
        self.text_projection = Linear(
            config.text.hidden_size, config.projection_dim, bias=False, dtype=dt, device=device
        )
        self.logit_scale = nn.Parameter(
            torch.tensor(config.logit_scale_init_value, dtype=torch.float32, device=device)
        )

    @torch.no_grad()
    def init_weights(self, generator: torch.Generator) -> "CLIPViPModel":
        """Random init from ``generator`` (on the parameters' device), with
        the JAX package's scales: dense kernels N(0, 1/fan_in), zero biases,
        embeddings N(0, 0.02), unit layer norms, zero temporal embedding."""
        for module in self.modules():
            if isinstance(module, nn.Linear):
                module.weight.normal_(0.0, module.in_features**-0.5, generator=generator)
                if module.bias is not None:
                    module.bias.zero_()
            elif isinstance(module, nn.LayerNorm):
                module.weight.fill_(1.0)
                module.bias.zero_()
            elif isinstance(module, nn.Embedding):
                module.weight.normal_(0.0, 0.02, generator=generator)
            elif isinstance(module, PatchEmbedding):
                fan_in = module.weight[..., 0].numel()
                module.weight.normal_(0.0, fan_in**-0.5, generator=generator)
            elif isinstance(module, VipVisionEmbeddings):
                module.class_embedding.normal_(0.0, 0.02, generator=generator)
                if module.added_cls is not None:
                    module.added_cls.normal_(0.0, 0.02, generator=generator)
                if module.temporal_embedding is not None:
                    module.temporal_embedding.zero_()
        self.logit_scale.fill_(self.config.logit_scale_init_value)
        return self

    def encode_text(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        _, pooled = self.text_model(input_ids, attention_mask, generator)
        return self.text_projection(pooled)

    def encode_video(
        self, pixel_values: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        """pixel_values: uint8 [B, T, H, W, 3] or fp32 [B, T, C, H, W]."""
        if self.config.vip.type == "ViP":
            _, pooled = self.vision_model(pixel_values, generator)
            return self.visual_projection(pooled)
        # frame-mean baseline: encode each frame independently, normalize,
        # mean-pool over frames (ref VidCLIP.py:55-65)
        B, T = pixel_values.shape[:2]
        frames = pixel_values.reshape(B * T, 1, *pixel_values.shape[2:])
        _, pooled = self.vision_model(frames, generator)
        feats = l2_normalize(self.visual_projection(pooled))
        return feats.reshape(B, T, -1).mean(dim=1)

    def forward(
        self,
        video: torch.Tensor,
        text_input_ids: torch.Tensor,
        text_input_mask: Optional[torch.Tensor] = None,
        image: Optional[torch.Tensor] = None,
        caption_ids: Optional[torch.Tensor] = None,
        caption_masks: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> dict[str, torch.Tensor]:
        """``generator`` feeds attention dropout in training mode.

        The pretraining branch (``xpretrain_tpu/models/clip_vip/model.py:680-705``): ``image`` [B, n,
        C, H, W] fp32 (or [B, n, H, W, 3] uint8) is encoded as B*n one-frame
        clips, ``caption_ids`` / ``caption_masks`` [B, n, L] by the text
        tower. The towers run in the JAX model's order: video, text, image,
        caption (the order dropout draws from ``generator``)."""
        vis = self.forward_video(video, generator)
        txt = self.forward_text(text_input_ids, text_input_mask, generator)
        results = {"text_features": txt, "vis_features": vis, "logit_scale": self.logit_scale}
        if image is not None:
            if caption_ids is None:
                raise ValueError("the image branch needs caption_ids beside the image")
            B, n = image.shape[:2]
            L = caption_ids.shape[-1]
            results["img_features"] = self.forward_video(image.reshape(B * n, 1, *image.shape[2:]), generator)
            masks = None if caption_masks is None else caption_masks.reshape(-1, L)
            results["cap_features"] = self.forward_text(caption_ids.reshape(-1, L), masks, generator)
        return results

    def forward_video(
        self, pixel_values: torch.Tensor, generator: Optional[torch.Generator] = None
    ) -> torch.Tensor:
        return l2_normalize(self.encode_video(pixel_values, generator))

    def forward_text(
        self,
        input_ids: torch.Tensor,
        attention_mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
    ) -> torch.Tensor:
        return l2_normalize(self.encode_text(input_ids, attention_mask, generator))
