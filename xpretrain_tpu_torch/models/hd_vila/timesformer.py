"""Feature-level TimeSformer (PyTorch): divided space-time attention.

Counterpart of ``xpretrain_tpu/models/hd_vila/timesformer.py`` (ref
``hd-vila/src/modeling/timesformer.py:150-525``). It runs on CNN feature
maps ([B, T, C, H, W], no patch conv); each block attends over time for
each location, then over space for each frame (ref ``:206-226``).

- ``temporal_fc`` is zero-initialised in blocks i > 0 only (ref ``:458-466``;
  ``init_hdvila_weights`` reads :attr:`DividedBlock.zero_init_temporal_fc`).
- The position embeddings are interpolated at another grid or frame count
  by :func:`_interp_2d` / :func:`_interp_1d`: linear, align_corners=False,
  the source coordinate clipped to [0, src - 1] before the floor, as JAX.
- The reference declares a final LayerNorm and never applies it; neither
  module has one.
- The attention is ``F.scaled_dot_product_attention`` (JAX computes it in
  XLA, with no kernel); layer norms (eps 1e-6) run in fp32, the rest in
  ``dtype``; the MLP's GELU is exact.
"""

from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from xpretrain_tpu_torch.models.common import LayerNorm, Linear


def _interp_1d(emb: torch.Tensor, target: int) -> torch.Tensor:
    """[1, T0, C] -> [1, T, C] linear, align_corners=False."""
    src = emb.shape[1]
    if src == target:
        return emb
    lo, hi, w = _axis_weights(src, target, emb.device)
    w = w[None, :, None].to(emb.dtype)
    return emb[:, lo] * (1 - w) + emb[:, hi] * w


def _axis_weights(src: int, dst: int, device) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    x = ((torch.arange(dst, device=device, dtype=torch.float32) + 0.5) * src / dst - 0.5).clamp(0, src - 1)
    lo = torch.floor(x).long()
    hi = torch.clamp(lo + 1, max=src - 1)
    return lo, hi, x - lo


def _interp_2d(emb: torch.Tensor, src_hw: tuple[int, int], dst_hw: tuple[int, int]) -> torch.Tensor:
    """[1, H0*W0, C] -> [1, H*W, C] bilinear, align_corners=False."""
    if tuple(src_hw) == tuple(dst_hw):
        return emb
    (h0, w0), (h1, w1) = src_hw, dst_hw
    grid = emb.reshape(1, h0, w0, -1)
    lo, hi, w = _axis_weights(h0, h1, emb.device)
    w = w.to(emb.dtype)[None, :, None, None]
    grid = grid[:, lo] * (1 - w) + grid[:, hi] * w
    lo, hi, w = _axis_weights(w0, w1, emb.device)
    w = w.to(emb.dtype)[None, None, :, None]
    grid = grid[:, :, lo] * (1 - w) + grid[:, :, hi] * w
    return grid.reshape(1, h1 * w1, -1)


class _MHA(nn.Module):
    """timm-style fused-qkv attention (checkpoint layout ``qkv``/``proj``)."""

    def __init__(self, dim: int, num_heads: int, dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.dim, self.num_heads = dim, num_heads
        self.qkv = Linear(dim, 3 * dim, dtype=dtype, device=device)
        self.proj = Linear(dim, dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:  # [..., N, C]
        lead, n = x.shape[:-2], x.shape[-2]
        d = self.dim // self.num_heads
        qkv = self.qkv(x)
        h = qkv.shape[-1] // (3 * d)  # this rank's heads under tensor parallelism
        qkv = qkv.reshape(-1, n, 3, h, d).permute(2, 0, 3, 1, 4)  # [3, B', h, N, d]
        out = F.scaled_dot_product_attention(qkv[0], qkv[1], qkv[2], scale=d**-0.5)
        out = out.transpose(1, 2).reshape(*lead, n, h * d)
        return self.proj(out)


class DividedBlock(nn.Module):
    """Divided space-time block (ref ``Block.forward`` ``:206-226``), [B, T, HW, C]."""

    def __init__(self, dim: int, num_heads: int, mlp_ratio: float = 4.0, zero_init_temporal_fc: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.zero_init_temporal_fc = zero_init_temporal_fc
        self.temporal_norm1 = LayerNorm(dim, 1e-6, dtype, device)
        self.temporal_attn = _MHA(dim, num_heads, dtype, device)
        self.temporal_fc = Linear(dim, dim, dtype=dtype, device=device)
        self.norm1 = LayerNorm(dim, 1e-6, dtype, device)
        self.attn = _MHA(dim, num_heads, dtype, device)
        self.norm2 = LayerNorm(dim, 1e-6, dtype, device)
        self.mlp_fc1 = Linear(dim, int(dim * mlp_ratio), dtype=dtype, device=device)
        self.mlp_fc2 = Linear(int(dim * mlp_ratio), dim, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        # temporal: attend over T for each spatial location
        res_t = self.temporal_attn(self.temporal_norm1(x.transpose(1, 2))).transpose(1, 2)
        xt_out = x + self.temporal_fc(res_t)
        # spatial: attend over HW for each frame
        x = xt_out + self.attn(self.norm1(xt_out))
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x)), approximate="none"))
        return x + y


@dataclasses.dataclass(frozen=True)
class TimeSformerConfig:
    depth: int = 4
    num_frames: int = 7
    H: int = 10
    W: int = 16
    embed_dim: int = 768
    num_heads: int = 16
    mlp_ratio: float = 4.0
    dtype: torch.dtype = torch.float32
    remat: bool = False  # per-block recompute in the backward (see ResNet.remat)


class TimeSformer(nn.Module):
    """Feature-level divided space-time transformer (ref ``:420-525``)."""

    def __init__(self, config: TimeSformerConfig, device=None):
        super().__init__()
        cfg = self.config = config
        self.pos_embed = nn.Parameter(torch.zeros(1, cfg.H * cfg.W, cfg.embed_dim, device=device))
        self.time_embed = nn.Parameter(torch.zeros(1, cfg.num_frames, cfg.embed_dim, device=device))
        for i in range(cfg.depth):
            self.add_module(f"blocks_{i}", DividedBlock(cfg.embed_dim, cfg.num_heads, cfg.mlp_ratio,
                                                        zero_init_temporal_fc=i > 0, dtype=cfg.dtype, device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x: [B, T, C, H, W] -> [B, T, C, H, W] in ``dtype``."""
        cfg = self.config
        B, T, C, H, W = x.shape
        x = x.permute(0, 1, 3, 4, 2).reshape(B, T, H * W, C)
        pos = _interp_2d(self.pos_embed, (cfg.H, cfg.W), (H, W))
        x = x + pos[None].to(x.dtype)
        x = x + _interp_1d(self.time_embed, T)[:, :, None, :].to(x.dtype)  # broadcast over space
        for i in range(cfg.depth):
            block = getattr(self, f"blocks_{i}")
            if cfg.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return x.reshape(B, T, H, W, C).permute(0, 1, 4, 2, 3)
