"""HD-VILA hybrid high-res/low-res end-to-end encoder (PyTorch).

Counterpart of ``xpretrain_tpu/models/hd_vila/e2e.py`` (ref
``hd-vila/src/modeling/e2e_model.py:16-216``): one full-resolution middle
frame per clip through a ResNet-50; the T-1 low-res neighbor frames through
a second ResNet up to stage 3; a divided space-time TimeSformer over the
temporal sequence with the middle frame's stage-3 feature inserted at
``T // 2``; the high-res spatial and temporal branches fused by a 1x1 conv
(``extract_features`` ``:111-141``).

:meth:`HdVilaEncoder.normalize` is the one normalization on the port's path:
it takes uint8 frames (or 0-255 floats) as the host ships them, standardizes
them with the 0-255 ImageNet mean and std in fp32 on the device, and the
first convolution casts to the compute dtype. (The JAX data path normalizes
on the host as well, ROADMAP Queue 3.)

:meth:`HdVilaEncoder.extract_features` and its two one-input variants hold
three spans (``utils/profiling.py:span``): ``xpt.hdvila.cnn``, the
high-resolution ResNet with ``grid_encoder`` and the middle frame's
stage-3 grid; ``xpt.hdvila.cnn_low``, the low-resolution ResNet to stage 3
with ``grid_encoder_low``; ``xpt.hdvila.timesformer``. They record in eager
steps; a graphed step's replays run no Python and record none.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xpretrain_tpu_torch.models.common import device_constant
from xpretrain_tpu_torch.models.hd_vila.resnet import Conv2d, ResNet
from xpretrain_tpu_torch.models.hd_vila.timesformer import TimeSformer, TimeSformerConfig
from xpretrain_tpu_torch.utils.profiling import span

IMAGENET_MEAN_255 = (123.675, 116.28, 103.53)
IMAGENET_STD_255 = (58.395, 57.12, 57.375)


def _imagenet_255() -> np.ndarray:
    """fp32 [2, 1, 3, 1, 1]: the 0-255 ImageNet mean, then its std."""
    return np.array([IMAGENET_MEAN_255, IMAGENET_STD_255], np.float32).reshape(2, 1, 3, 1, 1)


@dataclasses.dataclass(frozen=True)
class HdVilaEncoderConfig:
    resnet_depth: int = 50
    hidden_size: int = 768
    timesformer_depth: int = 4
    timesformer_heads: int = 16
    timesformer_frames: int = 7
    timesformer_hw: tuple = (10, 16)
    dtype: torch.dtype = torch.float32
    # recompute ResNet and TimeSformer blocks in the backward (the
    # reference's ``with_cp`` option)
    remat: bool = False
    # JAX's space-to-depth stem (a TPU layout of the same parameters, same
    # output): kept for the config; the port always runs the direct conv
    s2d_stem: bool = False

    @staticmethod
    def tiny(**overrides) -> "HdVilaEncoderConfig":
        base = dict(
            resnet_depth=18,
            hidden_size=64,
            timesformer_depth=1,
            timesformer_heads=4,
        )
        base.update(overrides)
        return HdVilaEncoderConfig(**base)


class HdVilaEncoder(nn.Module):
    def __init__(self, config: HdVilaEncoderConfig, device=None):
        super().__init__()
        cfg = self.config = config
        resnet = dict(depth=cfg.resnet_depth, dtype=cfg.dtype, remat=cfg.remat, s2d_stem=cfg.s2d_stem,
                      device=device)
        self.cnn = ResNet(**resnet)
        # forward_to_stage(stage=2) alone drives it: no stage 4 (as flax)
        self.cnn_low = ResNet(**resnet, num_stages=3)
        hidden = cfg.hidden_size
        # the grid convs' input widths follow the ResNet's depth (flax infers
        # them; JAX's config fields for them are never read)
        stage3, stage4 = self.cnn.stage_channels[2:]
        self.grid_encoder_conv = Conv2d(stage4, hidden, 1, dtype=cfg.dtype, device=device)
        self.grid_encoder_low_conv = Conv2d(stage3, hidden, 1, dtype=cfg.dtype, device=device)
        self.grid_encoder_combine_conv = Conv2d(2 * hidden, hidden, 1, dtype=cfg.dtype, device=device)
        self.timesformer = TimeSformer(TimeSformerConfig(
            depth=cfg.timesformer_depth,
            num_frames=cfg.timesformer_frames,
            H=cfg.timesformer_hw[0],
            W=cfg.timesformer_hw[1],
            embed_dim=hidden,
            num_heads=cfg.timesformer_heads,
            dtype=cfg.dtype,
            remat=cfg.remat,
        ), device=device)

    # ---- helpers ---------------------------------------------------------

    @staticmethod
    def normalize(images: torch.Tensor) -> torch.Tensor:
        """uint8 or 0-255 float [N, 3, H, W] -> fp32 (x - mean) / std."""
        mean, std = device_constant(_imagenet_255, (), images.device)
        return (images.float() - mean) / std

    def _grid_encoder(self, x: torch.Tensor) -> torch.Tensor:
        """1x1 conv + 2x2 maxpool + GELU on NCHW stage-4 features."""
        return F.gelu(F.max_pool2d(self.grid_encoder_conv(x), 2, 2), approximate="none")

    def _grid_encoder_low(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.grid_encoder_low_conv(x), approximate="none")

    def _combine(self, x: torch.Tensor) -> torch.Tensor:
        return F.gelu(self.grid_encoder_combine_conv(x), approximate="none")

    @staticmethod
    def _downsample_quarter(x: torch.Tensor) -> torch.Tensor:
        """F.interpolate(scale_factor=1/4) equivalent: nearest with the
        torch 'nearest' index rule floor(i * 4)."""
        return x[:, :, ::4, ::4]

    # ---- forward ---------------------------------------------------------

    def extract_features(
        self, img_middle: Optional[torch.Tensor], img_other: Optional[torch.Tensor]
    ) -> tuple[tuple[torch.Tensor, ...], torch.Tensor]:
        """img_middle: [B, clips, 3, H, W]; img_other: [B, clips, T-1, 3, H/4, W/4].

        Returns (stage features of the middle frame, fused grid [B*clips,
        hidden, H/64, W/64])."""
        if img_middle is None:
            return self._extract_other_only(img_other)
        if img_other is None:
            return self._extract_middle_only(img_middle)
        b, clips, c, h, w = img_middle.shape
        frm = img_other.shape[2] + 1
        middle = self.normalize(img_middle.reshape(-1, c, h, w))
        other = self.normalize(img_other.reshape(-1, c, *img_other.shape[-2:]))

        with span("xpt.hdvila.cnn"):
            stage_features = self.cnn(middle)
            grid_hi = self._grid_encoder(stage_features[-1])
            mid3 = self._grid_encoder_low(self._downsample_quarter(stage_features[-2]))

        with span("xpt.hdvila.cnn_low"):
            other = self._grid_encoder_low(self.cnn_low.forward_to_stage(other, stage=2))
        other = other.reshape(b * clips, frm - 1, *other.shape[1:])
        half = frm // 2
        temporal = torch.cat([other[:, :half], mid3[:, None], other[:, half:]], dim=1)
        with span("xpt.hdvila.timesformer"):
            temporal = self.timesformer(temporal)[:, half]

        fused = self._combine(torch.cat([grid_hi, temporal], dim=1))
        return stage_features, fused

    def _extract_middle_only(self, img_middle: torch.Tensor):
        b, clips, c, h, w = img_middle.shape
        middle = self.normalize(img_middle.reshape(-1, c, h, w))
        with span("xpt.hdvila.cnn"):
            stage_features = self.cnn(middle)
            grid_hi = self._grid_encoder(stage_features[-1])
            mid3 = self._grid_encoder_low(self._downsample_quarter(stage_features[-2]))
        with span("xpt.hdvila.timesformer"):
            temporal = self.timesformer(mid3[:, None])[:, 0]
        fused = self._combine(torch.cat([grid_hi, temporal], dim=1))
        return stage_features, fused

    def _extract_other_only(self, img_other: torch.Tensor):
        b, clips, frm, c, h, w = img_other.shape
        other = self.normalize(img_other.reshape(-1, c, h, w))
        with span("xpt.hdvila.cnn_low"):
            other = self._grid_encoder_low(self.cnn_low.forward_to_stage(other, stage=2))
        other = other.reshape(b * clips, frm, *other.shape[1:])
        with span("xpt.hdvila.timesformer"):
            temporal = self.timesformer(other)[:, frm // 2]
        return (), temporal

    def forward(self, img_middle: Optional[torch.Tensor], img_other: Optional[torch.Tensor]) -> torch.Tensor:
        """-> visual grid [B, clips, 1, H', W', hidden] for the BERT fusion
        stage (the ``visual_features`` permute at ``e2e_model.py:80-86``)."""
        b, clips = (img_middle if img_middle is not None else img_other).shape[:2]
        _, fused = self.extract_features(img_middle, img_other)
        c, h, w = fused.shape[-3:]
        return fused.reshape(b, clips, 1, c, h, w).permute(0, 1, 2, 4, 5, 3)
