"""Model config from a training config (``xpretrain_tpu/train/trainer.py``).

The trainer itself comes with the training slice."""

from __future__ import annotations

import torch

from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, VipConfig


def clip_vip_config_from(cfg) -> CLIPVipConfig:
    """Build a model config from a ConfigDict-style training config."""
    vip = cfg.get("clip_vision_additional_config", {})
    size = cfg.get("clip_size", "base_32")
    factory = {
        "base_32": CLIPVipConfig.base_patch32,
        "base_16": CLIPVipConfig.base_patch16,
        "large_14": CLIPVipConfig.large_patch14,
        "tiny": lambda **kw: CLIPVipConfig.tiny_debug(
            image_size=int(cfg.get("crop_img_size", 32)), **kw
        ),
    }[size]
    return factory(
        vip=VipConfig(
            type=vip.get("type", "ViP"),
            temporal_size=int(vip.get("temporal_size", 12)),
            if_use_temporal_embed=bool(vip.get("if_use_temporal_embed", 1)),
            add_cls_num=int(vip.get("add_cls_num", 3)),
            logit_scale_init_value=float(vip.get("logit_scale_init_value", 4.60)),
        ),
        dtype=torch.bfloat16 if cfg.get("bf16", True) else torch.float32,
    )
