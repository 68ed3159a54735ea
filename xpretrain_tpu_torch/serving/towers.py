"""In-process retrieval towers, the counterpart of
``xpretrain_tpu/serving/artifact.py:RetrievalArtifact``.

The same three calls: ``encode_video`` on raw uint8 frames, ``encode_text``
on token ids + mask, both to L2-normalized features, and ``similarity`` for
ranking. Saving a standalone artifact (``torch.export``) comes later.
"""

from __future__ import annotations

import numpy as np
import torch

from xpretrain_tpu_torch.models.clip_vip.model import CLIPViPModel


class RetrievalTowers:
    """A CLIP-ViP model on one device (moved there in place), served under
    ``inference_mode``."""

    def __init__(self, model: CLIPViPModel, device: torch.device | str):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()

    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    def encode_video(self, video_u8) -> torch.Tensor:
        """uint8 [B, T, H, W, 3] -> L2-normalized [B, proj] features."""
        with torch.inference_mode():
            return self.model.forward_video(self._to_device(video_u8))

    def encode_text(self, input_ids, attention_mask) -> torch.Tensor:
        """[B, seq] ids + [B, seq] mask -> L2-normalized [B, proj] features."""
        with torch.inference_mode():
            return self.model.forward_text(
                self._to_device(input_ids), self._to_device(attention_mask)
            )

    def similarity(self, text_feats: torch.Tensor, video_feats: torch.Tensor,
                   scaled: bool = False) -> torch.Tensor:
        """[Nt, Nv] retrieval scores; ``scaled`` applies exp(logit_scale)."""
        with torch.inference_mode():
            scores = text_feats.float() @ video_feats.float().T
            if scaled:
                scores = scores * self.model.logit_scale.exp()
            return scores
