"""In-process retrieval towers, the counterpart of
``xpretrain_tpu/serving/artifact.py:RetrievalArtifact``.

The same three calls: ``encode_video`` on frames, ``encode_text`` on token
ids + mask, both to L2-normalized features, and ``similarity`` for ranking;
:class:`RetrievalTowers` for CLIP-ViP, :class:`LfVilaTowers` for LF-VILA and
:class:`HdVilaTowers` for HD-VILA (the towers of
``export_lfvila_retrieval_towers`` and ``export_hdvila_retrieval_towers``
there). ``serving/artifact.py`` exports the same towers to one file.
"""

from __future__ import annotations

from typing import TYPE_CHECKING

import numpy as np
import torch

from xpretrain_tpu_torch.models.clip_vip.model import CLIPViPModel
from xpretrain_tpu_torch.models.lf_vila.tasks import LfVilaRetrieval

if TYPE_CHECKING:
    from xpretrain_tpu_torch.cli.run_pretrain_hdvila import HdVilaPretrainModel


class _Towers:
    """A retrieval model on one device (moved there in place), served under
    ``inference_mode``; the subclass says how features are scored."""

    def __init__(self, model: torch.nn.Module, device: torch.device | str):
        self.device = torch.device(device)
        self.model = model.to(self.device).eval()

    def _to_device(self, x) -> torch.Tensor:
        if isinstance(x, np.ndarray):
            x = torch.from_numpy(np.ascontiguousarray(x))
        return x.to(self.device)

    def encode_video(self, *video) -> torch.Tensor:
        """Frames -> L2-normalized [B, dim] features (the model's
        ``forward_video``)."""
        with torch.inference_mode():
            return self.model.forward_video(*(self._to_device(v) for v in video))

    def encode_text(self, input_ids, attention_mask) -> torch.Tensor:
        """Token ids + mask -> L2-normalized [B, dim] features (the model's
        ``forward_text``)."""
        with torch.inference_mode():
            return self.model.forward_text(self._to_device(input_ids), self._to_device(attention_mask))


class RetrievalTowers(_Towers):
    """CLIP-ViP: ``encode_video`` on uint8 [B, T, H, W, 3] frames,
    ``encode_text`` on [B, seq] ids + mask; features [B, proj]."""

    model: CLIPViPModel

    def similarity(self, text_feats: torch.Tensor, video_feats: torch.Tensor,
                   scaled: bool = False) -> torch.Tensor:
        """[Nt, Nv] retrieval scores; ``scaled`` applies exp(logit_scale)."""
        with torch.inference_mode():
            scores = text_feats.float() @ video_feats.float().T
            if scaled:
                scores = scores * self.model.logit_scale.exp()
            return scores


class LfVilaTowers(_Towers):
    """LF-VILA paragraph-to-video retrieval: ``encode_video`` on float
    [B, 3, N, H, W] (ImageNet-normalized) or uint8 [B, N, H, W, 3] frames,
    ``encode_text`` on [B, M, L] sentence ids + mask; features [B, hidden]."""

    model: LfVilaRetrieval

    def similarity(self, text_feats: torch.Tensor, video_feats: torch.Tensor,
                   scaled: bool = False) -> torch.Tensor:
        """[Nt, Nv] retrieval scores; ``scaled`` divides by the model's
        contrastive temperature (``LfVilaConfig.temp``)."""
        with torch.inference_mode():
            scores = text_feats.float() @ video_feats.float().T
            return scores / self.model.config.temp if scaled else scores


class HdVilaTowers(_Towers):
    """HD-VILA's stage-1 ITC towers: ``encode_video`` on the uint8 pair
    ``(img_middle [B, clips, 3, H, W], img_other [B, clips, T-1, 3, H/4,
    W/4])``, normalized once on the device, ``encode_text`` on [B, seq] ids +
    mask; features [B, dim]."""

    model: HdVilaPretrainModel

    def similarity(self, text_feats: torch.Tensor, video_feats: torch.Tensor,
                   scaled: bool = False) -> torch.Tensor:
        """[Nt, Nv] retrieval scores; ``scaled`` divides by the model's
        contrastive temperature."""
        with torch.inference_mode():
            scores = text_feats.float() @ video_feats.float().T
            return scores / self.model.temp if scaled else scores
