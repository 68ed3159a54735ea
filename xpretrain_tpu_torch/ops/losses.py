"""Contrastive-loss zoo in plain PyTorch (``xpretrain_tpu/ops/losses.py``).

The JAX losses are XLA, not Pallas, so there is no kernel here: each function
is ``(features..., temp | logit_scale) -> fp32 scalar`` with the JAX
function's math and dtype rules. Features arrive L2-normalized;
``logit_scale`` is the log-space temperature and is exponentiated here;
cross-entropies are batch means and a total is the sum of its directional
terms.

One dtype rule needs care: JAX promotes a bf16 similarity times an fp32
``exp(logit_scale)`` array to fp32, where torch would keep bf16 for a 0-d
tensor. The learnable-temperature losses therefore multiply in fp32.

MLM, ITM, label smoothing and ``mtc_loss`` come with the model families that
use them.
"""

from __future__ import annotations

import functools
from typing import Callable

import torch

Tensor = torch.Tensor


def _xent(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean softmax cross-entropy with integer labels, fp32 accumulation."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.mean(logz - gold)


def _diag_labels(sim: Tensor) -> Tensor:
    return torch.arange(sim.shape[0], device=sim.device)


def _sym_nce(sim: Tensor) -> Tensor:
    """Symmetric InfoNCE over a scaled similarity matrix with diagonal labels."""
    labels = _diag_labels(sim)
    return _xent(sim, labels) + _xent(sim.T, labels)


def _scaled_sim(a: Tensor, b: Tensor, logit_scale: Tensor) -> Tensor:
    """``(a @ b.T) * exp(logit_scale)`` with JAX's promotion: fp32 out."""
    return (a @ b.T).float() * torch.exp(logit_scale.float())


def _off_diagonal(x: Tensor) -> Tensor:
    """Rows of a square [b, b, ...] without their diagonal entry: [b, b-1, ...]."""
    b = x.shape[0]
    keep = ~torch.eye(b, dtype=torch.bool, device=x.device)
    return x[keep].reshape(b, b - 1, *x.shape[2:])


# ---------------------------------------------------------------------------
# Fixed-temperature losses
# ---------------------------------------------------------------------------


def nce_loss(vis_feat: Tensor, text_feat: Tensor, temp: float = 0.05) -> Tensor:
    """``NCEContrastiveLoss``: symmetric InfoNCE at fixed temperature."""
    return _sym_nce((vis_feat @ text_feat.T) / temp)


def triplet_loss(im: Tensor, s: Tensor, margin: float = 0.2, max_violation: bool = False) -> Tensor:
    """``TripletContrastiveLoss``: margin ranking over both directions."""
    scores = (im @ s.T).float()
    diag = torch.diagonal(scores)
    eye = torch.eye(scores.shape[0], dtype=torch.bool, device=scores.device)
    cost_s = torch.where(eye, 0.0, torch.clamp(margin + scores - diag[:, None], min=0.0))
    cost_im = torch.where(eye, 0.0, torch.clamp(margin + scores - diag[None, :], min=0.0))
    if max_violation:
        return cost_s.max(dim=1).values.sum() + cost_im.max(dim=0).values.sum()
    return cost_s.sum() + cost_im.sum()


def hard_neg_loss(vis_feat: Tensor, text_feat: Tensor, hard_negative_num: int = 16) -> Tensor:
    """``HardNegLoss``: positives vs the top-k hardest in-batch negatives."""
    sim = (text_feat @ vis_feat.T).float()
    bsz = sim.shape[0]
    masked = sim - 10000.0 * torch.eye(bsz, dtype=sim.dtype, device=sim.device)
    hard_t2v = torch.topk(masked, hard_negative_num, dim=-1).values
    hard_v2t = torch.topk(masked.T, hard_negative_num, dim=-1).values
    pos = torch.diagonal(sim)[:, None]
    labels = torch.zeros(bsz, dtype=torch.long, device=sim.device)
    return _xent(torch.cat([pos, hard_t2v], dim=-1), labels) + _xent(
        torch.cat([pos, hard_v2t], dim=-1), labels
    )


def milnce_loss(video_embd: Tensor, text_embd: Tensor, temp: float = 0.05) -> Tensor:
    """``MILNCEContrastiveLoss``: ``k`` candidate texts per video, row-major
    ``[B*k, D]``; video i's positives are its own k candidates."""
    b = video_embd.shape[0]
    x = (video_embd @ text_embd.T).float() / temp
    x = x.reshape(b, b, -1)  # [B, B, k]
    nominator = torch.logsumexp(torch.diagonal(x, dim1=0, dim2=1).T, dim=1)  # [B]
    denominator = torch.cat([_off_diagonal(x), x.permute(1, 0, 2)], dim=1).reshape(b, -1)
    return torch.mean(torch.logsumexp(denominator, dim=1) - nominator)


# ---------------------------------------------------------------------------
# Learnable-temperature losses (logit_scale is log-space)
# ---------------------------------------------------------------------------


def nce_learnable_temp(vis_feat: Tensor, text_feat: Tensor, logit_scale: Tensor) -> Tensor:
    """``NCELearnableTempLoss``: CLIP's symmetric InfoNCE."""
    return _sym_nce(_scaled_sim(vis_feat, text_feat, logit_scale))


def nce_learnable_temp_dsl(vis_feat: Tensor, text_feat: Tensor, logit_scale: Tensor) -> Tensor:
    """``NCELearnableTempDSLLoss``: dual-softmax reweighting inside the loss."""
    sim = _scaled_sim(vis_feat, text_feat, logit_scale)
    t2v = sim * torch.softmax(sim, dim=0)
    v2t = sim.T * torch.softmax(sim.T, dim=0)
    labels = _diag_labels(sim)
    return _xent(t2v, labels) + _xent(v2t, labels)


def vid_img_nce_learnable_temp(
    vis_feat: Tensor, text_feat: Tensor, img_feat: Tensor, cap_feat: Tensor, logit_scale: Tensor
) -> Tensor:
    """``VidImgNCELearnableTempLoss``: concat video+image batches, one InfoNCE."""
    vis = torch.cat([vis_feat, img_feat], dim=0)
    txt = torch.cat([text_feat, cap_feat], dim=0)
    return nce_learnable_temp(vis, txt, logit_scale)


def vid_img_divide_nce_learnable_temp(
    vis_feat: Tensor, text_feat: Tensor, img_feat: Tensor, cap_feat: Tensor, logit_scale: Tensor
) -> Tensor:
    """``VidImgDivideNCELearnableTempLoss``: separate video and image InfoNCEs."""
    return nce_learnable_temp(vis_feat, text_feat, logit_scale) + nce_learnable_temp(
        img_feat, cap_feat, logit_scale
    )


def nce_learnable_temp_vs_vc(
    vis_feat: Tensor, text_feat: Tensor, img_feat: Tensor, cap_feat: Tensor, logit_scale: Tensor
) -> Tensor:
    """``NCELearnableTempLoss_vs_vc``: video-subtitle + video-caption InfoNCEs."""
    return nce_learnable_temp(vis_feat, text_feat, logit_scale) + nce_learnable_temp(
        vis_feat, cap_feat, logit_scale
    )


def nce_learnable_temp_vs_vc_fc(
    vis_feat: Tensor, text_feat: Tensor, img_feat: Tensor, cap_feat: Tensor, logit_scale: Tensor
) -> Tensor:
    """``NCELearnableTempLoss_vs_vc_fc``: + frame-caption InfoNCE."""
    return nce_learnable_temp_vs_vc(
        vis_feat, text_feat, img_feat, cap_feat, logit_scale
    ) + nce_learnable_temp(img_feat, cap_feat, logit_scale)


def _vsc_terms(vis_feat: Tensor, text_feat: Tensor, cap_feat: Tensor, logit_scale: Tensor) -> Tensor:
    """Shared-negative-pool terms of the ``vsc`` losses: v2t rows pool the
    in-batch negatives of both the subtitle and the caption similarities (the
    positive column first); the two t2v directions stay diagonal InfoNCEs."""
    v2t = _scaled_sim(vis_feat, text_feat, logit_scale)
    v2t_2 = _scaled_sim(vis_feat, cap_feat, logit_scale)
    labels = _diag_labels(v2t)
    v2t_neg, v2t_neg_2 = _off_diagonal(v2t), _off_diagonal(v2t_2)
    pooled = torch.cat([torch.diagonal(v2t)[:, None], v2t_neg, v2t_neg_2], dim=1)
    pooled_2 = torch.cat([torch.diagonal(v2t_2)[:, None], v2t_neg, v2t_neg_2], dim=1)
    zero_labels = torch.zeros_like(labels)
    return (
        _xent(v2t.T, labels)
        + _xent(v2t_2.T, labels)
        + _xent(pooled, zero_labels)
        + _xent(pooled_2, zero_labels)
    )


def nce_learnable_temp_vsc(
    vis_feat: Tensor, text_feat: Tensor, img_feat: Tensor, cap_feat: Tensor, logit_scale: Tensor
) -> Tensor:
    """``NCELearnableTempLoss_vsc``: video-(sub,cap) with shared negative pool."""
    return _vsc_terms(vis_feat, text_feat, cap_feat, logit_scale)


def nce_learnable_temp_vsc_fc(
    vis_feat: Tensor, text_feat: Tensor, img_feat: Tensor, cap_feat: Tensor, logit_scale: Tensor
) -> Tensor:
    """``NCELearnableTempLoss_vsc_fc``: the pretrain default, vsc + frame-cap."""
    return _vsc_terms(vis_feat, text_feat, cap_feat, logit_scale) + nce_learnable_temp(
        img_feat, cap_feat, logit_scale
    )


# ---------------------------------------------------------------------------
# Registry: reference class names map to (fn, signature kind)
# ---------------------------------------------------------------------------

# signature kinds: "pair_temp" (vis, text, temp), "pair_scale" (vis, text,
# logit_scale), "quad_scale" (vis, text, img, cap, logit_scale)
LOSS_REGISTRY: dict[str, tuple[Callable, str]] = {
    "NCEContrastiveLoss": (nce_loss, "pair_temp"),
    "TripletContrastiveLoss": (triplet_loss, "pair_temp"),
    "HardNegLoss": (hard_neg_loss, "pair_temp"),
    "MILNCEContrastiveLoss": (milnce_loss, "pair_temp"),
    "NCELearnableTempLoss": (nce_learnable_temp, "pair_scale"),
    "NCELearnableTempDSLLoss": (nce_learnable_temp_dsl, "pair_scale"),
    "VidImgNCELearnableTempLoss": (vid_img_nce_learnable_temp, "quad_scale"),
    "VidImgDivideNCELearnableTempLoss": (vid_img_divide_nce_learnable_temp, "quad_scale"),
    "NCELearnableTempLoss_vs_vc": (nce_learnable_temp_vs_vc, "quad_scale"),
    "NCELearnableTempLoss_vs_vc_fc": (nce_learnable_temp_vs_vc_fc, "quad_scale"),
    "NCELearnableTempLoss_vsc": (nce_learnable_temp_vsc, "quad_scale"),
    "NCELearnableTempLoss_vsc_fc": (nce_learnable_temp_vsc_fc, "quad_scale"),
}


def build_loss_fn(loss_name: str, **static_kwargs) -> Callable:
    """Look up a loss by its reference class name, with static kwargs (temp,
    margin, hard_negative_num, ...) bound; the result carries
    ``signature_kind``."""
    if loss_name not in LOSS_REGISTRY:
        raise KeyError(f"unknown loss {loss_name!r}; known: {sorted(LOSS_REGISTRY)}")
    fn, kind = LOSS_REGISTRY[loss_name]
    bound = functools.partial(fn, **static_kwargs)
    bound.signature_kind = kind  # type: ignore[attr-defined]
    return bound
