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

Below them, the masked-modeling and matching losses of LF-VILA (and later
HD-VILA): ``mlm_loss``, ``itm_loss``, ``label_smoothing_xent`` and
``mtc_loss``, each with JAX's rules (fp32 logits, a ``max(count, 1)``
denominator, -100 for ignored rows). ``mtc_loss`` draws its clip
permutations from a ``torch.Generator`` where JAX splits a PRNG key, so the
two draw other clips from the same seed; ``indices=`` fixes them for both.

In a data-parallel group (``parallel/mesh.py``) the losses see the global
batch, as JAX's SPMD losses do: the registry's functions
(:func:`build_loss_fn`) and :func:`mtc_loss` gather their features over ranks
(with gradients) and compute the global loss on every rank; a mean over a
data-dependent count (:func:`mlm_loss`, :func:`global_ratio`) divides by the
global count. Without a group nothing changes.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import torch

from xpretrain_tpu_torch.parallel.mesh import all_reduce_sum, current_mesh, gather_rows, world_size

Tensor = torch.Tensor


def softmax_xent(logits: Tensor, labels: Tensor) -> Tensor:
    """Mean softmax cross-entropy with integer labels, fp32 accumulation (also
    the inline ``logsumexp - gold`` of JAX's VTM, QA and video-classification
    heads)."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, labels[:, None])[:, 0]
    return torch.mean(logz - gold)


def _diag_labels(sim: Tensor) -> Tensor:
    return torch.arange(sim.shape[0], device=sim.device)


def _sym_nce(sim: Tensor) -> Tensor:
    """Symmetric InfoNCE over a scaled similarity matrix with diagonal labels."""
    labels = _diag_labels(sim)
    return softmax_xent(sim, labels) + softmax_xent(sim.T, labels)


def _scaled_sim(a: Tensor, b: Tensor, logit_scale: Tensor) -> Tensor:
    """``(a @ b.T) * exp(logit_scale)`` with JAX's promotion: fp32 out."""
    return (a @ b.T).float() * torch.exp(logit_scale.float())


def _off_diagonal(x: Tensor) -> Tensor:
    """Rows of a square [b, b, ...] without their diagonal entry: [b, b-1, ...].

    A gather of the columns j + (j >= i), not a boolean mask: a mask's
    output size is read back by the host, which a CUDA graph cannot hold."""
    b = x.shape[0]
    j = torch.arange(b - 1, device=x.device)
    cols = j[None, :] + (j[None, :] >= torch.arange(b, device=x.device)[:, None]).long()
    cols = cols.reshape(b, b - 1, *([1] * (x.dim() - 2))).expand(b, b - 1, *x.shape[2:])
    return torch.gather(x, 1, cols)


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
    return softmax_xent(torch.cat([pos, hard_t2v], dim=-1), labels) + softmax_xent(
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
    return softmax_xent(t2v, labels) + softmax_xent(v2t, labels)


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
        softmax_xent(v2t.T, labels)
        + softmax_xent(v2t_2.T, labels)
        + softmax_xent(pooled, zero_labels)
        + softmax_xent(pooled_2, zero_labels)
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
# Masked-modeling / matching heads (HD-VILA, LF-VILA)
# ---------------------------------------------------------------------------


def global_ratio(numerator: Tensor, count: Tensor) -> Tensor:
    """``numerator / max(count, 1)`` over the global batch: in a group of N
    ranks, this rank's ``numerator`` times N over the count summed over
    ranks, a per-rank term whose mean over ranks (and whose gradient's) is
    the global mean (``parallel/mesh.py``). Without a group, the local mean."""
    if current_mesh() is None:
        return numerator / count.clamp_min(1)
    return numerator / all_reduce_sum(count).clamp_min(1) * world_size()


def _masked_xent_flat(logits: Tensor, labels: Tensor, ignore_index: int = -100,
                      global_count: bool = False) -> Tensor:
    """Mean CE over rows whose label != ignore_index (torch CrossEntropyLoss),
    fp32; 0 when every row is ignored. ``global_count``: over the rows of
    every rank (:func:`global_ratio`)."""
    logits = logits.float()
    valid = labels != ignore_index
    safe = torch.where(valid, labels, torch.zeros_like(labels))
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, safe[:, None])[:, 0]
    per = torch.where(valid, logz - gold, torch.zeros_like(logz))
    if global_count:
        return global_ratio(per.sum(), valid.sum())
    return per.sum() / valid.sum().clamp_min(1)


def mlm_loss(logits: Tensor, labels: Tensor, ignore_index: int = -100) -> Tensor:
    """Masked-LM cross-entropy averaged over the non-ignored positions of the
    global batch."""
    vocab = logits.shape[-1]
    return _masked_xent_flat(logits.reshape(-1, vocab), labels.reshape(-1), ignore_index, global_count=True)


def itm_loss(logits: Tensor, labels: Tensor) -> Tensor:
    """Image/video-text matching cross-entropy (2-way logits)."""
    return softmax_xent(logits, labels)


def label_smoothing_xent(logits: Tensor, labels: Tensor, smoothing: float = 0.1) -> Tensor:
    """Label-smoothed cross-entropy (LF-VILA open-ended QA head,
    ``LF-VILA/src/models/text_encoder.py:311-314``)."""
    logprobs = torch.log_softmax(logits.float(), dim=-1)
    nll = -torch.gather(logprobs, -1, labels[:, None])[:, 0]
    smooth = -logprobs.mean(dim=-1)
    return torch.mean((1.0 - smoothing) * nll + smoothing * smooth)


def mtc_permutations(batch: int, m: int, count: int, generator: Optional[torch.Generator] = None,
                     device=None) -> Tensor:
    """The first ``count`` entries of an independent random permutation of
    range(m) for each of ``batch`` rows: [batch, count] int64."""
    return torch.rand(batch, m, generator=generator, device=device).argsort(dim=-1)[:, :count]


def mtc_loss(
    video_local_feat: Tensor,  # [B, M, C], L2-normalized clip-level features
    text_local_feat: Tensor,  # [B, M, C]
    generator: Optional[torch.Generator] = None,
    num_key: int = 2,
    num_value: int = 2,
    num_other_neg: int = 3,
    temp: float = 0.05,
    indices: Optional[tuple] = None,  # (key_idx [B, nk], value_idx [B, nv], other_idx [B])
) -> Tensor:
    """Multimodal Temporal Contrastive loss (LF-VILA's ``ct_time_loss``, ref
    ``LF-VILA/src/models/lfvila_pretrain.py:111-151``).

    Random key clips of one modality are matched against random value clips
    of the other; the label is the temporally nearest value clip, exact
    first-vs-last ties are -100 (ignored), and ``num_other_neg`` rolled
    cross-batch clips extend the negative pool (shift 0, the un-rolled sample
    itself, included, as the reference does). The clips are ``indices`` when
    given, else drawn from ``generator`` (each rank draws its own rows'). In
    a group, features and clip indices are gathered over ranks and the
    rolled negatives cross them: every rank computes the global loss."""
    b, m, _ = video_local_feat.shape
    device = video_local_feat.device
    if indices is not None:
        key_idx, value_idx, other_idx = (None if t is None else torch.as_tensor(t, device=device).long()
                                         for t in indices)
    else:
        key_idx = mtc_permutations(b, m, num_key, generator, device)
        value_idx = mtc_permutations(b, m, num_value, generator, device)
        other_idx = mtc_permutations(b, m, 1, generator, device)[:, 0]
    if current_mesh() is not None:
        video_local_feat, text_local_feat = gather_rows(video_local_feat), gather_rows(text_local_feat)
        key_idx, value_idx, other_idx = gather_rows(key_idx), gather_rows(value_idx), gather_rows(other_idx)
        b = video_local_feat.shape[0]

    def gather(feats, idx):
        return torch.take_along_dim(feats, idx[..., None], dim=1)

    text_key, video_value = gather(text_local_feat, key_idx), gather(video_local_feat, value_idx)
    video_key, text_value = gather(video_local_feat, key_idx), gather(text_local_feat, value_idx)
    if num_other_neg > 0:
        vid_other = gather(video_local_feat, other_idx[:, None])[:, 0]
        txt_other = gather(text_local_feat, other_idx[:, None])[:, 0]
        vid_neg = torch.stack([torch.roll(vid_other, x, dims=0) for x in range(num_other_neg)], dim=1)
        txt_neg = torch.stack([torch.roll(txt_other, x, dims=0) for x in range(num_other_neg)], dim=1)
        video_value = torch.cat([video_value, vid_neg], dim=1)
        text_value = torch.cat([text_value, txt_neg], dim=1)

    sim_t2v = torch.einsum("bkc,bvc->bkv", text_key, video_value).reshape(b * num_key, -1) / temp
    sim_v2t = torch.einsum("bkc,bvc->bkv", video_key, text_value).reshape(b * num_key, -1) / temp

    minus = (value_idx[:, None, :] - key_idx[:, :, None]).abs()  # [B, nk, nv]
    labels = minus.argmin(dim=-1).reshape(-1)  # the first nearest
    ties = (minus[:, :, 0] == minus[:, :, -1]).reshape(-1)
    labels = torch.where(ties, torch.full_like(labels, -100), labels)
    return _masked_xent_flat(sim_t2v, labels) + _masked_xent_flat(sim_v2t, labels)


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


_NUM_FEATURES = {"pair_temp": 2, "pair_scale": 2, "quad_scale": 4}


def build_loss_fn(loss_name: str, **static_kwargs) -> Callable:
    """Look up a loss by its reference class name, with static kwargs (temp,
    margin, hard_negative_num, ...) bound; the result carries
    ``signature_kind``. It takes the local features and computes the loss of
    the global batch: in a group it gathers them over ranks first."""
    if loss_name not in LOSS_REGISTRY:
        raise KeyError(f"unknown loss {loss_name!r}; known: {sorted(LOSS_REGISTRY)}")
    fn, kind = LOSS_REGISTRY[loss_name]
    n = _NUM_FEATURES[kind]

    def on_global_batch(*args, **kwargs):
        return fn(*(gather_rows(a) for a in args[:n]), *args[n:], **{**static_kwargs, **kwargs})

    bound = functools.update_wrapper(on_global_batch, fn)
    bound.signature_kind = kind  # type: ignore[attr-defined]
    return bound
