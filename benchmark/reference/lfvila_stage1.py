"""Plain LF-VILA stage 1: the HTWA Swin3D video encoder, the hierarchical
BERT-large text encoder, the stage-1 pretraining losses, and the retrieval
towers, float32.

Written from LF-VILA's ``src/models/video_encoder.py`` (3-D shifted windows
with a relative-position bias, growing temporal windows, spatial-only
shifts, PatchMerging, stochastic depth), ``text_encoder.py`` and
``lfvila_pretrain.py`` / ``lfvila_retrieval.py`` (per-sentence BERT layers,
sentence embeddings, a mean-CLS token, global layers; global InfoNCE and the
multimodal temporal contrastive loss), following the port's plain path where
the reference's shipped code decides a detail (the local branch returns the
global map; clip draws and dropout masks come from one generator in the
forward's order, so this file draws the same ones from the same seed).
Windows are attended one by one. Parameters carry the port's names.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F

from benchmark.reference.plain import (
    AdamW,
    Precision,
    fake_fp8,
    l2_normalize,
    layer_norm,
    symmetric_nce,
    warmup_cosine,
)
from benchmark.weights import Leaf

IMAGENET_MEAN = (0.485, 0.456, 0.406)
IMAGENET_STD = (0.229, 0.224, 0.225)
NO_DECAY = ("bias", "layer_norm", "layernorm", "_norm", "norm_", "logit_scale", "pos_embed",
            "position_embedding", "relative_position_bias")


# ---------------------------------------------------------------- parameters

def _swin_leaves(v: dict) -> list[tuple[str, tuple, str]]:
    C0, heads, depths = v["embed_dim"], v["num_heads"], v["depths"]
    pt, ph, pw = v["patch_size"]
    out = [("video_encoder.patch_embed.proj.weight", (C0, 3, pt, ph, pw), "dense5"),
           ("video_encoder.patch_embed.proj.bias", (C0,), "bias")]
    channels = C0
    for i, depth in enumerate(depths):
        wd, wh, ww = v["window_size"][i]
        if i == _local_at(v):
            p = "video_encoder.local_feat_proj"
            out += [(f"{p}.norm.weight", (4 * channels,), "norm"), (f"{p}.norm.bias", (4 * channels,), "bias"),
                    (f"{p}.reduction.weight", (2 * C0 * 4, 4 * channels), "dense"),
                    ("video_encoder.norm_local.weight", (C0 * 8,), "norm"),
                    ("video_encoder.norm_local.bias", (C0 * 8,), "bias")]
        dim = C0 * 2 ** v["stages"][i]
        table = (2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1)
        for b in range(depth):
            p = f"video_encoder.layers_{i}_blocks_{b}"
            out += [(f"{p}.norm1.weight", (dim,), "norm"), (f"{p}.norm1.bias", (dim,), "bias"),
                    (f"{p}.attn.qkv.weight", (3 * dim, dim), "dense"), (f"{p}.attn.qkv.bias", (3 * dim,), "bias"),
                    (f"{p}.attn.proj.weight", (dim, dim), "dense"), (f"{p}.attn.proj.bias", (dim,), "bias"),
                    (f"{p}.attn.relative_position_bias_table", (table, heads[i]), "embed"),
                    (f"{p}.norm2.weight", (dim,), "norm"), (f"{p}.norm2.bias", (dim,), "bias"),
                    (f"{p}.mlp_fc1.weight", (4 * dim, dim), "dense"), (f"{p}.mlp_fc1.bias", (4 * dim,), "bias"),
                    (f"{p}.mlp_fc2.weight", (dim, 4 * dim), "dense"), (f"{p}.mlp_fc2.bias", (dim,), "bias")]
        channels = dim
        if i in v["downsample_stages"]:
            p = f"video_encoder.layers_{i}_downsample"
            out += [(f"{p}.norm.weight", (4 * dim,), "norm"), (f"{p}.norm.bias", (4 * dim,), "bias"),
                    (f"{p}.reduction.weight", (2 * dim, 4 * dim), "dense")]
            channels = 2 * dim
    out += [("video_encoder.norm.weight", (channels,), "norm"), ("video_encoder.norm.bias", (channels,), "bias")]
    return out


def _bert_leaves(t: dict, layers: int) -> list[tuple[str, tuple, str]]:
    h, inter = t["hidden_size"], t["intermediate_size"]
    e = "text_encoder.embeddings"
    out = [(f"{e}.word_embeddings.weight", (t["vocab_size"], h), "embed"),
           (f"{e}.position_embeddings.weight", (t["max_position_embeddings"], h), "embed"),
           (f"{e}.token_type_embeddings.weight", (t["type_vocab_size"], h), "embed"),
           (f"{e}.LayerNorm.weight", (h,), "norm"), (f"{e}.LayerNorm.bias", (h,), "bias")]
    for i in range(layers):
        p = f"text_encoder.encoder.layer_{i}"
        for n in ("query", "key", "value"):
            out += [(f"{p}.attention_self.{n}.weight", (h, h), "dense"), (f"{p}.attention_self.{n}.bias", (h,), "bias")]
        out += [(f"{p}.attention_output_dense.weight", (h, h), "dense"), (f"{p}.attention_output_dense.bias", (h,), "bias"),
                (f"{p}.attention_output_LayerNorm.weight", (h,), "norm"),
                (f"{p}.attention_output_LayerNorm.bias", (h,), "bias"),
                (f"{p}.intermediate_dense.weight", (inter, h), "dense"), (f"{p}.intermediate_dense.bias", (inter,), "bias"),
                (f"{p}.output_dense.weight", (h, inter), "dense"), (f"{p}.output_dense.bias", (h,), "bias"),
                (f"{p}.output_LayerNorm.weight", (h,), "norm"), (f"{p}.output_LayerNorm.bias", (h,), "bias")]
    s = "sent_embedding"
    out += [(f"{s}.position_embeddings.weight", (t["max_position_embeddings"], h), "embed"),
            (f"{s}.segment_embeddings.weight", (t["type_vocab_size"], h), "embed"),
            (f"{s}.norm.weight", (h,), "norm"), (f"{s}.norm.bias", (h,), "bias")]
    return out


def leaves(cfg: dict, kind: str) -> list[Leaf]:
    """Every parameter of the stage-1 pretraining model (``kind`` "train")
    or of the retrieval towers ("serve"), with its initial mean and std:
    dense and conv kernels N(0, 1/fan_in), biases, embeddings and bias
    tables N(0, 0.02), norm scales 1 + N(0, 0.02)."""
    t = cfg["text"]
    heads = cfg["projections"][kind]
    spec = _swin_leaves(cfg["video"]) + _bert_leaves(t, t["stage_bounds"][1])
    for name in heads:
        spec += [(f"{name}.weight", (t["hidden_size"], t["hidden_size"]), "dense"),
                 (f"{name}.bias", (t["hidden_size"],), "bias")]
    out = []
    for name, shape, kind in spec:
        if kind in ("dense", "dense5"):
            out.append(Leaf(name, shape, 0.0, math.prod(shape[1:]) ** -0.5))
        elif kind == "norm":
            out.append(Leaf(name, shape, 1.0, 0.02))
        else:
            out.append(Leaf(name, shape, 0.0, 0.02))
    return out


# ---------------------------------------------------------------- Swin3D

def _local_at(v: dict):
    return next((i for i, w in enumerate(v["window_size"]) if w[0] > v["local_window"]), None)


def _clip_window(dims, window, shift):
    window, shift = list(window), list(shift)
    for i, (xs, ws) in enumerate(zip(dims, window)):
        if xs <= ws:
            window[i], shift[i] = xs, 0
    return tuple(window), tuple(shift)


def _relative_index(window) -> np.ndarray:
    wd, wh, ww = window
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij")).reshape(3, -1)
    rel = (coords[:, :, None] - coords[:, None, :]).transpose(1, 2, 0)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return rel.sum(-1)


def _shift_mask(dims, window, shift) -> np.ndarray:
    """[nW, N, N]: 0 within a region of the rolled map, -100 across regions."""
    D, H, W = dims
    img = np.zeros((D, H, W), np.float32)
    cnt = 0
    for d in (slice(-window[0]), slice(-window[0], -shift[0] or None), slice(-shift[0] or D, None)):
        for h in (slice(-window[1]), slice(-window[1], -shift[1] or None), slice(-shift[1] or H, None)):
            for w in (slice(-window[2]), slice(-window[2], -shift[2] or None), slice(-shift[2] or W, None)):
                img[d, h, w] = cnt
                cnt += 1
    wd, wh, ww = window
    x = img.reshape(D // wd, wd, H // wh, wh, W // ww, ww).transpose(0, 2, 4, 1, 3, 5).reshape(-1, wd * wh * ww)
    return np.where(x[:, None, :] != x[:, :, None], -100.0, 0.0).astype(np.float32)


def _partition(x, window):
    B, D, H, W, C = x.shape
    wd, wh, ww = window
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C).permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, C)


def _reverse(w, window, B, D, H, W):
    wd, wh, ww = window
    x = w.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, -1).permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, -1)


def _drop(x, rate, gen, shape=None):
    """Dropout: the keep mask drawn as ``rand(shape) < 1 - rate``."""
    if gen is None or rate <= 0.0:
        return x
    keep = torch.rand(shape or x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _swin_block(x, p, pre, window, shift, heads, drop_path, gen, prec):
    B, D, H, W, C = x.shape
    full = window
    window, shift = _clip_window((D, H, W), window, shift)
    if D % window[0] or H % window[1] or W % window[2]:
        raise ValueError(f"the reference tiles {(D, H, W)} by {window} without padding")
    lin = lambda h, n: prec.linear(h, p[f"{pre}.{n}.weight"], p[f"{pre}.{n}.bias"])  # noqa: E731
    h = layer_norm(x, p, f"{pre}.norm1", 1e-5)
    shifted = any(s > 0 for s in shift)
    if shifted:
        h = torch.roll(h, shifts=(-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))
    win = _partition(h, window)
    Bn, N, _ = win.shape
    qkv = lin(win, "attn.qkv").view(Bn, N, 3, heads, C // heads).permute(2, 0, 3, 1, 4)
    q, k, v = qkv[0], qkv[1], qkv[2]
    # a clipped window takes the first N rows of the full window's index
    idx = torch.from_numpy(_relative_index(full)[:N, :N].reshape(-1)).to(x.device)
    bias = p[f"{pre}.attn.relative_position_bias_table"][idx].view(N, N, heads).permute(2, 0, 1)
    scores = prec.matmul(q, k.transpose(-1, -2)) * (C // heads) ** -0.5 + bias
    if shifted:
        mask = torch.from_numpy(_shift_mask((D, H, W), window, shift)).to(x.device)
        nW = mask.shape[0]
        scores = (scores.view(Bn // nW, nW, heads, N, N) + mask[None, :, None]).view(Bn, heads, N, N)
    out = prec.matmul(torch.softmax(scores, dim=-1), v).transpose(1, 2).reshape(Bn, N, C)
    out = _reverse(lin(out, "attn.proj"), window, B, D, H, W)
    if shifted:
        out = torch.roll(out, shifts=shift, dims=(1, 2, 3))
    x = x + _drop(out, drop_path, gen, (B,) + (1,) * 4)
    y = lin(F.gelu(lin(layer_norm(x, p, f"{pre}.norm2", 1e-5), "mlp_fc1")), "mlp_fc2")
    return x + _drop(y, drop_path, gen, (B,) + (1,) * 4)


def _merge(x, p, pre, prec):
    x = torch.cat([x[:, :, 0::2, 0::2], x[:, :, 1::2, 0::2], x[:, :, 0::2, 1::2], x[:, :, 1::2, 1::2]], dim=-1)
    return prec.linear(layer_norm(x, p, f"{pre}.norm", 1e-5), p[f"{pre}.reduction.weight"])


def swin(p: dict, v: dict, frames: torch.Tensor, gen, prec: Precision, training: bool) -> torch.Tensor:
    """uint8 [B, N, H, W, 3] -> the final map [B, D, H', W', C]."""
    mean = torch.tensor(IMAGENET_MEAN, device=frames.device)
    std = torch.tensor(IMAGENET_STD, device=frames.device)
    x = ((frames.float() / 255.0 - mean) / std).permute(0, 4, 1, 2, 3)
    w = p["video_encoder.patch_embed.proj.weight"]
    if prec.name == "fp8":
        x, w = fake_fp8(x), fake_fp8(w)
    x = F.conv3d(x, w, p["video_encoder.patch_embed.proj.bias"], stride=tuple(v["patch_size"]))
    x = x.permute(0, 2, 3, 4, 1)
    rates = np.linspace(0, v["drop_path_rate"], sum(v["depths"]))
    k = 0
    for i, depth in enumerate(v["depths"]):
        window = tuple(v["window_size"][i])
        shift = [0 if v["temporal_no_shifting"] and j == 0 else s // 2 for j, s in enumerate(window)]
        for b in range(depth):
            pre = f"video_encoder.layers_{i}_blocks_{b}"
            x = _swin_block(x, p, pre, window, (0, 0, 0) if b % 2 == 0 else tuple(shift), v["num_heads"][i],
                            float(rates[k]) if training else 0.0, gen, prec)
            k += 1
        if i in v["downsample_stages"]:
            x = _merge(x, p, f"video_encoder.layers_{i}_downsample", prec)
    return layer_norm(x, p, "video_encoder.norm", 1e-5)


def clip_features(x: torch.Tensor, sample_clip: int) -> torch.Tensor:
    """[B, N, H, W, C] -> [B, sample_clip, C]: a (2, 3) max-pool with stride
    1 over each frame's map, then the mean over each clip's frames and tokens."""
    B, N, H, W, C = x.shape
    y = F.max_pool2d(x.reshape(B * N, H, W, C).permute(0, 3, 1, 2), (2, 3), stride=1).permute(0, 2, 3, 1)
    return y.reshape(B, sample_clip, N // sample_clip, -1, C).mean(dim=(2, 3))


# ---------------------------------------------------------------- BERT

def _bert_layer(h, p, i, mask, heads, rates, gen, prec):
    pre = f"text_encoder.encoder.layer_{i}"
    lin = lambda x, n: prec.linear(x, p[f"{pre}.{n}.weight"], p[f"{pre}.{n}.bias"])  # noqa: E731
    b, s, e = h.shape
    split = lambda x: x.view(b, s, heads, e // heads).transpose(1, 2)  # noqa: E731
    q, k, v = (split(lin(h, f"attention_self.{n}")) for n in ("query", "key", "value"))
    scores = prec.matmul(q, k.transpose(-1, -2)) * (e // heads) ** -0.5
    scores = scores.masked_fill(~mask[:, None, None, :], float("-inf"))
    attn_rate, rate = rates
    probs = _drop(torch.softmax(scores, dim=-1), attn_rate, gen)
    a = prec.matmul(probs, v).transpose(1, 2).reshape(b, s, e)
    h = layer_norm(h + _drop(lin(a, "attention_output_dense"), rate, gen), p, f"{pre}.attention_output_LayerNorm", 1e-12)
    out = lin(F.gelu(lin(h, "intermediate_dense"), approximate="tanh"), "output_dense")
    return layer_norm(h + _drop(out, rate, gen), p, f"{pre}.output_LayerNorm", 1e-12)


def text(p: dict, t: dict, ids: torch.Tensor, mask: torch.Tensor, gen, prec: Precision, training: bool):
    """[B, M, L] sentences -> (per-sentence hidden [B, M, L, C], paragraph
    hidden [B, 1 + M*L, C])."""
    rate = t["hidden_dropout_prob"] if training else 0.0
    rates = (t["attention_probs_dropout_prob"] if training else 0.0, rate)
    B, M, L = ids.shape
    e = "text_encoder.embeddings"
    flat = ids.reshape(B * M, L)
    h = (p[f"{e}.word_embeddings.weight"][flat] + p[f"{e}.position_embeddings.weight"][:L]
         + p[f"{e}.token_type_embeddings.weight"][0])
    h = _drop(layer_norm(h, p, f"{e}.LayerNorm", 1e-12), rate, gen)
    keep = mask.reshape(B * M, L) > 0
    lo, hi = t["stage_bounds"]
    for i in range(lo):
        h = _bert_layer(h, p, i, keep, t["num_attention_heads"], rates, gen, prec)
    local = h.reshape(B, M, L, -1)
    seg = torch.arange(M, device=ids.device).repeat_interleave(L)
    stream = (local.reshape(B, M * L, -1) + p["sent_embedding.position_embeddings.weight"][: M * L]
              + p["sent_embedding.segment_embeddings.weight"][seg])
    stream = _drop(layer_norm(stream, p, "sent_embedding.norm", 1e-12), rate, gen)
    cls = stream.reshape(B, M, L, -1)[:, :, 0].mean(dim=1)
    h = torch.cat([cls[:, None], stream], dim=1)
    keep = torch.cat([torch.ones(B, 1, dtype=torch.bool, device=ids.device), mask.reshape(B, M * L) > 0], dim=1)
    for i in range(lo, hi):
        h = _bert_layer(h, p, i, keep, t["num_attention_heads"], rates, gen, prec)
    return local, h


# ---------------------------------------------------------------- losses and step

def mtc(video, text_, gen, nk, nv, n_other, temp):
    """The multimodal temporal contrastive loss over clip features [B, M, C]."""
    b, m, _ = video.shape
    draw = lambda n: torch.rand(b, m, generator=gen, device=video.device).argsort(dim=-1)[:, :n]  # noqa: E731
    key, value, other = draw(nk), draw(nv), draw(1)[:, 0]
    take = lambda f, idx: torch.take_along_dim(f, idx[..., None], dim=1)  # noqa: E731
    t_key, v_val, v_key, t_val = take(text_, key), take(video, value), take(video, key), take(text_, value)
    v_other, t_other = take(video, other[:, None])[:, 0], take(text_, other[:, None])[:, 0]
    v_val = torch.cat([v_val, torch.stack([torch.roll(v_other, s, 0) for s in range(n_other)], 1)], 1)
    t_val = torch.cat([t_val, torch.stack([torch.roll(t_other, s, 0) for s in range(n_other)], 1)], 1)
    dist = (value[:, None, :] - key[:, :, None]).abs()
    labels = dist.argmin(dim=-1).reshape(-1)
    labels = torch.where((dist[:, :, 0] == dist[:, :, -1]).reshape(-1), torch.full_like(labels, -100), labels)
    t2v = torch.einsum("bkc,bvc->bkv", t_key, v_val).reshape(b * nk, -1) / temp
    v2t = torch.einsum("bkc,bvc->bkv", v_key, t_val).reshape(b * nk, -1) / temp
    xent = lambda s: F.cross_entropy(s, labels, ignore_index=-100, reduction="sum") / (labels != -100).sum().clamp_min(1)  # noqa: E731
    return xent(t2v) + xent(v2t)


def pretrain_loss(p: dict, cfg: dict, batch: dict, gen, prec: Precision) -> torch.Tensor:
    tr, v, t = cfg["training"], cfg["video"], cfg["text"]
    x = swin(p, v, batch["video_frames"], gen, prec, True)
    local, hidden = text(p, t, batch["text_ids"], batch["attention_mask"], gen, prec, True)
    clips = clip_features(x, cfg["sample_clip"])
    proj = lambda h, n: prec.linear(h, p[f"{n}.weight"], p[f"{n}.bias"])  # noqa: E731
    video_local = l2_normalize(proj(clips, "video_local_proj"))
    text_local = l2_normalize(proj(local[:, :, 0], "text_local_proj"))
    video_global = l2_normalize(proj(clips.mean(dim=1), "video_global_proj"))
    text_global = l2_normalize(proj(hidden[:, 0], "text_global_proj"))
    loss = tr["ct_global_loss_weight"] * symmetric_nce(video_global @ text_global.T / tr["temp"])
    return loss + tr["ct_time_loss_weight"] * mtc(video_local, text_local, gen, tr["num_key"], tr["num_value"],
                                                  tr["num_other_neg"], tr["time_temp"])


def decayed(names) -> set[str]:
    return {n for n, shape in names if len(shape) >= 2 and not any(s in n.lower() for s in NO_DECAY)}


def train(p: dict, cfg: dict, batches: list[dict], prec: Precision, seed_base: int = 0) -> dict:
    """The stage-1 pretraining step over ``batches`` in turn, from the
    weights ``p`` (trained in place); step s draws its dropout masks, drop
    paths and clips from a generator seeded ``seed_base + s``."""
    opt = cfg["optimizer"]
    adam = AdamW(p, decayed((n, t.shape) for n, t in p.items()), tuple(opt["betas"]), opt["eps"],
                 opt["weight_decay"], opt["grad_norm"])
    device = next(iter(p.values())).device
    losses, first = [], None
    for s, batch in enumerate(batches):
        gen = torch.Generator(device=device).manual_seed((seed_base + s) % (1 << 32))
        loss = pretrain_loss(p, cfg, batch, gen, prec)
        loss.backward()
        losses.append(loss.detach())
        grads = adam.step(warmup_cosine(opt["learning_rate"], opt["warmup_steps"], opt["num_train_steps"], s))
        if first is None:
            first = {n: torch.linalg.vector_norm(g) for n, g in grads.items()}
    return {"losses": torch.stack(losses), "grad_norms": first}


def features(p: dict, cfg: dict, batch: dict, prec: Precision) -> tuple[torch.Tensor, torch.Tensor]:
    """(video, text) features of the retrieval towers for a serving batch."""
    with torch.no_grad():
        x = swin(p, cfg["video"], batch["video_frames"], None, prec, False)
        video = l2_normalize(prec.linear(clip_features(x, cfg["sample_clip"]).mean(dim=1),
                                         p["video_global_proj.weight"], p["video_global_proj.bias"]))
        _, hidden = text(p, cfg["text"], batch["text_ids"], batch["attention_mask"], None, prec, False)
        txt = l2_normalize(prec.linear(hidden[:, 0], p["text_global_proj.weight"], p["text_global_proj.bias"]))
    return video, txt
