"""Plain HD-VILA stage 1: the hybrid two-resolution video encoder, the first
half of BERT-large, and the stage-1 ITC step, float32.

Written from HD-VILA's ``src/modeling/e2e_model.py`` (``extract_features``:
a full ResNet-50 over each clip's middle frame, a second ResNet-50 to stage
3 over the neighbour frames at a quarter of the size, the middle frame's
stage-3 map taken at every 4th pixel and inserted at ``T // 2``, a divided
space-time TimeSformer over the grid, the two branches fused by a 1x1
conv), ``resnet_mmdetection.py`` (pytorch-style bottlenecks, the stride on
the 3x3; ``norm_eval`` batch norm, an affine map over stored statistics;
``forward_to_stage``), ``timesformer.py`` (temporal attention at each grid
location, then spatial attention in each frame, then the MLP) and
``modeling_stage.py`` (stage-1 BERT, the masked mean of its tokens through
``pooler1``, ``t_proj`` and ``v_proj``, L2 norms, symmetric NCE at a fixed
temperature). Attention is written as explicit softmax products. Parameters
carry the port's names, so both sides take one set of weights.

Departures from the published model, each the port's:

- FrozenBN's ``mean`` and ``var`` are trained parameters here (AdamW moves
  them and the global clip norm counts their gradients); the published BN
  with ``norm_eval`` keeps them as fixed buffers.
- Frames arrive as uint8 and are standardized once, with the 0-255 ImageNet
  mean and std (the published data path normalizes on the host).
- BERT's GELU is the tanh form (flax's default); the grid encoders' and the
  TimeSformer's are exact.
- BERT's dropout masks come from one generator a step in the forward's
  order (the embeddings; then each layer's attention probabilities,
  attention output and feed-forward output), so this file draws the
  program's masks from the same seed. The video tower draws nothing.

So that a batch of 16 fits in float32, :func:`train` computes the video
features of every sample without a graph, runs the text tower and the loss
whole, and then backpropagates the loss's gradient with respect to those
features block by block, each block's features recomputed.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from benchmark.reference.plain import AdamW, Precision, fake_fp8, l2_normalize, layer_norm, symmetric_nce
from benchmark.weights import Leaf

IMAGENET_MEAN_255 = (123.675, 116.28, 103.53)
IMAGENET_STD_255 = (58.395, 57.12, 57.375)
NO_DECAY = ("bias", "layer_norm", "layernorm", "_norm", "norm_", "logit_scale")
BN_EPS = 1e-5
BLOCK = 2  # samples whose video features are recomputed with a graph at once


# ---------------------------------------------------------------- parameters

def _bn_leaves(pre: str, c: int) -> list[tuple[str, tuple, str]]:
    return [(f"{pre}.scale", (c,), "norm"), (f"{pre}.bias", (c,), "bias"), (f"{pre}.mean", (c,), "bias"),
            (f"{pre}.var", (c,), "norm")]


def resnet_stages(r: dict, stages: int) -> list[list[tuple[str, int, int, int, bool]]]:
    """Per stage of the first ``stages``, (name, in channels, planes, stride,
    downsample) of each of its bottlenecks."""
    out, inplanes = [], r["base_channels"]
    for s, n in enumerate(r["stage_blocks"][:stages]):
        planes = r["base_channels"] * 2 ** s
        out.append([])
        for b in range(n):
            out[-1].append((f"layer{s + 1}_{b}", inplanes, planes, 2 if b == 0 and s > 0 else 1, b == 0))
            inplanes = planes * r["expansion"]
    return out


def _resnet_leaves(pre: str, r: dict, stages: int) -> list[tuple[str, tuple, str]]:
    base, e = r["base_channels"], r["expansion"]
    out = [(f"{pre}.conv1.weight", (base, 3, 7, 7), "dense")] + _bn_leaves(f"{pre}.bn1", base)
    for name, cin, planes, _, down in (b for stage in resnet_stages(r, stages) for b in stage):
        p = f"{pre}.{name}"
        for i, (ci, co, k) in enumerate(((cin, planes, 1), (planes, planes, 3), (planes, planes * e, 1)), 1):
            out += [(f"{p}.conv{i}.weight", (co, ci, k, k), "dense")] + _bn_leaves(f"{p}.bn{i}", co)
        if down:
            out += [(f"{p}.downsample_conv.weight", (planes * e, cin, 1, 1), "dense")]
            out += _bn_leaves(f"{p}.downsample_bn", planes * e)
    return out


def stage_channels(r: dict) -> list[int]:
    return [r["base_channels"] * 2 ** s * r["expansion"] for s in range(len(r["stage_blocks"]))]


def _video_leaves(cfg: dict) -> list[tuple[str, tuple, str]]:
    r, ts = cfg["resnet"], cfg["timesformer"]
    d, (gh, gw) = ts["hidden_size"], ts["grid"]
    c3, c4 = stage_channels(r)[2:]
    out = _resnet_leaves("encoder.cnn", r, len(r["stage_blocks"])) + _resnet_leaves("encoder.cnn_low", r,
                                                                                     r["low_res_stages"])
    out += [("encoder.grid_encoder_conv.weight", (d, c4, 1, 1), "dense"),
            ("encoder.grid_encoder_low_conv.weight", (d, c3, 1, 1), "dense"),
            ("encoder.grid_encoder_combine_conv.weight", (d, 2 * d, 1, 1), "dense"),
            ("encoder.timesformer.pos_embed", (1, gh * gw, d), "embed"),
            ("encoder.timesformer.time_embed", (1, cfg["frames"], d), "embed")]
    hid = int(d * ts["mlp_ratio"])
    for i in range(ts["depth"]):
        p = f"encoder.timesformer.blocks_{i}"
        dense = [("temporal_attn.qkv", 3 * d, d), ("temporal_attn.proj", d, d), ("temporal_fc", d, d),
                 ("attn.qkv", 3 * d, d), ("attn.proj", d, d), ("mlp_fc1", hid, d), ("mlp_fc2", d, hid)]
        for n in ("temporal_norm1", "norm1", "norm2"):
            out += [(f"{p}.{n}.weight", (d,), "norm"), (f"{p}.{n}.bias", (d,), "bias")]
        for n, o, i_ in dense:
            out += [(f"{p}.{n}.weight", (o, i_), "dense"), (f"{p}.{n}.bias", (o,), "bias")]
    return out


def _text_leaves(t: dict) -> list[tuple[str, tuple, str]]:
    h, inter = t["hidden_size"], t["intermediate_size"]
    e = "transformer.bert_model.bert.embeddings"
    out = [(f"{e}.word_embeddings.weight", (t["vocab_size"], h), "embed"),
           (f"{e}.position_embeddings.weight", (t["max_position_embeddings"], h), "embed"),
           (f"{e}.token_type_embeddings.weight", (t["type_vocab_size"], h), "embed"),
           (f"{e}.LayerNorm.weight", (h,), "norm"), (f"{e}.LayerNorm.bias", (h,), "bias")]
    for i in range(t["stage_layers"]):
        p = f"transformer.bert_model.bert.encoder.layer_{i}"
        dense = [("attention_self.query", h, h), ("attention_self.key", h, h), ("attention_self.value", h, h),
                 ("attention_output_dense", h, h), ("intermediate_dense", inter, h), ("output_dense", h, inter)]
        for n, o, i_ in dense:
            out += [(f"{p}.{n}.weight", (o, i_), "dense"), (f"{p}.{n}.bias", (o,), "bias")]
        for n in ("attention_output_LayerNorm", "output_LayerNorm"):
            out += [(f"{p}.{n}.weight", (h,), "norm"), (f"{p}.{n}.bias", (h,), "bias")]
    for n in ("transformer.bert_model.pooler1.dense", "transformer.t_proj", "transformer.v_proj"):
        out += [(f"{n}.weight", (h, h), "dense"), (f"{n}.bias", (h,), "bias")]
    return out


def leaves(cfg: dict, kind: str = "train") -> list[Leaf]:
    """Every parameter of the stage-1 pretraining model with its initial
    mean and std: conv and dense kernels N(0, 1/fan_in); biases, embeddings
    and FrozenBN means N(0, 0.02); norm scales, FrozenBN scales and FrozenBN
    variances 1 + N(0, 0.02) (a variance 50 standard deviations from 0)."""
    out = []
    for name, shape, init in _video_leaves(cfg) + _text_leaves(cfg["text"]):
        if init == "dense":
            out.append(Leaf(name, shape, 0.0, math.prod(shape[1:]) ** -0.5))
        elif init == "norm":
            out.append(Leaf(name, shape, 1.0, 0.02))
        else:
            out.append(Leaf(name, shape, 0.0, 0.02))
    return out


def decayed(names) -> set[str]:
    """The leaves AdamW decays: two or more dims, none of the no-decay
    substrings in the name (``GenericTrainer``'s default rule)."""
    return {n for n, shape in names if len(shape) >= 2 and not any(s in n.lower() for s in NO_DECAY)}


# ---------------------------------------------------------------- ResNet

def _conv(x, w, stride, prec):
    if prec.name == "fp8":
        x, w = fake_fp8(x), fake_fp8(w)
    return F.conv2d(x, w, None, stride, w.shape[-1] // 2)


def _bn(x, p, pre):
    """``norm_eval`` batch norm, (x - mean) / sqrt(var + eps) * scale + bias,
    folded as eval-mode batch norm computes it: x * a + (bias - mean * a)."""
    a = torch.rsqrt(p[f"{pre}.var"] + BN_EPS) * p[f"{pre}.scale"]
    return x * a[:, None, None] + (p[f"{pre}.bias"] - p[f"{pre}.mean"] * a)[:, None, None]


def _bottleneck(x, p, pre, stride, down, prec):
    out = F.relu(_bn(_conv(x, p[f"{pre}.conv1.weight"], 1, prec), p, f"{pre}.bn1"))
    out = F.relu(_bn(_conv(out, p[f"{pre}.conv2.weight"], stride, prec), p, f"{pre}.bn2"))
    out = _bn(_conv(out, p[f"{pre}.conv3.weight"], 1, prec), p, f"{pre}.bn3")
    identity = _bn(_conv(x, p[f"{pre}.downsample_conv.weight"], stride, prec), p, f"{pre}.downsample_bn") if down else x
    return F.relu(out + identity)


def resnet(x, p, pre, r, stages, prec) -> list[torch.Tensor]:
    """[N, 3, H, W] -> the output of each of the first ``stages`` stages."""
    x = F.relu(_bn(_conv(x, p[f"{pre}.conv1.weight"], 2, prec), p, f"{pre}.bn1"))
    x = F.max_pool2d(x, 3, 2, 1)
    outs = []
    for stage in resnet_stages(r, stages):
        for name, _, _, stride, down in stage:
            x = _bottleneck(x, p, f"{pre}.{name}", stride, down, prec)
        outs.append(x)
    return outs


# ---------------------------------------------------------------- TimeSformer

def _attend(x, p, pre, heads, prec):
    """Self-attention over the second-to-last axis of [..., N, C]."""
    *lead, n, c = x.shape
    d = c // heads
    qkv = prec.linear(x, p[f"{pre}.qkv.weight"], p[f"{pre}.qkv.bias"]).reshape(-1, n, 3, heads, d)
    q, k, v = qkv.permute(2, 0, 3, 1, 4)
    probs = torch.softmax(prec.matmul(q, k.transpose(-1, -2)) * d ** -0.5, dim=-1)
    out = prec.matmul(probs, v).transpose(1, 2).reshape(*lead, n, c)
    return prec.linear(out, p[f"{pre}.proj.weight"], p[f"{pre}.proj.bias"])


def _divided_block(x, p, pre, heads, prec):
    """[N, T, HW, C]: attention over T at each location, then over HW in each frame, then the MLP."""
    lin = lambda h, n: prec.linear(h, p[f"{pre}.{n}.weight"], p[f"{pre}.{n}.bias"])  # noqa: E731
    res_t = _attend(layer_norm(x.transpose(1, 2), p, f"{pre}.temporal_norm1", 1e-6), p, f"{pre}.temporal_attn",
                    heads, prec).transpose(1, 2)
    x = x + lin(res_t, "temporal_fc")
    x = x + _attend(layer_norm(x, p, f"{pre}.norm1", 1e-6), p, f"{pre}.attn", heads, prec)
    return x + lin(F.gelu(lin(layer_norm(x, p, f"{pre}.norm2", 1e-6), "mlp_fc1")), "mlp_fc2")


def timesformer(x, p, ts, prec) -> torch.Tensor:
    """[N, T, C, H, W] grids at the trained grid size -> [N, T, HW, C]."""
    N, T, C, H, W = x.shape
    if [H, W] != list(ts["grid"]) or T != p["encoder.timesformer.time_embed"].shape[1]:
        raise ValueError(f"the reference runs the trained grid {ts['grid']} x {T} frames, not {(H, W)}")
    x = x.permute(0, 1, 3, 4, 2).reshape(N, T, H * W, C)
    x = x + p["encoder.timesformer.pos_embed"][None] + p["encoder.timesformer.time_embed"][:, :, None]
    for i in range(ts["depth"]):
        x = _divided_block(x, p, f"encoder.timesformer.blocks_{i}", ts["heads"], prec)
    return x


# ---------------------------------------------------------------- towers and loss

def _standardize(frames: torch.Tensor) -> torch.Tensor:
    mean = torch.tensor(IMAGENET_MEAN_255, device=frames.device)[:, None, None]
    std = torch.tensor(IMAGENET_STD_255, device=frames.device)[:, None, None]
    return (frames.float() - mean) / std


def _conv_gelu(x, p, name, prec):
    return F.gelu(_conv(x, p[f"encoder.{name}.weight"], 1, prec))


def video_features(p: dict, cfg: dict, img_middle: torch.Tensor, img_other: torch.Tensor,
                   prec: Precision) -> torch.Tensor:
    """u8 middles [B, clips, 3, H, W] and neighbours [B, clips, T-1, 3, H/4,
    W/4] -> the fused grid's mean over clips and locations [B, C], the input
    of ``v_proj``."""
    r, ts = cfg["resnet"], cfg["timesformer"]
    B, clips = img_middle.shape[:2]
    middle = _standardize(img_middle.reshape(-1, *img_middle.shape[2:]))
    stages = resnet(middle, p, "encoder.cnn", r, len(r["stage_blocks"]), prec)
    grid_hi = F.gelu(F.max_pool2d(_conv(stages[-1], p["encoder.grid_encoder_conv.weight"], 1, prec), 2, 2))
    mid3 = _conv_gelu(stages[-2][:, :, ::cfg["low_res_factor"], ::cfg["low_res_factor"]], p, "grid_encoder_low_conv",
                      prec)
    other = _standardize(img_other.reshape(-1, *img_other.shape[3:]))
    other = _conv_gelu(resnet(other, p, "encoder.cnn_low", r, r["low_res_stages"], prec)[-1], p,
                       "grid_encoder_low_conv", prec)
    other = other.reshape(B * clips, -1, *other.shape[1:])
    half = cfg["frames"] // 2
    grids = torch.cat([other[:, :half], mid3[:, None], other[:, half:]], dim=1)
    temporal = timesformer(grids, p, ts, prec)[:, half]  # [N, HW, C]
    temporal = temporal.transpose(1, 2).reshape(grid_hi.shape)
    fused = _conv_gelu(torch.cat([grid_hi, temporal], dim=1), p, "grid_encoder_combine_conv", prec)
    return fused.reshape(B, clips, *fused.shape[1:]).mean(dim=(1, 3, 4))


def _drop(x, rate, gen):
    """Dropout: the keep mask drawn as ``rand(x.shape) < 1 - rate``."""
    if gen is None or rate <= 0.0:
        return x
    keep = torch.rand(x.shape, generator=gen, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


def _bert_layer(h, p, pre, keep, t, gen, prec):
    lin = lambda x, n: prec.linear(x, p[f"{pre}.{n}.weight"], p[f"{pre}.{n}.bias"])  # noqa: E731
    b, s, e = h.shape
    heads = t["num_attention_heads"]
    split = lambda x: x.view(b, s, heads, e // heads).transpose(1, 2)  # noqa: E731
    q, k, v = (split(lin(h, f"attention_self.{n}")) for n in ("query", "key", "value"))
    scores = (prec.matmul(q, k.transpose(-1, -2)) * (e // heads) ** -0.5).masked_fill(~keep[:, None, None], -math.inf)
    probs = _drop(torch.softmax(scores, dim=-1), t["attention_probs_dropout_prob"], gen)
    a = prec.matmul(probs, v).transpose(1, 2).reshape(b, s, e)
    rate, eps = t["hidden_dropout_prob"], t["layer_norm_eps"]
    h = layer_norm(h + _drop(lin(a, "attention_output_dense"), rate, gen), p, f"{pre}.attention_output_LayerNorm", eps)
    out = lin(F.gelu(lin(h, "intermediate_dense"), approximate="tanh"), "output_dense")
    return layer_norm(h + _drop(out, rate, gen), p, f"{pre}.output_LayerNorm", eps)


def text_features(p: dict, t: dict, ids: torch.Tensor, mask: torch.Tensor, gen, prec: Precision) -> torch.Tensor:
    """Ids and mask [B, L] -> L2-normalized ITC text features [B, C]: the
    stage-1 layers, the masked mean of their output, ``pooler1`` (dense,
    tanh), ``t_proj``."""
    e = "transformer.bert_model.bert.embeddings"
    h = (p[f"{e}.word_embeddings.weight"][ids] + p[f"{e}.position_embeddings.weight"][: ids.shape[1]]
         + p[f"{e}.token_type_embeddings.weight"][0])
    h = _drop(layer_norm(h, p, f"{e}.LayerNorm", t["layer_norm_eps"]), t["hidden_dropout_prob"], gen)
    keep = mask > 0
    for i in range(t["stage_layers"]):
        h = _bert_layer(h, p, f"transformer.bert_model.bert.encoder.layer_{i}", keep, t, gen, prec)
    m = keep[..., None].float()
    mean = (h * m).sum(dim=1) / m.sum(dim=1).clamp_min(1.0)
    pooled = torch.tanh(prec.linear(mean, p["transformer.bert_model.pooler1.dense.weight"],
                                    p["transformer.bert_model.pooler1.dense.bias"]))
    return l2_normalize(prec.linear(pooled, p["transformer.t_proj.weight"], p["transformer.t_proj.bias"]))


def itc_loss(p: dict, cfg: dict, video: torch.Tensor, text: torch.Tensor, prec: Precision) -> torch.Tensor:
    """Symmetric NCE of the projected video features against the text features."""
    v = l2_normalize(prec.linear(video, p["transformer.v_proj.weight"], p["transformer.v_proj.bias"]))
    return symmetric_nce(v @ text.T / cfg["temp"])


# ---------------------------------------------------------------- step

def warmup_linear(base_lr: float, warmup: int, total: int, step: int, floor: float = 1e-8) -> float:
    """The schedule's lr at update ``step`` (0 for the first)."""
    frac = step / max(warmup, 1) if step < warmup else max(0.0, (total - step) / max(total - warmup, 1))
    return max(base_lr * frac, floor)


def _step_loss(p: dict, cfg: dict, batch: dict, gen, prec: Precision) -> torch.Tensor:
    """One step's loss, backpropagated into ``p``'s ``.grad``: the video
    tower in blocks of :data:`BLOCK` samples (see the module's docstring)."""
    mid, other = batch["img_middle"], batch["img_other"]
    blocks = [slice(i, i + BLOCK) for i in range(0, mid.shape[0], BLOCK)]
    with torch.no_grad():
        video = torch.cat([video_features(p, cfg, mid[b], other[b], prec) for b in blocks])
    video.requires_grad_(True)
    text = text_features(p, cfg["text"], batch["text_input_ids"], batch["text_input_mask"], gen, prec)
    loss = itc_loss(p, cfg, video, text, prec)
    loss.backward()
    for b in blocks:
        video_features(p, cfg, mid[b], other[b], prec).backward(video.grad[b])
    return loss.detach()


def train(p: dict, cfg: dict, batches: list[dict], prec: Precision, seed_base: int = 0) -> dict:
    """The stage-1 step over ``batches`` in turn, from the weights ``p``
    (trained in place); step s draws its dropout masks from a generator
    seeded ``seed_base + s``. Returns each step's loss and the first step's
    gradients as clipping leaves them (norms, and the tensors under ``grads``)."""
    opt = cfg["optimizer"]
    adam = AdamW(p, decayed((n, t.shape) for n, t in p.items()), tuple(opt["betas"]), opt["eps"],
                 opt["weight_decay"], opt["grad_norm"])
    device = next(iter(p.values())).device
    losses, first = [], None
    for s, batch in enumerate(batches):
        gen = torch.Generator(device=device).manual_seed((seed_base + s) % (1 << 32))
        losses.append(_step_loss(p, cfg, batch, gen, prec))
        grads = adam.step(warmup_linear(opt["learning_rate"], opt["warmup_steps"], opt["num_train_steps"], s))
        if first is None:
            first = grads
    return {"losses": torch.stack(losses), "grad_norms": {n: torch.linalg.vector_norm(g) for n, g in first.items()},
            "grads": first}
