"""Plain CLIP-ViP (OpenAI CLIP ViT-B/32 towers with ViP proxy attention) and
its fine-tune step, float32.

Written from CLIP-ViP's ``src/modeling/CLIP_ViP.py`` (video embeddings with
a temporal embedding and 1 + ``add_cls_num`` proxy tokens; proxy attention:
patch tokens attend [proxies | own frame], proxies attend everything),
HF CLIP's text tower (causal, EOT-argmax pooling) and ``VidCLIP``'s
normalized features with a learnable temperature. Parameters carry the
port's names, so both sides take one set of weights (``weights.py``).
Attention is computed dense over its allowed pattern; the step is the NCE
loss, backward, global-norm clipping and grouped AdamW.
"""

from __future__ import annotations

import math

import torch

from benchmark.reference.plain import (
    AdamW,
    Precision,
    attention,
    l2_normalize,
    layer_norm,
    symmetric_nce,
    warmup_cosine,
)
from benchmark.weights import Leaf

CLIP_MEAN = (0.48145466, 0.4578275, 0.40821073)
CLIP_STD = (0.26862954, 0.26130258, 0.27577711)
LOGIT_SCALE_MAX = math.log(200.0)
NO_DECAY = ("bias", "layer_norm", "layernorm", "_norm", "norm_", "logit_scale")


def _tower_leaves(prefix: str, layers: int, d: int, inter: int) -> list[tuple[str, tuple, str]]:
    out = []
    for i in range(layers):
        p = f"{prefix}.encoder.layers.{i}"
        for ln in ("layer_norm1", "layer_norm2"):
            out += [(f"{p}.{ln}.weight", (d,), "norm"), (f"{p}.{ln}.bias", (d,), "bias")]
        for proj in ("q_proj", "k_proj", "v_proj", "out_proj"):
            out += [(f"{p}.self_attn.{proj}.weight", (d, d), "dense"), (f"{p}.self_attn.{proj}.bias", (d,), "bias")]
        out += [(f"{p}.mlp.fc1.weight", (inter, d), "dense"), (f"{p}.mlp.fc1.bias", (inter,), "bias"),
                (f"{p}.mlp.fc2.weight", (d, inter), "dense"), (f"{p}.mlp.fc2.bias", (d,), "bias")]
    return out


def leaves(cfg: dict, kind: str = "train") -> list[Leaf]:
    """Every parameter (the same for ``kind`` "train" and "serve") with its
    initial mean and std: dense kernels
    N(0, 1/fan_in), biases and embeddings N(0, 0.02), norm scales
    1 + N(0, 0.02), the temperature ``logit_scale_init_value``."""
    v, t = cfg["vision"], cfg["text"]
    D, P = v["hidden_size"], v["patch_size"]
    grid = (v["image_size"] // P) ** 2
    spec = [
        ("text_model.embeddings.token_embedding.weight", (t["vocab_size"], t["hidden_size"]), "embed"),
        ("text_model.embeddings.position_embedding.weight", (t["max_position_embeddings"], t["hidden_size"]), "embed"),
        *_tower_leaves("text_model", t["num_hidden_layers"], t["hidden_size"], t["intermediate_size"]),
        ("text_model.final_layer_norm.weight", (t["hidden_size"],), "norm"),
        ("text_model.final_layer_norm.bias", (t["hidden_size"],), "bias"),
        ("vision_model.embeddings.class_embedding", (D,), "embed"),
        ("vision_model.embeddings.added_cls", (cfg["add_cls_num"], D), "embed"),
        ("vision_model.embeddings.patch_embedding.weight", (P, P, 3, D), "patch"),
        ("vision_model.embeddings.position_embedding.weight", (grid + 1, D), "embed"),
        ("vision_model.embeddings.temporal_embedding", (1, cfg["temporal_size"], D), "embed"),
        ("vision_model.pre_layrnorm.weight", (D,), "norm"),
        ("vision_model.pre_layrnorm.bias", (D,), "bias"),
        *_tower_leaves("vision_model", v["num_hidden_layers"], D, v["intermediate_size"]),
        ("vision_model.post_layernorm.weight", (D,), "norm"),
        ("vision_model.post_layernorm.bias", (D,), "bias"),
        ("visual_projection.weight", (cfg["projection_dim"], D), "dense"),
        ("text_projection.weight", (cfg["projection_dim"], t["hidden_size"]), "dense"),
        ("logit_scale", (), "scale"),
    ]
    out = []
    for name, shape, kind in spec:
        if kind == "dense":
            out.append(Leaf(name, shape, 0.0, shape[1] ** -0.5))
        elif kind == "patch":
            out.append(Leaf(name, shape, 0.0, (shape[0] * shape[1] * shape[2]) ** -0.5))
        elif kind == "norm":
            out.append(Leaf(name, shape, 1.0, 0.02))
        elif kind == "scale":
            out.append(Leaf(name, shape, cfg["logit_scale_init_value"], 0.0))
        else:
            out.append(Leaf(name, shape, 0.0, 0.02))
    return out


def _encoder(x: torch.Tensor, p: dict, prefix: str, layers: int, heads: int, allowed: torch.Tensor,
             prec: Precision) -> torch.Tensor:
    B, S, E = x.shape
    split = lambda t: t.view(B, S, heads, E // heads).transpose(1, 2)  # noqa: E731
    for i in range(layers):
        pre = f"{prefix}.encoder.layers.{i}"
        lin = lambda h, n: prec.linear(h, p[f"{pre}.{n}.weight"], p[f"{pre}.{n}.bias"])  # noqa: E731
        h = layer_norm(x, p, f"{pre}.layer_norm1", 1e-5)
        q, k, v = (split(lin(h, f"self_attn.{n}_proj")) for n in ("q", "k", "v"))
        a = attention(q, k, v, allowed, prec).transpose(1, 2).reshape(B, S, E)
        x = x + lin(a, "self_attn.out_proj")
        h = layer_norm(x, p, f"{pre}.layer_norm2", 1e-5)
        h = lin(h, "mlp.fc1")
        x = x + lin(h * torch.sigmoid(1.702 * h), "mlp.fc2")
    return x


def proxy_allowed(M: int, N: int, L: int, device) -> torch.Tensor:
    """[S, S] boolean: the proxies attend every token; a frame's patches
    attend the proxies and their own frame."""
    S = M + N * L
    i = torch.arange(S, device=device)
    frame = torch.where(i < M, -1, (i - M) // L)
    return (i[:, None] < M) | (i[None, :] < M) | (frame[:, None] == frame[None, :])


def encode_video(p: dict, cfg: dict, video: torch.Tensor, prec: Precision) -> torch.Tensor:
    """uint8 [B, T, H, W, 3] -> normalized [B, projection_dim] features."""
    v = cfg["vision"]
    B, T, H, W, _ = video.shape
    P, D = v["patch_size"], v["hidden_size"]
    mean = torch.tensor(CLIP_MEAN, device=video.device)
    std = torch.tensor(CLIP_STD, device=video.device)
    x = (video.float() / 255.0 - mean) / std
    x = x.reshape(B * T, H // P, P, W // P, P, 3).permute(0, 1, 3, 2, 4, 5)
    L = (H // P) * (W // P)
    patches = prec.linear(x.reshape(B * T, L, P * P * 3),
                          p["vision_model.embeddings.patch_embedding.weight"].reshape(P * P * 3, D).T)
    pos = p["vision_model.embeddings.position_embedding.weight"]
    patches = patches.reshape(B, T, L, D) + p["vision_model.embeddings.temporal_embedding"][:, :T, None] + pos[1:]
    cls = (p["vision_model.embeddings.class_embedding"] + pos[0]).expand(B, 1, D)
    added = (p["vision_model.embeddings.added_cls"] + pos[0]).expand(B, -1, D)
    x = torch.cat([cls, added, patches.reshape(B, T * L, D)], dim=1)
    M = 1 + cfg["add_cls_num"]
    x = layer_norm(x, p, "vision_model.pre_layrnorm", 1e-5)
    x = _encoder(x, p, "vision_model", v["num_hidden_layers"], v["num_attention_heads"],
                 proxy_allowed(M, T, L, video.device), prec)
    pooled = layer_norm(x[:, 0], p, "vision_model.post_layernorm", 1e-5)
    return l2_normalize(prec.linear(pooled, p["visual_projection.weight"]))


def encode_text(p: dict, cfg: dict, ids: torch.Tensor, mask: torch.Tensor, prec: Precision) -> torch.Tensor:
    """[B, S] ids + 0/1 mask -> normalized [B, projection_dim] features,
    pooled at the EOT token (the highest id)."""
    t = cfg["text"]
    B, S = ids.shape
    x = p["text_model.embeddings.token_embedding.weight"][ids] + p["text_model.embeddings.position_embedding.weight"][:S]
    causal = torch.ones(S, S, dtype=torch.bool, device=ids.device).tril()
    allowed = causal[None, None] & (mask[:, None, None, :] > 0)
    x = _encoder(x, p, "text_model", t["num_hidden_layers"], t["num_attention_heads"], allowed, prec)
    x = layer_norm(x, p, "text_model.final_layer_norm", 1e-5)
    pooled = x[torch.arange(B, device=ids.device), ids.argmax(dim=-1)]
    return l2_normalize(prec.linear(pooled, p["text_projection.weight"]))


def features(p: dict, cfg: dict, batch: dict, prec: Precision) -> tuple[torch.Tensor, torch.Tensor]:
    """(video, text) features of a serving batch (tensors on the device)."""
    with torch.no_grad():
        return (encode_video(p, cfg, batch["video"], prec),
                encode_text(p, cfg, batch["text_input_ids"], batch["text_input_mask"], prec))


def decayed(names) -> set[str]:
    """The leaves weight decay applies to: those of two dims or more whose
    name matches none of the fine-tune preset's no-decay patterns."""
    return {n for n, shape in names if len(shape) >= 2 and not any(s in n.lower() for s in NO_DECAY)}


def train(p: dict, cfg: dict, batches: list[dict], prec: Precision, seed_base: int = 0) -> dict:
    """The fine-tune step over ``batches`` in turn, from the weights ``p``
    (trained in place): the loss of each step, each leaf's gradient as the
    optimizer takes it at the first step (its norm, and the tensor under
    ``grads``), and the grouped AdamW updates."""
    opt = cfg["optimizer"]
    adam = AdamW(p, decayed((n, t.shape) for n, t in p.items()), tuple(opt["betas"]), opt["eps"],
                 opt["weight_decay"], opt["grad_norm"])
    losses, first, first_grads = [], None, None
    for s, batch in enumerate(batches):
        with torch.no_grad():
            p["logit_scale"].clamp_(0.0, LOGIT_SCALE_MAX)
        vis = encode_video(p, cfg, batch["video"], prec)
        txt = encode_text(p, cfg, batch["text_input_ids"], batch["text_input_mask"], prec)
        loss = symmetric_nce((vis @ txt.T) * p["logit_scale"].exp())
        loss.backward()
        losses.append(loss.detach())
        grads = adam.step(warmup_cosine(opt["learning_rate"], opt["warmup_steps"], opt["num_train_steps"], s))
        if first is None:
            first = {n: torch.linalg.vector_norm(g) for n, g in grads.items()}
            first_grads = grads
        with torch.no_grad():
            p["logit_scale"].clamp_(0.0, LOGIT_SCALE_MAX)
    return {"losses": torch.stack(losses), "grad_norms": first, "grads": first_grads}
