"""Work of CLIP-ViP B/32: model FLOPs of a step or a call, and the least
time of each launch of the proxy-attention kernels at a cell's shapes."""

from __future__ import annotations

from benchmark.frozen.roofline import bound_s

OP_KERNELS = {  # the frozen op classes of each op's kernels (benchmark/frozen/profiling.py)
    "xpt::proxy_attention_fwd": ("proxy attention forward kernel",),
    "xpt::proxy_attention_bwd": ("proxy attention backward kernel, dq pass",
                                 "proxy attention backward kernel, dk/dv pass"),
}

BF16 = 2  # bytes of the compute dtype the configuration states
FP32 = 4


def vision_shapes(cfg: dict) -> tuple[int, int, int, int, int, int]:
    """(M proxies, N frames, L patches a frame, S tokens, hidden, heads)."""
    v = cfg["vision"]
    M, N = 1 + cfg["add_cls_num"], cfg["temporal_size"]
    L = (v["image_size"] // v["patch_size"]) ** 2
    return M, N, L, M + N * L, v["hidden_size"], v["num_attention_heads"]


def proxy_scores(cfg: dict) -> int:
    """Scores one head of one clip computes by the proxy pattern: the M
    proxies over all S tokens, and each frame's L patches over M + L."""
    M, N, L, S, _, _ = vision_shapes(cfg)
    return M * S + N * L * (M + L)


def text_scores(cfg: dict, seq: int) -> int:
    """Scores one head of one caption computes under the causal pattern."""
    return seq * (seq + 1) // 2


def _layers(tokens: int, d: int, inter: int, layers: int) -> int:
    """GEMM FLOPs of ``layers`` transformer layers over ``tokens`` tokens:
    q, k, v, out (4 d^2) and the MLP (2 d inter), 2 FLOPs a product."""
    return layers * tokens * (4 * d * d + 2 * d * inter) * 2


def forward_flops(cfg: dict, batch: int, seq: int) -> dict[str, int]:
    """{"gemm", "attention"} FLOPs of one forward of both towers over
    ``batch`` clips and captions of ``seq`` tokens, with the loss's
    similarity matrix."""
    v, t = cfg["vision"], cfg["text"]
    M, N, L, S, D, _ = vision_shapes(cfg)
    P, E, proj = v["patch_size"], t["hidden_size"], cfg["projection_dim"]
    vision = N * L * P * P * 3 * D * 2 + _layers(S, D, v["intermediate_size"], v["num_hidden_layers"]) + D * proj * 2
    text = _layers(seq, E, t["intermediate_size"], t["num_hidden_layers"]) + E * proj * 2
    attention = (4 * proxy_scores(cfg) * D * v["num_hidden_layers"]
                 + 4 * text_scores(cfg, seq) * E * t["num_hidden_layers"])
    return {"gemm": batch * (vision + text) + batch * batch * proj * 2, "attention": batch * attention}


def model_flops(cfg: dict, kind: str, batch: int, seq: int) -> float:
    """FLOPs of one train step (``kind`` "train": a forward and two for the
    backward) or one serving call of video and text ("serve")."""
    f = sum(forward_flops(cfg, batch, seq).values())
    return 3.0 * f if kind == "train" else float(f)


def proxy_fwd(cfg: dict, batch: int, with_lse: bool) -> tuple[float, float]:
    """(FLOPs, bytes) of one forward launch over a layer: QK^T and PV over
    the pattern; q, k, v read and o (and, for a backward, the fp32 LSE)
    written once."""
    _, _, _, S, D, H = vision_shapes(cfg)
    flops = 4 * batch * H * proxy_scores(cfg) * (D // H)
    nbytes = 4 * batch * S * D * BF16 + (batch * H * S * FP32 if with_lse else 0)
    return float(flops), float(nbytes)


def proxy_bwd(cfg: dict, batch: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one backward launch: dV, dP, dQ and dK over the
    pattern (twice the forward's products); q, k, v, dO and the LSE read,
    dq, dk, dv written once."""
    _, _, _, S, D, H = vision_shapes(cfg)
    flops = 8 * batch * H * proxy_scores(cfg) * (D // H)
    nbytes = 7 * batch * S * D * BF16 + batch * H * S * FP32
    return float(flops), float(nbytes)


def op_bounds(cfg: dict, kind: str, batch: int) -> dict[str, list[float]]:
    """The least time of each launch of each ``xpt::`` op in one step or
    call: one proxy forward (and, in training, one backward) per vision layer."""
    layers = cfg["vision"]["num_hidden_layers"]
    bounds = {"xpt::proxy_attention_fwd": [bound_s(*proxy_fwd(cfg, batch, kind == "train"))] * layers}
    if kind == "train":
        bounds["xpt::proxy_attention_bwd"] = [bound_s(*proxy_bwd(cfg, batch))] * layers
    return bounds
