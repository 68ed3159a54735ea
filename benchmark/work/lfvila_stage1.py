"""Work of LF-VILA stage 1: model FLOPs of a step or a call, and the least
time of each launch of the window-attention kernel at a cell's shapes."""

from __future__ import annotations

from benchmark.frozen.roofline import bound_s

OP_KERNELS = {  # the frozen op classes of each op's kernels (benchmark/frozen/profiling.py)
    "xpt::window_attention_fwd": ("window attention forward kernel",),
}

BF16, FP32 = 2, 4


def _clip(dims, window):
    return tuple(min(d, w) for d, w in zip(dims, window))


def swin_stages(cfg: dict) -> list[dict]:
    """Per stage: its map (frames, h, w), channels, heads, clipped window,
    depth and whether its blocks shift, for the configuration's input."""
    v = cfg["video"]
    pt, ph, pw = v["patch_size"]
    H, W = cfg["input_size"]
    dims = (cfg["sample_frame"] // pt, H // ph, W // pw)
    out = []
    for i, depth in enumerate(v["depths"]):
        window = _clip(dims, v["window_size"][i])
        shift = [0 if v["temporal_no_shifting"] and j == 0 else w // 2 for j, w in enumerate(v["window_size"][i])]
        shifts = any(s > 0 and d > w for s, d, w in zip(shift, dims, v["window_size"][i]))
        out.append({"dims": dims, "channels": v["embed_dim"] * 2 ** v["stages"][i], "heads": v["num_heads"][i],
                    "window": window, "depth": depth, "shifts": shifts, "downsample": i in v["downsample_stages"]})
        if i in v["downsample_stages"]:
            dims = (dims[0], dims[1] // 2, dims[2] // 2)
    return out


def _prod(t) -> int:
    n = 1
    for x in t:
        n *= x
    return n


def video_flops(cfg: dict) -> dict[str, int]:
    """{"gemm", "attention"} FLOPs of one clip through Swin3D and the
    retrieval projection: the patch conv, each block's qkv, proj and MLP,
    attention over each window's tokens, and the PatchMerging reductions."""
    v = cfg["video"]
    pt, ph, pw = v["patch_size"]
    stages = swin_stages(cfg)
    gemm = _prod(stages[0]["dims"]) * 3 * pt * ph * pw * v["embed_dim"] * 2
    attention = 0
    for s in stages:
        tokens, c = _prod(s["dims"]), s["channels"]
        r = v["mlp_ratio"]
        gemm += s["depth"] * tokens * (4 * c * c + 2 * r * c * c) * 2
        attention += s["depth"] * tokens * 4 * _prod(s["window"]) * c
        if s["downsample"]:
            gemm += (tokens // 4) * (4 * c) * (2 * c) * 2
    hidden = cfg["text"]["hidden_size"]
    return {"gemm": gemm + hidden * hidden * 2, "attention": attention}


def text_flops(cfg: dict, sentences: int, seq: int) -> dict[str, int]:
    """{"gemm", "attention"} FLOPs of one paragraph through the BERT stages
    (per sentence, then over 1 + sentences * seq tokens) and its projection;
    attention over every position of its sequence."""
    t = cfg["text"]
    h, inter = t["hidden_size"], t["intermediate_size"]
    lo, hi = t["stage_bounds"]
    layer = lambda n: n * (4 * h * h + 2 * h * inter) * 2  # noqa: E731
    para = 1 + sentences * seq
    gemm = lo * sentences * layer(seq) + (hi - lo) * layer(para) + h * h * 2
    attention = lo * sentences * 4 * seq * seq * h + (hi - lo) * 4 * para * para * h
    return {"gemm": gemm, "attention": attention}


def forward_flops(cfg: dict, kind: str, batch: int, sentences: int, seq: int) -> dict[str, int]:
    v, t = video_flops(cfg), text_flops(cfg, sentences, seq)
    gemm = batch * (v["gemm"] + t["gemm"])
    if kind == "train":  # the two more projections and the losses' products
        h, clips = cfg["text"]["hidden_size"], cfg["sample_clip"]
        gemm += batch * (clips + sentences) * h * h * 2 + batch * batch * h * 2
    return {"gemm": gemm, "attention": batch * (v["attention"] + t["attention"])}


def model_flops(cfg: dict, kind: str, batch: int, seq: int) -> float:
    """FLOPs of one train step (a forward and two for the backward) or one
    serving call of ``batch`` clips and paragraphs of ``sample_clip``
    sentences of ``seq`` positions."""
    f = sum(forward_flops(cfg, kind, batch, cfg["sample_clip"], seq).values())
    return 3.0 * f if kind == "train" else float(f)


def window_fwd(cfg: dict, stage: dict, batch: int) -> tuple[float, float]:
    """(FLOPs, bytes) of one kernel launch over a block's windows: QK^T and
    PV over each window; q, k, v and the output once in bf16, the fp32 bias
    and, in a shifted block, the fp32 mask."""
    n, (d, h, w) = _prod(stage["window"]), stage["dims"]
    windows = batch * (d // stage["window"][0]) * (h // stage["window"][1]) * (w // stage["window"][2])
    heads, head_dim = stage["heads"], stage["channels"] // stage["heads"]
    flops = 4 * windows * heads * n * n * head_dim
    nbytes = 4 * windows * n * stage["channels"] * BF16 + heads * n * n * FP32
    return float(flops), float(nbytes)


def op_bounds(cfg: dict, kind: str, batch: int) -> dict[str, list[float]]:
    """Serving launches the window kernel once per block whose unclipped
    window holds at least ``pallas_min_window`` tokens; training none."""
    if kind != "serve":
        return {}
    v = cfg["video"]
    bounds = []
    for i, s in enumerate(swin_stages(cfg)):
        if _prod(v["window_size"][i]) < cfg["preset"]["serve"]["video_encoder"].get("pallas_min_window", 240):
            continue
        for b in range(s["depth"]):
            flops, nbytes = window_fwd(cfg, s, batch)
            if b % 2 and s["shifts"]:
                n = _prod(s["window"])
                nbytes += (_prod(s["dims"]) // n) * n * n * FP32
            bounds.append(bound_s(flops, nbytes))
    return {"xpt::window_attention_fwd": bounds}
