"""Work of HD-VILA stage 1: model FLOPs of a step, from the configuration's
shapes.

No op has a bound: no frozen op class holds the convolutions' kernels alone
(``convolutions (cuDNN)`` also takes cuDNN's attention kernels, and cuDNN
runs some passes of the 1x1 convolutions as cuBLASLt GEMMs), so no roofline
could read one (PERF.md section 7)."""

from __future__ import annotations

OP_KERNELS: dict = {}  # the frozen op classes of each op's kernels (benchmark/frozen/profiling.py)


def _out(size: int, k: int, stride: int) -> int:
    return (size + 2 * (k // 2) - k) // stride + 1


def _conv(cin: int, cout: int, k: int, stride: int, h: int, w: int) -> dict:
    return {"cin": cin, "cout": cout, "k": k, "hout": _out(h, k, stride), "wout": _out(w, k, stride)}


def resnet_convs(cfg: dict, h: int, w: int, stages: int) -> list[dict]:
    """Each convolution of the ResNet's stem and first ``stages`` stages over
    one h x w image."""
    r = cfg["resnet"]
    base, e = r["base_channels"], r["expansion"]
    convs = [_conv(3, base, 7, 2, h, w)]
    h, w = _out(convs[0]["hout"], 3, 2), _out(convs[0]["wout"], 3, 2)  # the 3x3/s2 max-pool
    inplanes = base
    for s, n in enumerate(r["stage_blocks"][:stages]):
        planes = base * 2 ** s
        for b in range(n):
            stride = 2 if b == 0 and s > 0 else 1
            mid = _conv(planes, planes, 3, stride, h, w)
            convs += [_conv(inplanes, planes, 1, 1, h, w), mid,
                      _conv(planes, planes * e, 1, 1, mid["hout"], mid["wout"])]
            if b == 0:
                convs.append(_conv(inplanes, planes * e, 1, stride, h, w))
            h, w, inplanes = mid["hout"], mid["wout"], planes * e
    return convs


def convolutions(cfg: dict, batch: int) -> list[tuple[dict, int]]:
    """(convolution, images it runs over in a step) of the whole encoder:
    the full ResNet over each clip's middle frame, the low-resolution one to
    its last stage over the other frames, and the three 1x1 grid convolutions
    (the high-resolution one before its 2x2 max-pool)."""
    r, d = cfg["resnet"], cfg["timesformer"]["hidden_size"]
    (H, W), f = cfg["crop_size"], cfg["low_res_factor"]
    gh, gw = cfg["timesformer"]["grid"]
    clips, frames = batch * cfg["clips"], cfg["frames"]
    c3, c4 = (r["base_channels"] * 2 ** s * r["expansion"] for s in (2, 3))
    hi = resnet_convs(cfg, H, W, len(r["stage_blocks"]))
    low = resnet_convs(cfg, H // f, W // f, r["low_res_stages"])
    return ([(c, clips) for c in hi] + [(c, clips * (frames - 1)) for c in low]
            + [(_conv(c4, d, 1, 1, hi[-1]["hout"], hi[-1]["wout"]), clips),
               (_conv(c3, d, 1, 1, gh, gw), clips * frames),
               (_conv(2 * d, d, 1, 1, gh, gw), clips)])


def conv_flops(c: dict) -> int:
    """FLOPs of one convolution's forward over one image."""
    return 2 * c["cin"] * c["cout"] * c["k"] ** 2 * c["hout"] * c["wout"]


def timesformer_flops(cfg: dict, batch: int) -> dict[str, int]:
    """{"gemm", "attention"} FLOPs of the TimeSformer over every clip's
    frames x grid tokens: per block the temporal qkv, proj and fc, the
    spatial qkv and proj and the MLP; attention over the token's frames at
    its location, then over its frame's locations."""
    ts = cfg["timesformer"]
    d, (gh, gw), T = ts["hidden_size"], ts["grid"], cfg["frames"]
    tokens = batch * cfg["clips"] * T * gh * gw
    per_token = (3 + 1 + 1 + 3 + 1 + 2 * ts["mlp_ratio"]) * d * d * 2
    return {"gemm": ts["depth"] * tokens * per_token, "attention": ts["depth"] * tokens * 4 * (T + gh * gw) * d}


def text_flops(cfg: dict, batch: int, seq: int) -> dict[str, int]:
    """{"gemm", "attention"} FLOPs of the stage-1 BERT layers over each
    caption's ``seq`` positions, ``pooler1``, ``t_proj``, ``v_proj`` and the
    similarity matrix; attention over every position."""
    t = cfg["text"]
    h, inter, layers = t["hidden_size"], t["intermediate_size"], t["stage_layers"]
    gemm = layers * batch * seq * (4 * h * h + 2 * h * inter) * 2 + 3 * batch * h * h * 2 + batch * batch * h * 2
    return {"gemm": gemm, "attention": layers * batch * 4 * seq * seq * h}


def forward_flops(cfg: dict, batch: int, seq: int) -> dict[str, int]:
    ts, tx = timesformer_flops(cfg, batch), text_flops(cfg, batch, seq)
    return {"conv": sum(conv_flops(c) * n for c, n in convolutions(cfg, batch)),
            "gemm": ts["gemm"] + tx["gemm"], "attention": ts["attention"] + tx["attention"]}


def model_flops(cfg: dict, kind: str, batch: int, seq: int) -> float:
    """FLOPs of one train step: a forward and two for the backward."""
    return 3.0 * sum(forward_flops(cfg, batch, seq).values())


def op_bounds(cfg: dict, kind: str, batch: int) -> dict[str, list[float]]:
    """No op of this configuration has a bound yet (the module's docstring)."""
    return {}
