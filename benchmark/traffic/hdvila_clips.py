"""HD-VILA's stage-1 batch, the schema ``hdvila_clips``: the collator's keys,
``clips`` clips a sample of ``frames`` frames each, the middle frame at full
resolution and the others at a quarter of its height and width.

``traffic/batches.py:SCHEMAS`` is a closed dict, so this module adds its
schema there when it is imported; the configuration's program module
imports it, and ``run.execute`` and ``controls.cell_for`` import the program
before any pool is made."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.traffic import batches


def scene_frames(spec: dict, clips: int, frames: int, height: int, width: int, seed: int,
                 device: str) -> torch.Tensor:
    """uint8 clips [clips, frames, 3, height, width] with content of their
    own: each a picture of ``spec["cell"]``-pixel squares of one random
    colour, each square's colour drifting from frame to frame by a Gaussian
    step of ``spec["drift"]``, under per-pixel Gaussian noise of
    ``spec["noise"]`` (levels out of 255); ``batches.scene_clips`` at a
    frame that need not be square."""
    cell = int(spec["cell"])
    if height % cell or width % cell:
        raise ValueError(f"a {height}x{width} frame does not split into squares of {cell}")
    g = torch.Generator(device=device).manual_seed(seed)
    h, w = height // cell, width // cell
    base = torch.rand(clips, 1, 3, h, w, device=device, generator=g) * 255
    walk = torch.randn(clips, frames, 3, h, w, device=device, generator=g).cumsum(1) * float(spec["drift"])
    picture = (base + walk).repeat_interleave(cell, 3).repeat_interleave(cell, 4)
    noise = torch.randn(clips, frames, 3, height, width, device=device, generator=g) * float(spec["noise"])
    return (picture + noise).round_().clamp_(0, 255).to(torch.uint8)


def shrink(frames: torch.Tensor, factor: int) -> torch.Tensor:
    """uint8 [..., H, W] -> [..., H / factor, W / factor]: the mean of each
    factor x factor block, rounded."""
    *lead, H, W = frames.shape
    blocks = frames.float().reshape(*lead, H // factor, factor, W // factor, factor)
    return blocks.mean(dim=(-3, -1)).round_().to(torch.uint8)


def hdvila_clips(params: dict, seed: int, i: int, device: str) -> dict[str, np.ndarray]:
    """u8 ``img_middle`` [batch, clips, 3, height, width] (frame
    ``frames // 2`` of each :func:`scene_frames` clip) and ``img_other``
    [batch, clips, frames - 1, 3, height / 4, width / 4] (the other frames,
    :func:`shrink` by 4: the same scene at a quarter of the size); captions of
    [CLS] + 1 to ``seq`` - 2 word ids + [SEP] in ``seq`` positions, mask 1 on
    their tokens."""
    s = batches._subseed(seed, i)
    B, clips, T, L = params["batch"], params["clips"], params["frames"], params["seq"]
    video = scene_frames(params["scenes"], B * clips, T, params["height"], params["width"], s, device)
    video = video.reshape(B, clips, *video.shape[1:])
    half = T // 2
    other = shrink(torch.cat([video[:, :, :half], video[:, :, half + 1:]], dim=2), params["low_res_factor"])
    rng = np.random.default_rng(s)
    ids = np.zeros((B, L), np.int64)
    for b, n in enumerate(rng.integers(1, L - 1, size=B)):
        ids[b, 0] = params["cls_id"]
        ids[b, 1:n + 1] = rng.integers(params["first_word_id"], params["vocab_size"], size=n)
        ids[b, n + 1] = params["sep_id"]
    return {"img_middle": video[:, :, half].cpu().numpy(), "img_other": other.cpu().numpy(),
            "text_input_ids": ids, "text_input_mask": (ids > 0).astype(np.int64)}


batches.SCHEMAS.setdefault("hdvila_clips", hdvila_clips)
