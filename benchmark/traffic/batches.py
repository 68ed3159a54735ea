"""Host (numpy) batches of each schema, drawn from a seed: a pool of
``pool`` distinct batches that a window cycles through, made on the device
in a few large draws and brought to the host once during set-up. Every seed
gives the same sizes (clips, frames, token positions); only the values and
the caption lengths inside the fixed positions differ."""

from __future__ import annotations

import numpy as np
import torch

from benchmark.frozen.traffic import captions


def _subseed(seed: int, i: int) -> int:
    return (int(seed) * 1_000_003 + 7919 * (i + 1)) % (1 << 62)


def scene_clips(spec: dict, batch: int, frames: int, size: int, seed: int, device: str) -> torch.Tensor:
    """uint8 clips [batch, frames, size, size, 3] with content of their own:
    each clip a picture of ``spec["cell"]``-pixel squares of one random
    colour, each square's colour drifting from frame to frame by a Gaussian
    step of ``spec["drift"]``, under per-pixel Gaussian noise of
    ``spec["noise"]`` (levels out of 255)."""
    cell = int(spec["cell"])
    if size % cell:
        raise ValueError(f"a frame of {size} px does not split into squares of {cell}")
    g = torch.Generator(device=device).manual_seed(seed)
    n = size // cell
    base = torch.rand(batch, 1, n, n, 3, device=device, generator=g) * 255
    walk = torch.randn(batch, frames, n, n, 3, device=device, generator=g).cumsum(1) * float(spec["drift"])
    picture = (base + walk).repeat_interleave(cell, 2).repeat_interleave(cell, 3)
    noise = torch.randn(batch, frames, size, size, 3, device=device, generator=g) * float(spec["noise"])
    return (picture + noise).round_().clamp_(0, 255).to(torch.uint8)


def clip_captions(params: dict, seed: int, i: int, device: str) -> dict[str, np.ndarray]:
    """CLIP-ViP's batch: uint8 clips [batch, frames, size, size, 3] of
    :func:`scene_clips` with ``params["scenes"]``, and captions of 3 to
    ``seq`` - 2 tokens in ``seq`` positions (the frozen ``captions``)."""
    if params["seq"] != 70:
        raise ValueError("the frozen caption generator writes 70 positions")
    s = _subseed(seed, i)
    ids, mask = captions(np.random.default_rng(s), params["batch"])
    video = scene_clips(params["scenes"], params["batch"], params["frames"], params["size"], s, device)
    return {"video": video.cpu().numpy(), "text_input_ids": ids, "text_input_mask": mask}


def lfvila_paragraphs(params: dict, seed: int, i: int, device: str) -> dict[str, np.ndarray]:
    """LF-VILA's stage-1 batch with device ingest: uint8 clips [batch,
    frames, height, width, 3] and ``sentences`` sentences a paragraph, each
    [CLS] + 1 to ``seq`` - 2 word ids + [SEP] in ``seq`` positions, mask 1
    on its tokens."""
    s = _subseed(seed, i)
    g = torch.Generator(device=device).manual_seed(s)
    B, M, L = params["batch"], params["sentences"], params["seq"]
    video = torch.randint(0, 256, (B, params["frames"], params["height"], params["width"], 3), device=device,
                          dtype=torch.uint8, generator=g)
    rng = np.random.default_rng(s)
    ids = np.zeros((B, M, L), np.int64)
    lengths = rng.integers(1, L - 1, size=(B, M))
    for b in range(B):
        for m in range(M):
            n = lengths[b, m]
            ids[b, m, 0] = params["cls_id"]
            ids[b, m, 1:n + 1] = rng.integers(params["first_word_id"], params["vocab_size"], size=n)
            ids[b, m, n + 1] = params["sep_id"]
    return {"video_frames": video.cpu().numpy(), "text_ids": ids, "attention_mask": (ids > 0).astype(np.int64)}


SCHEMAS = {"clip_captions": clip_captions, "lfvila_paragraphs": lfvila_paragraphs}


def pool(params: dict, seed: int, device: str) -> list[dict[str, np.ndarray]]:
    """``params["pool"]`` distinct host batches of ``params["schema"]``."""
    make = SCHEMAS[params["schema"]]
    return [make(params, seed, i, device) for i in range(params["pool"])]
