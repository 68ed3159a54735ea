"""Host-side frame transforms (numpy/cv2): resize, crop, normalize (the port's
copy of the parts of ``xpretrain_tpu/data/transforms.py`` it uses).

Capability parity with the reference's torchvision pipelines
(``CLIP-ViP/src/datasets/dataloader.py:180-260``: CLIP constants, resize +
center-crop "simple" pipeline; ImageNet constants for hd-vila/LF-VILA
``hd-vila/src/modeling/e2e_model.py:26-27``).

Frames flow as uint8 [T, H, W, C] until the final normalize, which emits
fp32 [T, C, H, W] ready for device upload. With device ingest, the
normalization folds into the patch-embedding GEMM on the device
(``ops/patchify.py``) and the host ships uint8.

Resizing runs ``cv2.resize`` where cv2 is installed, as the JAX copy does.
Without cv2 (the card's machine) bilinear and bicubic resizes run
``F.interpolate`` (half-pixel centres, no antialiasing, rounded to uint8),
within 1 of cv2's uint8 result; the JAX copy falls back to
nearest-neighbour indexing there.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

CLIP_MEAN = np.array([0.48145466, 0.4578275, 0.40821073], dtype=np.float32)
CLIP_STD = np.array([0.26862954, 0.26130258, 0.27577711], dtype=np.float32)
IMAGENET_MEAN = np.array([0.485, 0.456, 0.406], dtype=np.float32)
IMAGENET_STD = np.array([0.229, 0.224, 0.225], dtype=np.float32)


def _resize_frame(frame: np.ndarray, out_hw: tuple[int, int], interpolation: str) -> np.ndarray:
    if _HAS_CV2:
        inter = {
            "bilinear": cv2.INTER_LINEAR,
            "bicubic": cv2.INTER_CUBIC,
            "nearest": cv2.INTER_NEAREST,
            "area": cv2.INTER_AREA,
        }[interpolation]
        return cv2.resize(frame, (out_hw[1], out_hw[0]), interpolation=inter)
    if interpolation in ("bilinear", "bicubic"):
        import torch
        import torch.nn.functional as F

        x = torch.from_numpy(np.ascontiguousarray(frame)).float()
        x = x[None, None] if x.ndim == 2 else x.permute(2, 0, 1)[None]
        y = F.interpolate(x, size=tuple(out_hw), mode=interpolation, align_corners=False)
        y = y.round_().clamp_(0, 255).to(torch.uint8)[0]
        return (y[0] if frame.ndim == 2 else y.permute(1, 2, 0)).numpy()
    # numpy fallback: nearest-neighbor
    h, w = frame.shape[:2]
    ys = np.clip(((np.arange(out_hw[0]) + 0.5) * h / out_hw[0]).astype(int), 0, h - 1)
    xs = np.clip(((np.arange(out_hw[1]) + 0.5) * w / out_hw[1]).astype(int), 0, w - 1)
    return frame[ys][:, xs]


def resize(frames: np.ndarray, size, interpolation: str = "bilinear") -> np.ndarray:
    """Resize [T, H, W, C]. int size = shorter side; (h, w) = exact."""
    t, h, w = frames.shape[:3]
    if isinstance(size, int):
        scale = size / min(h, w)
        out_hw = (int(round(h * scale)), int(round(w * scale)))
    else:
        out_hw = tuple(size)
    if out_hw == (h, w):
        return frames
    return np.stack([_resize_frame(f, out_hw, interpolation) for f in frames])


def center_crop(frames: np.ndarray, crop_hw) -> np.ndarray:
    ch, cw = (crop_hw, crop_hw) if isinstance(crop_hw, int) else crop_hw
    h, w = frames.shape[1:3]
    top, left = max((h - ch) // 2, 0), max((w - cw) // 2, 0)
    return frames[:, top : top + ch, left : left + cw]


def random_crop(frames: np.ndarray, crop_hw, rng: np.random.Generator) -> np.ndarray:
    ch, cw = (crop_hw, crop_hw) if isinstance(crop_hw, int) else crop_hw
    h, w = frames.shape[1:3]
    top = int(rng.integers(0, max(h - ch, 0) + 1))
    left = int(rng.integers(0, max(w - cw, 0) + 1))
    return frames[:, top : top + ch, left : left + cw]


def normalize(frames: np.ndarray, mean: np.ndarray = CLIP_MEAN, std: np.ndarray = CLIP_STD):
    """uint8 [T,H,W,C] -> fp32 [T,C,H,W], scaled /255 then standardized."""
    x = frames.astype(np.float32) / 255.0
    x = (x - mean) / std
    return np.ascontiguousarray(x.transpose(0, 3, 1, 2))


def clip_transform(
    frames: np.ndarray,
    image_size: int = 224,
    train: bool = False,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """The CLIP-ViP "simple" pipeline: resize shorter side, crop, normalize."""
    frames = clip_resize_crop_u8(frames, image_size, train, rng)
    return normalize(frames, CLIP_MEAN, CLIP_STD)


def clip_resize_crop_u8(
    frames: np.ndarray,
    image_size: int = 224,
    train: bool = False,
    rng: np.random.Generator | None = None,
) -> np.ndarray:
    """Geometry-only host transform: resize shorter side + crop, staying
    uint8 [T, H, W, C]. The device-ingest path: normalization folds into the
    patch-embedding gemm on device (``ops/patchify.py``), and the host->HBM
    transfer is 4x smaller than fp32."""
    frames = resize(frames, image_size, "bicubic")
    if train and rng is not None:
        frames = random_crop(frames, image_size, rng)
    else:
        frames = center_crop(frames, image_size)
    return np.ascontiguousarray(frames)
