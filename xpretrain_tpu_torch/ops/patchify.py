"""Device-side ingest math: uint8 frames -> normalized patch embeddings.

Counterpart of the math in ``xpretrain_tpu/ops/patchify.py``. Patchify with
stride == kernel is a reshape plus one matmul, so the /255 + mean/std
normalization folds into the weights:
``((x/255 - mean)/std) @ W == x @ (W/(255*std)) - sum(W*mean/std)``.
The product itself is a plain ``torch.matmul``, as the JAX model leaves it to
XLA (its Pallas ``_pallas_patch_embed`` is not on the model's path).
"""

from __future__ import annotations

import numpy as np
import torch


def fold_normalization(
    patch_kernel: torch.Tensor,  # [P, P, 3, D]
    mean: np.ndarray,
    std: np.ndarray,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fold /255 + mean/std normalization into the patch-embedding weights.

    Returns (folded_weight [P*P*3, D], bias [D]), both fp32, such that
    ``u8_patches @ folded_weight + bias == normalize(u8) @ patch_weight``.
    """
    P, D = patch_kernel.shape[0], patch_kernel.shape[-1]
    w = patch_kernel.float()
    std = torch.as_tensor(np.asarray(std, np.float32), device=w.device)
    mean = torch.as_tensor(np.asarray(mean, np.float32), device=w.device)
    scale = (1.0 / (255.0 * std)).reshape(1, 1, 3, 1)
    offset = (mean / std).reshape(1, 1, 3, 1)
    folded = (w * scale).reshape(P * P * 3, D)
    bias = -(w * offset).sum(dim=(0, 1, 2))
    return folded, bias


def extract_patches_u8(frames: torch.Tensor, patch: int) -> torch.Tensor:
    """uint8 [N, H, W, 3] -> [N, L, patch*patch*3] (channel-last within patch).

    Flattening must match ``fold_normalization``'s [P, P, 3, D] layout.
    """
    N, H, W, C = frames.shape
    gh, gw = H // patch, W // patch
    x = frames.reshape(N, gh, patch, gw, patch, C)
    x = x.permute(0, 1, 3, 2, 4, 5)  # [N, gh, gw, P, P, C]
    return x.reshape(N, gh * gw, patch * patch * C)


def patch_embed_u8(
    frames_u8: torch.Tensor,  # [N, H, W, 3] uint8
    patch_kernel: torch.Tensor,  # [P, P, 3, D]
    mean: np.ndarray,
    std: np.ndarray,
    dtype: torch.dtype = torch.float32,
) -> torch.Tensor:
    """-> [N, L, D] patch embeddings in ``dtype``, normalization folded in."""
    folded_w, bias = fold_normalization(patch_kernel, mean, std)
    patches = extract_patches_u8(frames_u8, patch_kernel.shape[0]).to(dtype)
    return torch.matmul(patches, folded_w.to(dtype)) + bias.to(dtype)
