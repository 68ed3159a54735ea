"""Device-side ingest math: uint8 frames -> normalized patch embeddings.

Counterpart of ``xpretrain_tpu/ops/patchify.py``. Patchify with stride ==
kernel is a reshape plus one matmul, so the /255 + mean/std normalization
folds into the weights:
``((x/255 - mean)/std) @ W == x @ (W/(255*std)) - sum(W*mean/std)``.

- :func:`patch_embed_u8` is the model's path: a plain ``torch.matmul``, as
  the JAX model leaves the product to XLA.
- :func:`fused_patch_embed` is the public op entry of the same name in JAX.
  With ``use_kernel=True`` a CUDA tensor launches ``csrc/patch_embed_u8.cu``
  (replacing ``_pallas_patch_embed``), which reads the frames directly with
  the patch gather folded into its load addresses (bf16 out on the tensor
  cores, u8 widened exactly and the fp32 weight split into hi + lo bf16
  terms; fp32 out on the CUDA cores), or raises; a CPU tensor,
  and ``use_kernel`` None or False, take :func:`patch_embed_plain`
  (``_xla_patch_embed``). The kernel launches inside the ``torch.library``
  custom op ``xpt::patch_embed_u8`` (a fake for ``torch.export``, a real
  body that launches and counts).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from xpretrain_tpu_torch.ops import _kernels


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
    make = _mean_std if _kernels.tracing() else _on_device  # a trace's tensors are not cached
    mean, std = make(_values(mean), _values(std), w.device)
    scale = (1.0 / (255.0 * std)).reshape(1, 1, 3, 1)
    offset = (mean / std).reshape(1, 1, 3, 1)
    folded = (w * scale).reshape(P * P * 3, D)
    bias = -(w * offset).sum(dim=(0, 1, 2))
    return folded, bias


def _values(x) -> tuple[float, ...]:
    return tuple(np.asarray(x, np.float32).reshape(-1).tolist())


def _mean_std(mean: tuple[float, ...], std: tuple[float, ...], device: torch.device
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """fp32 (mean, std) on ``device``, made outside inference mode, so that a
    process that serves and then trains can use them."""
    with torch.inference_mode(False):
        return (torch.tensor(mean, dtype=torch.float32, device=device),
                torch.tensor(std, dtype=torch.float32, device=device))


# made once per device and shared (callers must not write to them): a fresh
# host-to-device copy at every call is what a captured CUDA graph cannot hold
_on_device = functools.lru_cache(maxsize=16)(_mean_std)


def normalize_u8(frames_u8: torch.Tensor, mean, std, out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plain on-device normalize for models without a patchify front end
    (HD-VILA's ResNet path): [..., H, W, 3] u8 -> [..., 3, H, W],
    ``(x / 255 - mean) / std`` in fp32, then ``out_dtype``."""
    x = frames_u8.float() / 255.0
    m = torch.as_tensor(np.asarray(mean, np.float32), device=x.device)
    s = torch.as_tensor(np.asarray(std, np.float32), device=x.device)
    return ((x - m) / s).movedim(-1, -3).to(out_dtype)


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


def patch_embed_plain(
    frames_u8: torch.Tensor, folded_w: torch.Tensor, bias: torch.Tensor, patch: int, out_dtype: torch.dtype
) -> torch.Tensor:
    """``_xla_patch_embed``: fp32 patches @ fp32 folded weight + bias, cast
    once to ``out_dtype``; the kernel's reference."""
    patches = extract_patches_u8(frames_u8, patch).float()
    return (torch.matmul(patches, folded_w) + bias).to(out_dtype)


_KERNEL_OUT_DTYPES = (torch.float32, torch.bfloat16)


@_kernels.counted
def fused_patch_embed(
    frames_u8: torch.Tensor,  # [N, H, W, 3] uint8
    patch_kernel: torch.Tensor,  # [P, P, 3, D]
    mean: np.ndarray,
    std: np.ndarray,
    out_dtype: torch.dtype = torch.float32,
    use_kernel: bool | None = None,
) -> torch.Tensor:
    """-> [N, L, D] patch embeddings with the normalization folded in.

    ``use_kernel`` mirrors JAX's ``use_pallas``: None (the default, as in
    JAX) and False compute the plain GEMM; True launches the CUDA kernel on a
    CUDA tensor, or raises on inputs it does not take, and on a CPU tensor
    computes the plain GEMM. ``fused_patch_embed.launches`` counts kernel
    launches."""
    if frames_u8.dim() != 4 or frames_u8.shape[-1] != 3 or frames_u8.dtype != torch.uint8:
        raise ValueError(f"frames must be uint8 [N, H, W, 3], got {frames_u8.dtype} {tuple(frames_u8.shape)}")
    P = patch_kernel.shape[0]
    if tuple(patch_kernel.shape[:3]) != (P, P, 3):
        raise ValueError(f"patch_kernel must be [P, P, 3, D], got {tuple(patch_kernel.shape)}")
    _, H, W, _ = frames_u8.shape
    if H % P or W % P:
        raise ValueError(f"frame size {H}x{W} is not a multiple of the patch size {P}")
    folded_w, bias = fold_normalization(patch_kernel, mean, std)
    if not use_kernel or frames_u8.device.type == "cpu":
        return patch_embed_plain(frames_u8, folded_w, bias, P, out_dtype)
    if frames_u8.device.type != "cuda":
        raise ValueError(f"fused_patch_embed's kernel runs on cuda tensors, got {frames_u8.device}")
    return _launch(frames_u8, folded_w, bias, P, out_dtype)


def _launch(frames_u8, folded_w, bias, patch, out_dtype) -> torch.Tensor:
    """Check what the kernel takes, allocate [N, L, D], launch, count."""
    if out_dtype not in _KERNEL_OUT_DTYPES:
        raise TypeError(f"fused_patch_embed kernel writes float32 or bfloat16, got {out_dtype}")
    D = folded_w.shape[1]
    if D % 4:
        raise ValueError(f"fused_patch_embed kernel takes an embedding dim that is a multiple of 4, got {D}")
    if folded_w.device != frames_u8.device:
        raise ValueError(f"frames on {frames_u8.device}, patch_kernel on {folded_w.device}")
    return torch.ops.xpt.patch_embed_u8(frames_u8.contiguous(), folded_w.contiguous(), bias.contiguous(), patch,
                                        out_dtype)


def _patch_launch(frames_u8, folded_w, bias, patch, out_dtype):
    """The body of ``xpt::patch_embed_u8``: allocates [N, L, D] in
    ``out_dtype``, launches, counts."""
    out = _patch_out(frames_u8, folded_w, patch, out_dtype)
    _kernels.patch_embed_u8(frames_u8, folded_w, bias, out, patch)
    fused_patch_embed.launches += 1
    return out


def _patch_out(frames_u8, folded_w, patch, out_dtype):
    N, H, W, _ = frames_u8.shape
    return frames_u8.new_empty((N, (H // patch) * (W // patch), folded_w.shape[1]), dtype=out_dtype)


_patch_op = torch.library.custom_op(
    "xpt::patch_embed_u8", _patch_launch, mutates_args=(), device_types="cuda",
    schema="(Tensor frames_u8, Tensor folded_w, Tensor bias, int patch, ScalarType out_dtype) -> Tensor",
)


@_patch_op.register_fake
def _(frames_u8, folded_w, bias, patch, out_dtype):
    return _patch_out(frames_u8, folded_w, patch, out_dtype)

