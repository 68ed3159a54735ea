"""Swin3D/HTWA window attention: plain PyTorch version + CUDA kernel.

Counterpart of ``xpretrain_tpu/ops/window_attention.py``. Window MSA works on
q/k/v [Bn, H, N, d] (Bn = batch x windows, N = tokens per window, up to 480):
scores QK^T d^-1/2 in fp32, plus the relative-position bias [H, N, N], plus
the shifted-window (or grouped-window) mask [nW, N, N] picked by ``bn % nW``,
an fp32 softmax, and PV.

- :func:`window_attention_plain` is ``window_attention_xla``: the weights are
  cast to ``v.dtype`` before PV, as there.
- :func:`window_attention` is the public entry. The tensor's device alone
  picks the path: a CPU tensor takes the plain version (with autograd); a
  CUDA tensor launches ``csrc/window_attention_fwd.cu`` (replacing
  ``window_attention_pallas``): bf16 on the tensor cores (scores, softmax
  and sums in fp32, P fed to PV as hi + lo bf16 terms), fp32 on the CUDA
  cores, rounded once at the store. It reads q/k/v through their strides,
  so views of one fused qkv projection are not copied. The kernel has no
  backward yet, so a CUDA call that needs a gradient raises; so does a CUDA
  tensor the kernel does not take. Nothing falls back to the plain version
  on the card.

The kernel launches inside the ``torch.library`` custom op
``xpt::window_attention_fwd``, so that ``torch.export`` traces through it:
its fake gives the output's shape, dtype and strides; its real body checks
what ``cp.async`` needs, launches and counts the launch on
:func:`window_attention`.
"""

from __future__ import annotations

from typing import Optional

import torch

from xpretrain_tpu_torch.ops import _kernels


def window_attention_plain(
    q: torch.Tensor,  # [Bn, H, N, d]
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # [H, N, N]
    mask: Optional[torch.Tensor] = None,  # [nW, N, N]; window w = bn % nW
) -> torch.Tensor:
    """Window attention [Bn, H, N, d] in v's dtype; the kernel's reference."""
    scale = q.shape[-1] ** -0.5
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = scores + bias[None].float()
    if mask is not None:
        nW = mask.shape[0]
        Bn = q.shape[0]
        scores = scores.view(Bn // nW, nW, *scores.shape[1:]) + mask[None, :, None].float()
        scores = scores.view(Bn, *scores.shape[2:])
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_inputs(q, k, v, bias, mask) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [Bn, H, N, d] shape: {q.shape}, {k.shape}, {v.shape}")
    Bn, H, N, _ = q.shape
    if tuple(bias.shape) != (H, N, N):
        raise ValueError(f"bias must be [H, N, N] = {(H, N, N)}, got {tuple(bias.shape)}")
    if mask is not None and (mask.dim() != 3 or tuple(mask.shape[1:]) != (N, N) or Bn % mask.shape[0]):
        raise ValueError(f"mask must be [nW, N, N] with nW dividing Bn={Bn}, got {tuple(mask.shape)}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    devices = {t.device for t in (q, k, v, bias) + (() if mask is None else (mask,))}
    if len(devices) != 1:
        raise ValueError(f"window_attention inputs lie on several devices: {devices}")


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"window_attention kernel takes float32 or bfloat16, got {q.dtype}")
    d = q.shape[-1]
    if d % 16 or d > 128:
        raise ValueError(f"window_attention kernel takes a head dim that is a multiple of 16 up to 128, got {d}")
    if any(t.stride(-1) != 1 for t in (q, k, v)):
        raise ValueError(f"window_attention kernel reads q/k/v with a unit stride on the head dim, got strides "
                         f"{q.stride()}, {k.stride()}, {v.stride()}")


@_kernels.counted
def window_attention(
    q: torch.Tensor,  # [Bn, H, N, d]
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # [H, N, N], fp32
    mask: Optional[torch.Tensor] = None,  # [nW, N, N], fp32
) -> torch.Tensor:
    """Window attention output [Bn, H, N, d] in q's dtype.

    ``window_attention.launches`` counts kernel launches (CUDA calls only).
    On CUDA, q/k/v may be strided views with a unit stride on d (read in
    place; bf16 views 16-byte aligned with strides that are multiples of 8,
    else it raises); a call under autograd that would need a gradient
    raises."""
    _check_inputs(q, k, v, bias, mask)
    if q.device.type == "cpu":
        return window_attention_plain(q, k, v, bias, mask)
    if q.device.type != "cuda":
        raise ValueError(f"window_attention runs on cpu or cuda tensors, got {q.device}")
    return _launch(q, k, v, bias, mask)



def _launch(q, k, v, bias, mask) -> torch.Tensor:
    """The CUDA branch: check, launch on the views as they are, count."""
    if torch.is_grad_enabled() and any(
        t.requires_grad for t in (q, k, v, bias) + (() if mask is None else (mask,))
    ):
        raise NotImplementedError(
            "the window-attention kernel has no backward (JAX's has none either; ROADMAP Queue 2 lists "
            "it beyond the TPU set): train with video_encoder.use_pallas_attention off, as JAX does"
        )
    _check_kernel_inputs(q, k, v)
    bias = bias.float().contiguous()
    mask = None if mask is None else mask.float().contiguous()
    return torch.ops.xpt.window_attention_fwd(q, k, v, bias, mask)


def _window_launch(q, k, v, bias, mask):
    """The body of ``xpt::window_attention_fwd``: q/k/v views as they are,
    contiguous fp32 bias and mask (or None); allocates [Bn, H, N, d],
    launches, counts."""
    _kernels.check_cp_async("window_attention bf16 kernel", q, k, v)
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _kernels.window_attention_fwd(q, k, v, bias, mask, out)
    window_attention.launches += 1
    return out


_window_op = torch.library.custom_op(
    "xpt::window_attention_fwd", _window_launch, mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, Tensor bias, Tensor? mask) -> Tensor",
)


@_window_op.register_fake
def _(q, k, v, bias, mask):
    return q.new_empty(q.shape)
