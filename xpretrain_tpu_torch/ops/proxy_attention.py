"""CLIP-ViP's proxy video attention: plain PyTorch version + CUDA kernel.

Counterpart of ``xpretrain_tpu/ops/proxy_attention.py``. The sequence is
[M proxy tokens | N frames x L patches], S = M + N*L: the proxies attend
everything, each frame's patches attend [proxies | own frame]
(ref ``CLIP-ViP/src/modeling/CLIP_ViP.py:332-381``).

- :func:`proxy_attention_plain` is ``_attention_xla``: one attention over S
  with an additive -1e9 block mask, fp32 scores and softmax, the weights cast
  to ``v.dtype`` before PV.
- :func:`proxy_attention` is the public entry (``proxy_flash_attention``).
  The tensor's device alone picks the path: a CPU tensor takes the plain
  version, a CUDA tensor the hand-written kernel ``csrc/proxy_attention_fwd.cu``
  (replacing the Pallas ``_attention_pallas``), or raises.
"""

from __future__ import annotations

import torch

from xpretrain_tpu_torch.ops import _kernels

NEG_INF = -1e9


def _proxy_bias(S: int, M: int, L: int, device: torch.device) -> torch.Tensor:
    """Additive 0/NEG_INF [S, S] fp32 mask, as ``_proxy_bias`` builds it."""
    i = torch.arange(S, device=device)
    frame = torch.div(i - M, L, rounding_mode="floor")
    allowed = (i[:, None] < M) | (i[None, :] < M) | (frame[:, None] == frame[None, :])
    zero = torch.zeros((), dtype=torch.float32, device=device)
    return torch.where(allowed, zero, torch.full_like(zero, NEG_INF))


def proxy_attention_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, M: int, L: int, scale: float
) -> torch.Tensor:
    """Masked full attention over [B, H, S, D]; the kernel's reference."""
    S = q.shape[-2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    scores = scores + _proxy_bias(S, M, L, q.device)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if torch.is_grad_enabled() and any(t.requires_grad for t in (q, k, v)):
        raise RuntimeError(
            "proxy_attention on CUDA has no backward kernel yet (ROADMAP Queue 1, "
            "training slice); run under torch.inference_mode() or torch.no_grad()"
        )
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"proxy_attention kernel takes float32 or bfloat16, got {q.dtype}")
    D = q.shape[-1]
    if D % 16 or D > 128:
        raise ValueError(f"proxy_attention kernel takes a head dim that is a multiple of 16 up to 128, got {D}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("proxy_attention kernel takes contiguous [B, H, S, D] tensors")


def proxy_attention(
    q: torch.Tensor,  # [B, H, S, D], S = M + N*L
    k: torch.Tensor,
    v: torch.Tensor,
    M: int,
    N: int,
    L: int,
    scale: float,
) -> torch.Tensor:
    """Proxy attention output [B, H, S, D] in q's dtype.

    ``proxy_attention.launches`` counts kernel launches (CUDA calls only)."""
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, H, S, D] shape: {q.shape}, {k.shape}, {v.shape}")
    if q.shape[2] != M + N * L:
        raise ValueError(f"S={q.shape[2]} != M + N*L = {M} + {N}*{L}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v devices differ: {q.device}, {k.device}, {v.device}")
    if q.device.type == "cpu":
        return proxy_attention_plain(q, k, v, M, L, scale)
    if q.device.type != "cuda":
        raise ValueError(f"proxy_attention runs on cpu or cuda tensors, got {q.device}")
    _check_kernel_inputs(q, k, v)
    out = torch.empty_like(q)
    _kernels.proxy_attention_fwd(q, k, v, out, M, N, L, scale)
    proxy_attention.launches += 1
    return out


proxy_attention.launches = 0
