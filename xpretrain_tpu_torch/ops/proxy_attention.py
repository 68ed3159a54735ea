"""CLIP-ViP's proxy video attention: plain PyTorch version + CUDA kernel.

Counterpart of ``xpretrain_tpu/ops/proxy_attention.py``. The sequence is
[M proxy tokens | N frames x L patches], S = M + N*L: the proxies attend
everything, each frame's patches attend [proxies | own frame]
(ref ``CLIP-ViP/src/modeling/CLIP_ViP.py:332-381``).

- :func:`proxy_attention_plain` is ``_attention_xla``: one attention over S
  with an additive -1e9 block mask, fp32 scores and softmax, the weights cast
  to ``v.dtype`` before PV.
- :func:`proxy_attention_bwd_plain` is ``_cell_bwd``'s math written out over
  the masked full S x S in fp32: the backward kernel's reference.
- :func:`proxy_attention` is the public entry (``proxy_flash_attention``).
  The tensor's device alone picks the path: a CPU tensor takes the plain
  version under autograd; a CUDA tensor goes through ``_ProxyAttentionFn``
  (the counterpart of the ``jax.custom_vjp`` ``_flash``), whose forward
  launches ``csrc/proxy_attention_fwd.cu`` (replacing ``_attention_pallas``)
  and whose backward launches ``csrc/proxy_attention_bwd.cu`` through
  :func:`proxy_attention_bwd` (replacing ``_attention_pallas_bwd``). A CUDA
  tensor the kernels do not take raises.
"""

from __future__ import annotations

import torch

from xpretrain_tpu_torch.ops import _kernels

NEG_INF = -1e9


def proxy_bias(S: int, M: int, L: int, device: torch.device) -> torch.Tensor:
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
    scores = scores + proxy_bias(S, M, L, q.device)
    weights = torch.softmax(scores, dim=-1).to(v.dtype)
    return torch.matmul(weights, v)


def proxy_attention_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d_out: torch.Tensor,
    M: int, L: int, scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of proxy attention in q's dtype, from fp32 math over the
    masked full [S, S]: dV = P^T dO, dP = dO V^T, dS = P * (dP - rowsum(dP * P)),
    dQ = dS K s, dK = dS^T Q s (``_cell_bwd``); the backward kernel's reference."""
    S = q.shape[-2]
    qf, kf, vf, dof = (t.float() for t in (q, k, v, d_out))
    scores = torch.matmul(qf, kf.transpose(-1, -2)) * scale + proxy_bias(S, M, L, q.device)
    p = torch.softmax(scores, dim=-1)
    dv = torch.matmul(p.transpose(-1, -2), dof)
    dp = torch.matmul(dof, vf.transpose(-1, -2))
    ds = p * (dp - (dp * p).sum(dim=-1, keepdim=True))
    dq = torch.matmul(ds, kf) * scale
    dk = torch.matmul(ds.transpose(-1, -2), qf) * scale
    return dq.to(q.dtype), dk.to(q.dtype), dv.to(q.dtype)


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    if q.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"proxy_attention kernel takes float32 or bfloat16, got {q.dtype}")
    D = q.shape[-1]
    if D % 16 or D > 128:
        raise ValueError(f"proxy_attention kernel takes a head dim that is a multiple of 16 up to 128, got {D}")
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("proxy_attention kernel takes contiguous [B, H, S, D] tensors")


def _check_shapes(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, M: int, N: int, L: int) -> None:
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, H, S, D] shape: {q.shape}, {k.shape}, {v.shape}")
    if q.shape[2] != M + N * L:
        raise ValueError(f"S={q.shape[2]} != M + N*L = {M} + {N}*{L}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v devices differ: {q.device}, {k.device}, {v.device}")


class _ProxyAttentionFn(torch.autograd.Function):
    """Kernel forward, kernel backward; q/k/v are saved, P is recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, M, N, L, scale):
        out = torch.empty_like(q)
        _kernels.proxy_attention_fwd(q, k, v, out, M, N, L, scale)
        proxy_attention.launches += 1
        ctx.save_for_backward(q, k, v)
        ctx.dims = (M, N, L, scale)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v = ctx.saved_tensors
        # the model's head merge hands the gradient over as a strided view
        dq, dk, dv = _launch_bwd(q, k, v, d_out.contiguous(), *ctx.dims)
        return dq, dk, dv, None, None, None, None


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

    Differentiable in q, k and v: on CUDA the gradient comes from the backward
    kernel. ``proxy_attention.launches`` counts forward kernel launches (CUDA
    calls only)."""
    _check_shapes(q, k, v, M, N, L)
    if q.device.type == "cpu":
        return proxy_attention_plain(q, k, v, M, L, scale)
    if q.device.type != "cuda":
        raise ValueError(f"proxy_attention runs on cpu or cuda tensors, got {q.device}")
    _check_kernel_inputs(q, k, v)
    return _ProxyAttentionFn.apply(q, k, v, M, N, L, scale)


proxy_attention.launches = 0


def proxy_attention_bwd(
    q: torch.Tensor,  # [B, H, S, D], S = M + N*L
    k: torch.Tensor,
    v: torch.Tensor,
    d_out: torch.Tensor,
    M: int,
    N: int,
    L: int,
    scale: float,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`proxy_attention` for the output gradient
    ``d_out``, each [B, H, S, D] in q's dtype.

    ``proxy_attention_bwd.launches`` counts kernel launches (CUDA calls only)."""
    _check_shapes(q, k, v, M, N, L)
    if d_out.shape != q.shape or d_out.dtype != q.dtype or d_out.device != q.device:
        raise ValueError(
            f"d_out {tuple(d_out.shape)} {d_out.dtype} {d_out.device} does not match "
            f"q {tuple(q.shape)} {q.dtype} {q.device}"
        )
    if q.device.type == "cpu":
        return proxy_attention_bwd_plain(q, k, v, d_out, M, L, scale)
    if q.device.type != "cuda":
        raise ValueError(f"proxy_attention_bwd runs on cpu or cuda tensors, got {q.device}")
    _check_kernel_inputs(q, k, v)
    if not d_out.is_contiguous():
        raise ValueError("proxy_attention_bwd kernel takes a contiguous [B, H, S, D] d_out")
    return _launch_bwd(q, k, v, d_out, M, N, L, scale)


def _launch_bwd(q, k, v, d_out, M, N, L, scale):
    B, H, S, _ = q.shape
    dq, dk, dv = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    delta = torch.empty_like(lse)
    _kernels.proxy_attention_bwd(q, k, v, d_out, dq, dk, dv, lse, delta, M, N, L, scale)
    proxy_attention_bwd.launches += 1
    return dq, dk, dv


proxy_attention_bwd.launches = 0
