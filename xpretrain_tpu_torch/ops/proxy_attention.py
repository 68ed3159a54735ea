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
  :func:`proxy_attention_lse_plain` is the fp32 log-sum-exp of each row's
  masked scores: the reference of the LSE the forward kernel saves for the
  backward.
- :func:`proxy_attention` is the public entry (``proxy_flash_attention``).
  The tensor's device alone picks the path: a CPU tensor takes the plain
  version under autograd; a CUDA tensor goes through ``_ProxyAttentionFn``
  (the counterpart of the ``jax.custom_vjp`` ``_flash``), whose forward
  launches ``csrc/proxy_attention_fwd.cu`` (replacing ``_attention_pallas``)
  and saves each row's LSE when a gradient will follow, and whose backward
  launches ``csrc/proxy_attention_bwd.cu`` on that LSE (replacing
  ``_attention_pallas_bwd``; :func:`proxy_attention_bwd` is the same kernel
  called alone, which computes the LSE itself). bf16 runs on the tensor
  cores, fp32 on the CUDA cores. A CUDA tensor the kernels do not take
  raises.
- :func:`proxy_attention_packed` (``proxy_flash_attention_packed``) is the
  same attention on the raw [B, S, H*D] projection layout. The same two
  kernels take it through their stride arguments, the head split happening
  in their load and store addresses (replacing ``_attention_pallas_packed``
  and ``_attention_pallas_bwd_packed``); its CPU path is split, plain,
  merge, as the JAX fallback.

Each kernel launches inside a ``torch.library`` custom op,
``xpt::proxy_attention_fwd`` and ``xpt::proxy_attention_bwd`` (``head_dim``
0 for [B, H, S, D], else the packed layout), so that ``torch.export`` and
``torch.compile`` trace through it: the op's fake gives the output's shape,
dtype and strides, its real body checks what ``cp.async`` needs, launches
and counts the launch on the public wrapper (in eager code, in an exported
program and at a captured graph's capture alike). A call that needs no
gradient calls the forward op directly; one that does goes through
``_ProxyAttentionFn``, whose backward calls the backward op on the forward's
LSE. :func:`force_plain_attention` is the one way to run the plain version
on CUDA tensors: an artifact exported with ``attention="plain"``.
"""

from __future__ import annotations

import contextlib

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


def proxy_attention_cost(
    B: int, H: int, S: int, D: int, M: int, L: int, itemsize: int, backward: bool = False
) -> tuple[int, int, int]:
    """Analytic (flops, bytes, exps) of one kernel call, as
    ``xpretrain_tpu/ops/proxy_attention.py:proxy_attention_cost``.

    FLOPs: per (b, h) the proxy-row block (QK^T + PV over [M, S]:
    ``4*M*S*D``) plus N frame blocks ([L, M+L]: ``4*L*(M+L)*D`` each); the
    backward's five products are 2.5x that. Bytes: q/k/v (+dO) read once,
    o (dq/dk/dv) written once. One exp per allowed score."""
    N = (S - M) // L
    score_elems = B * H * (M * S + N * L * (M + L))
    matmul_flops = 4 * score_elems * D
    n_tensors = 7 if backward else 4
    flops = (matmul_flops * 5) // 2 if backward else matmul_flops
    return flops, n_tensors * B * H * S * D * itemsize, score_elems


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


def proxy_attention_lse_plain(q: torch.Tensor, k: torch.Tensor, M: int, L: int, scale: float) -> torch.Tensor:
    """fp32 [B, H, S] log-sum-exp of each row's masked scores: the reference
    of the LSE the forward kernel writes."""
    S = q.shape[-2]
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale + proxy_bias(S, M, L, q.device)
    return torch.logsumexp(scores, dim=-1)


def _heads(x: torch.Tensor, head_dim: int) -> torch.Tensor:
    """The [B, H, S, D] head view of a packed [B, S, H*D] tensor (no copy)."""
    B, S, E = x.shape
    return x.view(B, S, E // head_dim, head_dim).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    """[B, H, S, D] -> packed [B, S, H*D]."""
    B, H, S, D = x.shape
    return x.transpose(1, 2).reshape(B, S, H * D)


def proxy_attention_packed_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, M: int, L: int, scale: float, head_dim: int
) -> torch.Tensor:
    """Split heads, :func:`proxy_attention_plain`, merge: the JAX fallback of
    ``proxy_flash_attention_packed``; the packed kernels' reference."""
    return _merge_heads(proxy_attention_plain(*(_heads(t, head_dim) for t in (q, k, v)), M, L, scale))


def proxy_attention_packed_bwd_plain(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d_out: torch.Tensor,
    M: int, L: int, scale: float, head_dim: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) in the packed layout from :func:`proxy_attention_bwd_plain`."""
    grads = proxy_attention_bwd_plain(*(_heads(t, head_dim) for t in (q, k, v, d_out)), M, L, scale)
    return tuple(_merge_heads(g) for g in grads)


_KERNEL_DTYPES = (torch.float32, torch.bfloat16)


def _check_kernel_dtype_and_head_dim(dtype: torch.dtype, D: int) -> None:
    if dtype not in _KERNEL_DTYPES:
        raise TypeError(f"proxy_attention kernel takes float32 or bfloat16, got {dtype}")
    if D % 16 or D > 128:
        raise ValueError(f"proxy_attention kernel takes a head dim that is a multiple of 16 up to 128, got {D}")


def _check_kernel_inputs(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor) -> None:
    _check_kernel_dtype_and_head_dim(q.dtype, q.shape[-1])
    if not all(t.is_contiguous() for t in (q, k, v)):
        raise ValueError("proxy_attention kernel takes contiguous [B, H, S, D] tensors")


def _check_cp_async(*views: torch.Tensor) -> None:
    """What the bf16 kernels' 16-byte ``cp.async`` loads need of each
    [B, H, S, D] view (``_kernels.check_cp_async``)."""
    _kernels.check_cp_async("proxy_attention bf16 kernels", *views)


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
    """Kernel forward, kernel backward, through the two ops; q/k/v and, when
    a gradient will follow, each row's LSE are saved, P is recomputed."""

    @staticmethod
    def forward(ctx, q, k, v, M, N, L, scale):
        out, lse = _launch_fwd(q, k, v, M, N, L, scale, with_lse=any(ctx.needs_input_grad[:3]))
        ctx.save_for_backward(q, k, v, lse)
        ctx.dims = (M, N, L, scale)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, lse = ctx.saved_tensors
        # the model's head merge hands the gradient over as a strided view
        dq, dk, dv = _launch_bwd(q, k, v, d_out.contiguous(), *ctx.dims, lse=lse)
        return dq, dk, dv, None, None, None, None


class _ProxyAttentionPackedFn(torch.autograd.Function):
    """``_ProxyAttentionFn`` on the packed [B, S, H*D] layout (the
    ``jax.custom_vjp`` ``_flash_packed``): the same two ops, reading and
    writing the packed tensors through their head strides."""

    @staticmethod
    def forward(ctx, q, k, v, M, N, L, scale, head_dim):
        out, lse = _launch_fwd(q, k, v, M, N, L, scale, head_dim, with_lse=any(ctx.needs_input_grad[:3]))
        ctx.save_for_backward(q, k, v, lse)
        ctx.dims = (M, N, L, scale, head_dim)
        return out

    @staticmethod
    def backward(ctx, d_out):
        q, k, v, lse = ctx.saved_tensors
        # autograd may hand the gradient over strided; the kernel reads it as
        # packed [B, S, H*D], like q, k and v
        dq, dk, dv = _launch_bwd(q, k, v, d_out.contiguous(), *ctx.dims, lse=lse)
        return dq, dk, dv, None, None, None, None, None


def _attend(q, k, v, M: int, N: int, L: int, scale: float, head_dim: int) -> torch.Tensor:
    """The CUDA branch of the two forward entries, checked already: through
    autograd when a gradient will follow, else the forward op alone (what
    ``torch.export`` traces under ``no_grad``)."""
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
        if head_dim:
            return _ProxyAttentionPackedFn.apply(q, k, v, M, N, L, scale, head_dim)
        return _ProxyAttentionFn.apply(q, k, v, M, N, L, scale)
    return _launch_fwd(q, k, v, M, N, L, scale, head_dim)[0]


_PLAIN_ON_CUDA = [False]  # set while inside force_plain_attention()


@contextlib.contextmanager
def force_plain_attention():
    """While inside, :func:`proxy_attention` and
    :func:`proxy_attention_packed` compute their plain versions on CUDA
    tensors too (JAX's ``force_xla_attention``): what an artifact exported
    with ``attention="plain"`` holds. Nothing else routes a CUDA tensor to
    the plain version."""
    before, _PLAIN_ON_CUDA[0] = _PLAIN_ON_CUDA[0], True
    try:
        yield
    finally:
        _PLAIN_ON_CUDA[0] = before


@_kernels.counted
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
    if q.device.type == "cpu" or (q.device.type == "cuda" and _PLAIN_ON_CUDA[0]):
        return proxy_attention_plain(q, k, v, M, L, scale)
    if q.device.type != "cuda":
        raise ValueError(f"proxy_attention runs on cpu or cuda tensors, got {q.device}")
    _check_kernel_inputs(q, k, v)
    return _attend(q, k, v, M, N, L, scale, 0)



@_kernels.counted
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
    ``d_out``, each [B, H, S, D] in q's dtype (``_attention_pallas_bwd``'s
    signature: on CUDA the kernel first computes each row's LSE itself).

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



def _check_packed_shapes(q, k, v, M: int, N: int, L: int, head_dim: int) -> None:
    if q.dim() != 3 or k.shape != q.shape or v.shape != q.shape:
        raise ValueError(f"q/k/v must share one [B, S, H*D] shape: {q.shape}, {k.shape}, {v.shape}")
    if q.shape[1] != M + N * L:
        raise ValueError(f"S={q.shape[1]} != M + N*L = {M} + {N}*{L}")
    if head_dim < 1 or q.shape[2] % head_dim:
        raise ValueError(f"the feature dim {q.shape[2]} is not a multiple of head_dim={head_dim}")
    if not (q.dtype == k.dtype == v.dtype):
        raise TypeError(f"q/k/v dtypes differ: {q.dtype}, {k.dtype}, {v.dtype}")
    if not (q.device == k.device == v.device):
        raise ValueError(f"q/k/v devices differ: {q.device}, {k.device}, {v.device}")


def _check_packed_kernel_inputs(head_dim: int, *tensors: torch.Tensor) -> None:
    _check_kernel_dtype_and_head_dim(tensors[0].dtype, head_dim)
    if not all(t.is_contiguous() for t in tensors):
        raise ValueError("proxy_attention_packed kernel takes contiguous [B, S, H*D] tensors")


@_kernels.counted
def proxy_attention_packed(
    q: torch.Tensor,  # [B, S, H*D] raw projection output, S = M + N*L
    k: torch.Tensor,
    v: torch.Tensor,
    M: int,
    N: int,
    L: int,
    scale: float,
    head_dim: int,
) -> torch.Tensor:
    """Proxy attention in the packed [B, S, H*D] layout, output [B, S, H*D]
    in q's dtype; equal to split heads, :func:`proxy_attention`, merge.

    Differentiable in q, k and v: on CUDA the gradient comes from the backward
    kernel. ``proxy_attention_packed.launches`` counts forward kernel launches
    (CUDA calls only)."""
    _check_packed_shapes(q, k, v, M, N, L, head_dim)
    if q.device.type == "cpu" or (q.device.type == "cuda" and _PLAIN_ON_CUDA[0]):
        return proxy_attention_packed_plain(q, k, v, M, L, scale, head_dim)
    if q.device.type != "cuda":
        raise ValueError(f"proxy_attention_packed runs on cpu or cuda tensors, got {q.device}")
    _check_packed_kernel_inputs(head_dim, q, k, v)
    return _attend(q, k, v, M, N, L, scale, head_dim)



@_kernels.counted
def proxy_attention_packed_bwd(
    q: torch.Tensor,  # [B, S, H*D], S = M + N*L
    k: torch.Tensor,
    v: torch.Tensor,
    d_out: torch.Tensor,
    M: int,
    N: int,
    L: int,
    scale: float,
    head_dim: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dq, dk, dv) of :func:`proxy_attention_packed` for the output gradient
    ``d_out``, each [B, S, H*D] in q's dtype.

    ``proxy_attention_packed_bwd.launches`` counts kernel launches, from here
    and from autograd through :func:`proxy_attention_packed` (CUDA only)."""
    _check_packed_shapes(q, k, v, M, N, L, head_dim)
    if d_out.shape != q.shape or d_out.dtype != q.dtype or d_out.device != q.device:
        raise ValueError(
            f"d_out {tuple(d_out.shape)} {d_out.dtype} {d_out.device} does not match "
            f"q {tuple(q.shape)} {q.dtype} {q.device}"
        )
    if q.device.type == "cpu":
        return proxy_attention_packed_bwd_plain(q, k, v, d_out, M, L, scale, head_dim)
    if q.device.type != "cuda":
        raise ValueError(f"proxy_attention_packed_bwd runs on cpu or cuda tensors, got {q.device}")
    _check_packed_kernel_inputs(head_dim, q, k, v, d_out)
    return _launch_bwd(q, k, v, d_out, M, N, L, scale, head_dim)



def _head_views(head_dim: int, *tensors: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """[B, H, S, D] tensors as they are (``head_dim`` 0), or the head views
    of packed [B, S, H*D] ones."""
    return tensors if not head_dim else tuple(_heads(t, head_dim) for t in tensors)


def _fwd_launch(q, k, v, M, N, L, scale, head_dim, with_lse):
    """The body of ``xpt::proxy_attention_fwd``: the forward kernel on
    [B, H, S, D] tensors or, given ``head_dim``, on packed [B, S, H*D] ones
    through their head views; counts the launch. Returns the output and,
    ``with_lse``, each row's fp32 [B, H, S] LSE (else an empty [0])."""
    out = torch.empty_like(q)
    views = _head_views(head_dim, q, k, v, out)
    _check_cp_async(*views)
    B, H, S, _ = views[0].shape
    lse = torch.empty((B, H, S) if with_lse else (0,), dtype=torch.float32, device=q.device)
    _kernels.proxy_attention_fwd(*views, lse if with_lse else None, M, N, L, scale)
    (proxy_attention_packed if head_dim else proxy_attention).launches += 1
    return out, lse


def _bwd_launch(q, k, v, d_out, lse, M, N, L, scale, head_dim):
    """The body of ``xpt::proxy_attention_bwd``: the backward kernel, laid
    out as :func:`_fwd_launch`, on the forward's fp32 [B, H, S] ``lse`` or,
    when it is None, on an LSE the kernel computes first (into scratch);
    delta is fp32 [B, H, S] scratch. Counts the launch."""
    grads = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    views = _head_views(head_dim, q, k, v, d_out, *grads)
    _check_cp_async(*views)
    B, H, S, _ = views[0].shape
    lse_given = lse is not None
    if not lse_given:
        lse = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    delta = torch.empty((B, H, S), dtype=torch.float32, device=q.device)
    _kernels.proxy_attention_bwd(*views, lse, delta, lse_given, M, N, L, scale)
    (proxy_attention_packed_bwd if head_dim else proxy_attention_bwd).launches += 1
    return grads


_fwd_op = torch.library.custom_op(
    "xpt::proxy_attention_fwd", _fwd_launch, mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, int M, int N, int L, float scale, int head_dim, bool with_lse)"
           " -> (Tensor, Tensor)",
)
_bwd_op = torch.library.custom_op(
    "xpt::proxy_attention_bwd", _bwd_launch, mutates_args=(), device_types="cuda",
    schema="(Tensor q, Tensor k, Tensor v, Tensor d_out, Tensor? lse, int M, int N, int L, float scale,"
           " int head_dim) -> (Tensor, Tensor, Tensor)",
)


@_fwd_op.register_fake
def _(q, k, v, M, N, L, scale, head_dim, with_lse):
    B, H, S, _ = _head_views(head_dim, q)[0].shape
    return torch.empty_like(q), q.new_empty((B, H, S) if with_lse else (0,), dtype=torch.float32)


@_bwd_op.register_fake
def _(q, k, v, d_out, lse, M, N, L, scale, head_dim):
    return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)


def _launch_fwd(q, k, v, M, N, L, scale, head_dim=None, with_lse=False):
    """The forward op alone: the output and, ``with_lse``, each row's LSE
    (else None)."""
    out, lse = torch.ops.xpt.proxy_attention_fwd(q, k, v, M, N, L, scale, head_dim or 0, with_lse)
    return out, (lse if with_lse else None)


def _launch_bwd(q, k, v, d_out, M, N, L, scale, head_dim=None, lse=None):
    """The backward op alone, on the forward's ``lse`` or, when None, on an
    LSE the kernel computes first."""
    return torch.ops.xpt.proxy_attention_bwd(q, k, v, d_out, lse, M, N, L, scale, head_dim or 0)
