"""HD-VILA's frozen batch norm with its ReLU and residual add: plain PyTorch
version + CUDA kernel.

``y = act(x * inv + shift [+ identity])`` over [N, C, H, W] maps, ``act``
ReLU or none, where ``inv = rsqrt(var + eps) * scale`` and ``shift = bias -
mean * inv`` are the fp32 per-channel vectors of
``models/hd_vila/resnet.py:FrozenBatchNorm``, rounded to the activation
dtype before they meet the maps (flax's FrozenBN, ``inv.to(x.dtype)``). The
JAX package has no kernel here: XLA fuses the affine, the ReLU and the add.

- :func:`frozen_bn_act_plain` is the module's formula, then the residual add
  and ``F.relu``: what a CPU tensor computes, and the kernel's reference.
  :func:`frozen_bn_act_bwd_plain` is the backward kernel's reference.
- :func:`frozen_bn_act` is the entry the ResNets call. The tensor's device
  alone picks the path: a CPU tensor takes the plain version under autograd;
  a CUDA tensor (bf16 or fp32) goes through ``_FrozenBnActFn``, whose
  forward launches ``csrc/frozen_bn_act.cu`` once (the affine, the add and
  the ReLU in one pass over channels_last maps, each product and sum in fp32
  and one rounding) and whose backward launches it once more (dx, the
  identity's gradient and, unless the parameters are frozen, the fp32
  per-channel sums Σ g·mask·x and Σ g·mask that autograd carries on to
  ``scale``, ``bias``, ``mean`` and ``var``), plus a launch that adds the
  sums' per-block partials in a fixed order. Any other CUDA tensor raises.
  A map that is not channels_last is made so first (cuDNN's convolutions
  return channels_last ones on the main path).

The two kernels launch inside the ``torch.library`` operators
``xpt::frozen_bn_act_fwd`` and ``xpt::frozen_bn_act_bwd`` (a fake each), so
that ``torch.export`` traces through them. ``frozen_bn_act.launches`` counts the
kernel launches (forward 1, backward 1 or 2); the counters
``xpt.frozen_bn.kernel`` and ``xpt.frozen_bn.plain``
(``utils/profiling.py:counts``) count the calls that took each path.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

from xpretrain_tpu_torch.ops import _kernels
from xpretrain_tpu_torch.utils.profiling import count

_KERNEL_DTYPES = (torch.float32, torch.bfloat16)
_CL = torch.channels_last


def frozen_bn_act_plain(
    x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor, relu: bool = False,
    identity: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """``act(x * inv + shift [+ identity])`` as eager PyTorch computes it:
    ``inv`` and ``shift`` cast to x's dtype, each op rounded to it."""
    dt = x.dtype
    y = x * inv.to(dt)[:, None, None] + shift.to(dt)[:, None, None]
    if identity is not None:
        y = y + identity
    return F.relu(y) if relu else y


def frozen_bn_act_bwd_plain(
    g: torch.Tensor, y: Optional[torch.Tensor], x: Optional[torch.Tensor], inv: torch.Tensor,
    identity_grad: bool,
) -> tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """(dx, d_identity, sums) of the forward kernel, as the backward kernel
    computes them, in fp32: ``gm = g * (y > 0)`` (just ``g`` when ``y`` is
    None: no ReLU), ``dx = gm * inv`` and ``d_identity = gm`` rounded once to
    g's dtype (``d_identity`` None unless ``identity_grad``), and, given the
    forward's input ``x``, ``sums`` [2, C] = (Σ gm·x, Σ gm) over N, H, W
    (else None)."""
    dt = g.dtype
    gm = g.float() if y is None else torch.where(y > 0, g.float(), 0.0)
    dx = (gm * inv.to(dt).float()[:, None, None]).to(dt)
    d_identity = gm.to(dt) if identity_grad else None
    sums = None if x is None else torch.stack([(gm * x.float()).sum((0, 2, 3)), gm.sum((0, 2, 3))])
    return dx, d_identity, sums


def _check(x: torch.Tensor, inv: torch.Tensor, shift: torch.Tensor, identity: Optional[torch.Tensor]) -> None:
    if x.dim() != 4:
        raise ValueError(f"frozen_bn_act takes [N, C, H, W] maps, got {tuple(x.shape)}")
    C = x.shape[1]
    if inv.shape != (C,) or shift.shape != (C,):
        raise ValueError(f"inv {tuple(inv.shape)} and shift {tuple(shift.shape)} must be [{C}]")
    if identity is not None and (identity.shape != x.shape or identity.dtype != x.dtype
                                 or identity.device != x.device):
        raise ValueError(f"identity {tuple(identity.shape)} {identity.dtype} {identity.device} does not match "
                         f"x {tuple(x.shape)} {x.dtype} {x.device}")


class _FrozenBnActFn(torch.autograd.Function):
    """Kernel forward, kernel backward, through the two ops. Saved: the
    output when the ReLU's mask is needed, x when the parameters take
    gradients (both maps autograd saved before the fusion too)."""

    @staticmethod
    def forward(ctx, x, inv, shift, identity, relu):
        y = torch.ops.xpt.frozen_bn_act_fwd(x, inv, shift, identity, relu)
        param_grads = ctx.needs_input_grad[1] or ctx.needs_input_grad[2]
        ctx.save_for_backward(y if relu else None, x if param_grads else None, inv)
        ctx.identity_grad = identity is not None and ctx.needs_input_grad[3]
        return y

    @staticmethod
    def backward(ctx, g):
        y, x, inv = ctx.saved_tensors
        dx, d_identity, sums = torch.ops.xpt.frozen_bn_act_bwd(g.contiguous(memory_format=_CL), y, x, inv,
                                                               ctx.identity_grad)
        d_inv, d_shift = (None, None) if x is None else sums.unbind(0)
        return dx, d_inv, d_shift, d_identity if ctx.identity_grad else None, None


@_kernels.counted
def frozen_bn_act(
    x: torch.Tensor,  # [N, C, H, W]
    inv: torch.Tensor,  # fp32 [C]
    shift: torch.Tensor,  # fp32 [C]
    relu: bool = False,
    identity: Optional[torch.Tensor] = None,  # like x
) -> torch.Tensor:
    """``act(x * inv + shift [+ identity])`` in x's dtype, differentiable in
    x, inv, shift and identity: the plain version on the CPU, the kernels on
    CUDA (module docstring). ``frozen_bn_act.launches`` counts kernel
    launches (CUDA calls only)."""
    _check(x, inv, shift, identity)
    if x.device.type == "cpu":
        count("xpt.frozen_bn.plain")
        return frozen_bn_act_plain(x, inv, shift, relu, identity)
    if x.device.type != "cuda":
        raise ValueError(f"frozen_bn_act runs on cpu or cuda tensors, got {x.device}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"frozen_bn_act kernel takes float32 or bfloat16 maps, got {x.dtype}")
    count("xpt.frozen_bn.kernel")
    x = x.contiguous(memory_format=_CL)
    identity = None if identity is None else identity.contiguous(memory_format=_CL)
    inv, shift = inv.float().contiguous(), shift.float().contiguous()
    if torch.is_grad_enabled() and any(t is not None and t.requires_grad for t in (x, inv, shift, identity)):
        return _FrozenBnActFn.apply(x, inv, shift, identity, relu)
    return torch.ops.xpt.frozen_bn_act_fwd(x, inv, shift, identity, relu)


def _check_layout(*maps: Optional[torch.Tensor]) -> None:
    for t in maps:
        if t is not None and not t.is_contiguous(memory_format=_CL):
            raise ValueError(f"frozen_bn_act kernels take channels_last maps, got strides {t.stride()}")


def _fwd_launch(x, inv, shift, identity, relu):
    """The body of ``xpt::frozen_bn_act_fwd``: allocates y like x, launches,
    counts."""
    _check_layout(x, identity)
    y = torch.empty_like(x)
    _kernels.frozen_bn_act_fwd(x, identity, inv, shift, y, relu)
    frozen_bn_act.launches += 1
    return y


def _bwd_launch(g, y, x, inv, identity_grad):
    """The body of ``xpt::frozen_bn_act_bwd``: allocates dx, d_identity (an
    empty [0] unless ``identity_grad``) and the fp32 [2, C] sums (empty [0]
    when ``x`` is None: no parameter gradients), launches, counts."""
    _check_layout(g, y, x)
    dx, d_identity, sums = _bwd_out(g, x, identity_grad)
    _kernels.frozen_bn_act_bwd(g, y, x, inv, dx, d_identity if identity_grad else None,
                               None if x is None else sums)
    frozen_bn_act.launches += 1 if x is None else 2
    return dx, d_identity, sums


def _bwd_out(g, x, identity_grad):
    return (torch.empty_like(g), torch.empty_like(g) if identity_grad else g.new_empty((0,)),
            g.new_empty((2, g.shape[1]) if x is not None else (0,), dtype=torch.float32))


# Defined and given their CUDA kernels through ``torch.library.Library``, not
# ``torch.library.custom_op``: the latter wraps each body in
# ``torch._disable_dynamo``, whose first call imports ``torch._dynamo``; on
# an H100 host that import took ~10 s of an HD-VILA training process's
# set-up, which calls no other op of this kind.
_lib = torch.library.Library("xpt", "FRAGMENT")
_lib.define("frozen_bn_act_fwd(Tensor x, Tensor inv, Tensor shift, Tensor? identity, bool relu) -> Tensor")
_lib.define("frozen_bn_act_bwd(Tensor g, Tensor? y, Tensor? x, Tensor inv, bool identity_grad)"
            " -> (Tensor, Tensor, Tensor)")
_lib.impl("frozen_bn_act_fwd", _fwd_launch, "CUDA")
_lib.impl("frozen_bn_act_bwd", _bwd_launch, "CUDA")


@torch.library.register_fake("xpt::frozen_bn_act_fwd", lib=_lib)
def _(x, inv, shift, identity, relu):
    return torch.empty_like(x)


@torch.library.register_fake("xpt::frozen_bn_act_bwd", lib=_lib)
def _(g, y, x, inv, identity_grad):
    return _bwd_out(g, x, identity_grad)
