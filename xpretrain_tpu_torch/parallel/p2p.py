"""The ring shift over a group: JAX's ``lax.ppermute`` with the permutation
``[(i, (i + 1) % p)]`` that ring attention
(``xpretrain_tpu/ops/ring_attention.py:55``) and the GPipe pipeline
(``xpretrain_tpu/parallel/pipeline.py:103``) hand their blocks on with.

Rank ``i`` of the group sends each tensor to rank ``(i + 1) % p`` and
receives the tensors of rank ``(i - 1) % p``, all in one batch of
point-to-point operations (``dist.batch_isend_irecv``, group ranks mapped to
global ones). Its transpose, and so its backward, is the inverse shift.
"""

from __future__ import annotations

from typing import Optional, Sequence

import torch
import torch.distributed as dist


def shift(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup], step: int = 1
          ) -> tuple[torch.Tensor, ...]:
    """Each of ``tensors`` from this rank to the rank ``step`` places on in
    ``group``, in one batch of sends and receives; returns the tensors the
    rank ``step`` places back sent. Every rank of the group must call it
    with tensors of the same shapes and dtypes, in the same order. No group
    (an axis of one rank): the inputs, unchanged, and nothing is launched.
    Not differentiable: :func:`ring_shift` is."""
    if group is None:
        return tuple(tensors)
    size, rank = dist.get_world_size(group), dist.get_rank(group)
    dst = dist.get_global_rank(group, (rank + step) % size)
    src = dist.get_global_rank(group, (rank - step) % size)
    outs = tuple(torch.empty_like(t, memory_format=torch.contiguous_format) for t in tensors)
    ops = []
    for t, out in zip(tensors, outs):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), dst, group))
        ops.append(dist.P2POp(dist.irecv, out, src, group))
    for request in dist.batch_isend_irecv(ops):
        request.wait()
    return outs


class _RingShift(torch.autograd.Function):
    """:func:`shift` by ``step``; the backward shifts the gradients of the
    inputs that need one by ``-step``."""

    @staticmethod
    def forward(ctx, group, step: int, *tensors: torch.Tensor):
        ctx.group, ctx.step = group, step
        outs = shift(tensors, group, step)
        ctx.mark_non_differentiable(*(o for o, need in zip(outs, ctx.needs_input_grad[2:]) if not need))
        return outs

    @staticmethod
    def backward(ctx, *grads: torch.Tensor):
        need = ctx.needs_input_grad[2:]
        moved = iter(shift([g for g, n in zip(grads, need) if n], ctx.group, -ctx.step))
        return (None, None, *(next(moved) if n else None for n in need))


def ring_shift(tensors: Sequence[torch.Tensor], group: Optional[dist.ProcessGroup]) -> tuple[torch.Tensor, ...]:
    """``lax.ppermute(x, axis, [(i, (i + 1) % p) for i in range(p)])`` for
    each of ``tensors``, in one call: one autograd node and one batch of
    point-to-point operations, whose backward sends each gradient back to
    the rank its tensor came from. ``group`` is the axis's group (None for
    an axis of one rank: the inputs are returned unchanged)."""
    if group is None:
        return tuple(tensors)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _RingShift.apply(group, 1, *tensors)
    return shift(tensors, group, 1)


__all__ = ["ring_shift", "shift"]
