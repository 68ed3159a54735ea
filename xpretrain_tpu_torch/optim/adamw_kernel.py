"""GroupedAdamW's update as one hand-written multi-tensor CUDA pass
(``csrc/adamw_multi_tensor.cu``), its plain version and the leaf table.

On a card, :class:`~xpretrain_tpu_torch.optim.optimizer.GroupedAdamW` hands
every trained leaf to :func:`adamw_multi_tensor`; the CPU keeps its
``torch._foreach_*`` chain. The JAX package has no kernel here:
``fused_grouped_adamw`` is one XLA fusion.

- :func:`adamw_update_plain` is the kernel's arithmetic on one leaf in
  elementwise torch ops, in the kernel's order: the clip, both moments, the
  bias corrections, the decay and the parameter add, each rounded in fp32
  as the ``_foreach`` chain rounds it. It is the kernel's reference.
- :class:`LeafTable` is built once per optimizer, at its first update: each
  trained leaf's target, moments, size, chunks, group scalar and decay, in
  launches of up to :data:`MAX_LEAVES` leaves. A target that is not
  contiguous (a ZeRO-2 block along a later dimension) is updated in a
  contiguous copy of its own, copied in before the launches and back after.
- :func:`adamw_multi_tensor` launches the kernel over a table with a call's
  gradients, every group at once; a gradient that is not contiguous goes in
  as a contiguous copy. ``adamw_multi_tensor.launches`` counts the launches;
  a CUDA graph that captured them adds them at each replay.

Nothing traces the optimizer, so the launch is a plain ctypes call
(``ops/_kernels.py``), with no ``torch.library`` operator around it. The
counters ``xpt.adamw.kernel`` and ``xpt.adamw.plain``
(``utils/profiling.py:counts``) count the leaves that took each path.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from xpretrain_tpu_torch.ops import _kernels

CHUNK = _kernels.ADAMW_CHUNK  # elements a block updates
MAX_LEAVES = _kernels.ADAMW_MAX_LEAVES  # leaves one launch takes
MOMENT_DTYPES = (torch.float32, torch.bfloat16)  # the moments the kernel reads


class Hyper(NamedTuple):
    """The update's constants as fp32 values, as the ``_foreach`` ops round
    their Python scalars; ``max_norm`` None turns the clip off."""

    b1: float
    one_minus_b1: float
    b2: float
    one_minus_b2: float
    eps: float
    max_norm: Optional[float]


def hyper(b1: float, b2: float, eps: float, max_norm: Optional[float]) -> Hyper:
    """:class:`Hyper` from the optimizer's settings: ``1 - b`` is taken in
    float64, then each value rounded to fp32."""
    f32 = lambda x: float(np.float32(x))  # noqa: E731
    return Hyper(f32(b1), f32(1 - b1), f32(b2), f32(1 - b2), f32(eps), None if max_norm is None else f32(max_norm))


class Leaf(NamedTuple):
    p: torch.Tensor  # the target: the parameter (or its block), or its fp32 master
    g: torch.Tensor  # its gradient, fp32, unclipped
    m: torch.Tensor
    v: torch.Tensor
    scalar: int  # index of its group's -lr * mul in the optimizer's scalars
    wd: float  # its group's decay (0: none)


def adamw_update_plain(leaf: Leaf, scalars: torch.Tensor, gnorm: Optional[torch.Tensor], h: Hyper) -> None:
    """The kernel's arithmetic on one leaf, in place: ``scalars`` is
    [c1, c2, -lr * mul of each group], ``gnorm`` the global gradient norm
    (read only when ``h.max_norm`` is set). Moments of another dtype are
    updated in fp32 and stored rounded to nearest."""
    p, g, m, v = leaf.p, leaf.g.float(), leaf.m, leaf.v
    if h.max_norm is not None:
        # (g / gnorm) * max_norm when clipping, g / 1 * 1 (exact) when not
        keep = gnorm < h.max_norm
        one = torch.ones_like(gnorm)
        g = g.div(torch.where(keep, one, gnorm)).mul(torch.where(keep, one, torch.full_like(gnorm, h.max_norm)))
    mf = m.float().mul(h.b1).add(g.mul(h.one_minus_b1))
    vf = v.float().mul(h.b2).add(g.mul(g).mul(h.one_minus_b2))
    u = mf.div(scalars[0]).div(vf.div(scalars[1]).sqrt().add(h.eps))
    if leaf.wd:
        u = u.add(p.float().mul(leaf.wd))
    p.add_(u.mul(scalars[leaf.scalar]).to(p.dtype))
    m.copy_(mf)
    v.copy_(vf)


def chunk_table(numels: Sequence[int]) -> np.ndarray:
    """The first chunk of each leaf and, last, the number of chunks: int32
    [len(numels) + 1], leaf l owning chunks [table[l], table[l + 1]) of
    :data:`CHUNK` elements (its last one partial)."""
    chunks = (np.asarray(numels, dtype=np.int64) + CHUNK - 1) // CHUNK
    table = np.zeros(len(numels) + 1, dtype=np.int64)
    np.cumsum(chunks, out=table[1:])
    if table[-1] >= 2**31:
        raise ValueError(f"{table[-1]} chunks of {CHUNK} elements do not fit one launch's grid")
    return table.astype(np.int32)


class _Launch(NamedTuple):
    lo: int  # the launch's leaves are the table's [lo, hi)
    hi: int
    ptrs: np.ndarray  # uint64 [hi - lo, 4]: target, gradient (set each call), m, v
    numel: np.ndarray  # int64 [hi - lo]
    first_chunk: np.ndarray  # int32 [hi - lo + 1] (chunk_table)
    scalar: np.ndarray  # int32 [hi - lo]
    wd: np.ndarray  # float32 [hi - lo]


class LeafTable:
    """The kernel's view of one optimizer's trained leaves, built once: the
    targets and moments are fixed from the first update on
    (``master_weights`` and ``zero2_shard`` refuse to run after it), as a
    captured CUDA graph holds them. ``targets`` are what the update writes
    (a parameter, its block or its fp32 master), ``mu`` and ``nu`` the
    moments, ``scalars`` and ``wds`` each leaf's group's index into the
    optimizer's ``scalars`` and its decay, ``device`` where they all live.
    Raises on a leaf the kernel cannot take: a target not fp32, moments not
    fp32 or bf16, not one dtype for every moment, not contiguous, or a size
    or device that differs."""

    def __init__(self, targets: Sequence[torch.Tensor], mu: Sequence[torch.Tensor], nu: Sequence[torch.Tensor],
                 scalars: Sequence[int], wds: Sequence[float], device: torch.device):
        dtypes = {t.dtype for t in (*mu, *nu)}
        if len(dtypes) > 1 or not dtypes <= set(MOMENT_DTYPES):
            raise ValueError(f"the AdamW kernel reads every moment in one dtype of {MOMENT_DTYPES}, got {dtypes}")
        self.moment_bf16 = torch.bfloat16 in dtypes
        self.cuda = device.type == "cuda"
        self.numel = [t.numel() for t in targets]
        self.staged: list[tuple[torch.Tensor, torch.Tensor]] = []  # (target view, its contiguous copy)
        written = []
        for j, (p, m, v) in enumerate(zip(targets, mu, nu)):
            n = self.numel[j]
            if p.dtype != torch.float32 or n == 0 or m.numel() != n or v.numel() != n:
                raise ValueError(f"AdamW kernel: leaf {j} has a {p.dtype} target of {n} elements and moments of "
                                 f"{m.numel()} and {v.numel()}; it takes fp32 targets and moments of one size > 0")
            if any(t.device != device for t in (p, m, v)) or not (m.is_contiguous() and v.is_contiguous()):
                raise ValueError(f"AdamW kernel: leaf {j}'s target and moments must be on {device}, the moments "
                                 "contiguous")
            if not p.is_contiguous():
                self.staged.append((p, torch.empty(p.shape, dtype=p.dtype, device=device)))
                p = self.staged[-1][1]
            written.append(p)
        self.targets, self.mu, self.nu = written, list(mu), list(nu)  # held: the table keeps their addresses
        self.parts = []
        for lo in range(0, len(written), MAX_LEAVES):
            hi = min(lo + MAX_LEAVES, len(written))
            ptrs = np.zeros((hi - lo, 4), dtype=np.uint64)
            for col, ts in ((0, written), (2, mu), (3, nu)):
                ptrs[:, col] = [t.data_ptr() for t in ts[lo:hi]]
            numel = np.asarray(self.numel[lo:hi], dtype=np.int64)
            self.parts.append(_Launch(lo, hi, ptrs, numel, chunk_table(numel),
                                      np.asarray(scalars[lo:hi], dtype=np.int32),
                                      np.asarray(wds[lo:hi], dtype=np.float32)))

    def __len__(self) -> int:
        return len(self.numel)


@_kernels.counted
def adamw_multi_tensor(table: LeafTable, grads: Sequence[torch.Tensor], scalars: torch.Tensor,
                       gnorm: Optional[torch.Tensor], h: Hyper) -> None:
    """Update every leaf of ``table`` in place on the current stream, with
    ``grads`` (one fp32 gradient per leaf, in the table's order, on its
    device): one launch per :data:`MAX_LEAVES` leaves, in order. ``scalars``
    and ``gnorm`` are device fp32 tensors that the kernel reads there, so the
    call never waits for the host and a CUDA graph can hold it."""
    if len(grads) != len(table):
        raise ValueError(f"{len(grads)} gradients for {len(table)} leaves")
    ptrs, copies = [], []  # copies: held until the launches are on the stream
    for j, (g, n) in enumerate(zip(grads, table.numel)):
        if g.dtype != torch.float32 or g.is_cuda != table.cuda or g.numel() != n:
            raise ValueError(f"AdamW kernel: gradient {j} is {g.dtype} of {g.numel()} elements on {g.device}, "
                             f"for an fp32 leaf of {n}")
        if not g.is_contiguous():  # a ZeRO-2 block along a later dimension: read from a contiguous copy
            g = g.contiguous()
            copies.append(g)
        ptrs.append(g.data_ptr())
    if table.staged:
        torch._foreach_copy_([buf for _, buf in table.staged], [view for view, _ in table.staged])
    for part in table.parts:
        part.ptrs[:, 1] = ptrs[part.lo:part.hi]
        _kernels.adamw_multi_tensor(part.ptrs, part.numel, part.first_chunk, part.scalar, part.wd,
                                    table.moment_bf16, scalars, gnorm, h)
        adamw_multi_tensor.launches += 1
    if table.staged:
        torch._foreach_copy_([view for view, _ in table.staged], [buf for _, buf in table.staged])
