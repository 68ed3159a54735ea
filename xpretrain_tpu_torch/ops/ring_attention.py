"""Ring attention over a sequence axis of the mesh
(``xpretrain_tpu/ops/ring_attention.py``).

Exact softmax attention whose sequence dim is split over the ranks of the
mesh's ``seq`` axis: each rank holds the blocks [B, H, S/p, D] of q, k and v
(and [B, S/p] of the keep mask), and the K/V blocks, with their additive
mask bias, go round the ring one rank a step (``parallel/p2p.py:ring_shift``,
JAX's ``lax.ppermute``) while an fp32 online softmax merges each block's
scores into the rank's running max, denominator and output. At step ``j``
rank ``i`` holds block ``(i - j) mod p``, so the blocks are summed in JAX's
order. The arithmetic is JAX's, op for op: q scaled by D**-0.5 in fp32, the
mask a bias of ``_NEG_BIG`` (finite), the running state in fp32, the output
``o / max(l, 1e-30)`` in q's dtype. The last rotation, which changes no
output, is skipped. Gradients flow through the shifts (their backward is the
inverse shift), so one chain of shift nodes is each rank's backward order.

JAX's function takes the global arrays and shards them itself; the port's
takes and returns the rank's blocks. :func:`sequence_block` cuts a rank's
block out of a global tensor and raises JAX's ``ValueError`` when the ring
does not divide the sequence.

Not Pallas in JAX, so no kernel here: plain torch matmuls and elementwise
ops, on the card when the tensors are.
"""

from __future__ import annotations

from typing import Optional

import torch

from xpretrain_tpu_torch.parallel.mesh import DataMesh, axis_group
from xpretrain_tpu_torch.parallel.p2p import ring_shift

_NEG_BIG = -1e30  # finite "-inf": exp() gives exact zeros without NaNs


def _ring_attention_local(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, bias: Optional[torch.Tensor],
                          size: int, group) -> torch.Tensor:
    """JAX's per-device body on this rank's blocks; ``bias`` is the additive
    key bias [B, 1, 1, S/p] of the K block, rotated with it."""
    scale = q.shape[-1] ** -0.5
    qf = q.float() * scale
    m = torch.full(q.shape[:-1] + (1,), _NEG_BIG, dtype=torch.float32, device=q.device)
    l = torch.zeros(q.shape[:-1] + (1,), dtype=torch.float32, device=q.device)
    o = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    for step in range(size):
        s = torch.matmul(qf, k.float().transpose(-1, -2))
        if bias is not None:
            s = s + bias.float()
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        alpha = torch.exp(m - m_new)
        pexp = torch.exp(s - m_new)
        l = l * alpha + pexp.sum(dim=-1, keepdim=True)
        o = o * alpha + torch.matmul(pexp, v.float())
        m = m_new
        if step < size - 1:
            k, v, *rest = ring_shift((k, v) if bias is None else (k, v, bias), group)
            bias = rest[0] if rest else None
    return (o / l.clamp_min(1e-30)).to(q.dtype)


def sequence_block(x: torch.Tensor, mesh: Optional[DataMesh], *, seq_axis: str = "seq", dim: int = 2
                   ) -> torch.Tensor:
    """This rank's block of ``x`` along its sequence ``dim`` (2 for q/k/v
    [B, H, S, D], 1 for the mask [B, S]): block ``i`` of ``p`` on the
    ``seq_axis`` of ``mesh`` (a view). Raises JAX's ``ValueError`` when ``p``
    does not divide the sequence."""
    size, index, _ = axis_group(mesh, seq_axis)
    n = x.shape[dim]
    if n % size:
        raise ValueError(f"sequence {n} not divisible by ring size {size}")
    return x.narrow(dim, index * (n // size), n // size)


def make_ring_attention(mesh: Optional[DataMesh], *, seq_axis: str = "seq", data_axis: Optional[str] = None):
    """Build ``fn(q, k, v, attention_mask=None) -> out``: exact softmax
    attention over the sequence split on ``mesh``'s ``seq_axis``.

    ``q``/``k``/``v`` are this rank's blocks [B, H, S/p, D] (B this rank's
    rows when ``data_axis`` splits the batch: the ring runs within each data
    index), ``attention_mask`` the [B, S/p] 1/0 keep mask of its keys; the
    result is the rank's block [B, H, S/p, D] of dense
    ``softmax(QK^T/sqrt(d) + bias) V``. ``mesh`` None, or a ring of one
    rank, is one process's dense attention through the same arithmetic.
    Axis names the mesh lacks raise."""
    size, _, group = axis_group(mesh, seq_axis)
    if data_axis is not None:
        axis_group(mesh, data_axis)

    def fn(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           attention_mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
            raise ValueError(f"q, k, v must be [B, H, S/p, D] blocks of one shape: {q.shape}, {k.shape}, {v.shape}")
        bias = None
        if attention_mask is not None:
            if tuple(attention_mask.shape) != (q.shape[0], q.shape[2]):
                raise ValueError(f"attention_mask {tuple(attention_mask.shape)} is not the [B, S/p] block of "
                                 f"q {tuple(q.shape)}")
            bias = ((1.0 - attention_mask.float()) * _NEG_BIG)[:, None, None, :]
        return _ring_attention_local(q, k, v, bias, size, group)

    return fn


__all__ = ["make_ring_attention", "sequence_block"]
