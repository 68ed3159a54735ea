"""Pieces the references share: linear layers in the stated or the control
precision, layer norm, softmax attention over an allowed-pattern, and the
grouped AdamW with global-norm clipping and the warmup-cosine schedule."""

from __future__ import annotations

import contextlib
import math
from typing import Iterator, Optional

import torch
import torch.nn.functional as F

# float8 formats and their largest values: e4m3 for what the forward
# multiplies, e5m2 for the gradients the backward multiplies (the hybrid
# recipe of fp8 training)
E4M3 = (torch.float8_e4m3fn, 448.0)
E5M2 = (torch.float8_e5m2, 57344.0)


def to_fp8(t: torch.Tensor, fmt: tuple = E4M3) -> torch.Tensor:
    """``t`` rounded through a float8 format with one absmax scale per tensor."""
    dtype, largest = fmt
    scale = t.abs().amax().clamp_min(1e-30) / largest
    return (t / scale).to(dtype).to(t.dtype) * scale


def fake_fp8(t: torch.Tensor) -> torch.Tensor:
    """:func:`to_fp8` in e4m3; the gradient passes straight through."""
    return t + (to_fp8(t.detach()) - t.detach())


class _Fp8Matmul(torch.autograd.Function):
    """``a @ b`` with both operands in e4m3; the backward's products take
    the incoming gradient in e5m2 and the forward's rounded operands."""

    @staticmethod
    def forward(ctx, a, b):
        qa, qb = to_fp8(a), to_fp8(b)
        ctx.save_for_backward(qa, qb)
        return torch.matmul(qa, qb)

    @staticmethod
    def backward(ctx, g):
        qa, qb = ctx.saved_tensors
        qg = to_fp8(g, E5M2)
        return torch.matmul(qg, qb.transpose(-1, -2)), torch.matmul(qa.transpose(-1, -2), qg)


class Precision:
    """``fp32`` (the reference) or ``fp8`` (the control: every product of
    the layers, attention's included, in float8 as fp8 training computes
    them, :class:`_Fp8Matmul`)."""

    def __init__(self, name: str = "fp32"):
        if name not in ("fp32", "fp8"):
            raise ValueError(f"precision {name!r}: use fp32 or fp8")
        self.name = name

    def matmul(self, a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
        """``a @ b`` over matching batch dims (or none)."""
        return _Fp8Matmul.apply(a, b) if self.name == "fp8" else torch.matmul(a, b)

    def linear(self, x: torch.Tensor, w: torch.Tensor, b: Optional[torch.Tensor] = None) -> torch.Tensor:
        if self.name == "fp32":
            return F.linear(x, w, b)
        y = self.matmul(x.reshape(-1, x.shape[-1]), w.t()).reshape(*x.shape[:-1], w.shape[0])
        return y if b is None else y + b


@contextlib.contextmanager
def strict_fp32() -> Iterator[None]:
    """float32 products without TF32 on a card, restored afterwards."""
    saved = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = saved


def layer_norm(x: torch.Tensor, p: dict, prefix: str, eps: float) -> torch.Tensor:
    return F.layer_norm(x, x.shape[-1:], p[prefix + ".weight"], p[prefix + ".bias"], eps)


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, allowed: Optional[torch.Tensor],
              prec: Precision) -> torch.Tensor:
    """softmax(q k^T / sqrt(d)) v over [..., S, d], keys outside ``allowed``
    (boolean, broadcast to [..., Q, K]) left out; every row keeps a key."""
    scores = prec.matmul(q, k.transpose(-1, -2)) * q.shape[-1] ** -0.5
    if allowed is not None:
        scores = scores.masked_fill(~allowed, float("-inf"))
    return prec.matmul(torch.softmax(scores, dim=-1), v)


def l2_normalize(x: torch.Tensor) -> torch.Tensor:
    return x / torch.linalg.vector_norm(x, dim=-1, keepdim=True).clamp_min(1e-12)


def symmetric_nce(sim: torch.Tensor) -> torch.Tensor:
    """Cross-entropy of the rows and of the columns of a similarity matrix
    whose diagonal holds the pairs."""
    labels = torch.arange(sim.shape[0], device=sim.device)
    return F.cross_entropy(sim, labels) + F.cross_entropy(sim.T, labels)


def warmup_cosine(base_lr: float, warmup: int, total: int, step: int, floor: float = 1e-8) -> float:
    """The schedule's lr at update ``step`` (0 for the first)."""
    if step < warmup:
        frac = step / max(warmup, 1)
    else:
        frac = 0.5 * (1.0 + math.cos(math.pi * (step - warmup) / max(total - warmup, 1)))
    return max(base_lr * frac, floor)


class AdamW:
    """Adam with decoupled weight decay on the leaves of ``decay``, after
    clipping every gradient by the global norm when it reaches ``max_norm``:
    ``u = m_hat / (sqrt(v_hat) + eps) + wd * p``, ``p -= lr * u``."""

    def __init__(self, params: dict[str, torch.Tensor], decay: set[str], betas: tuple[float, float],
                 eps: float, weight_decay: float, max_norm: float):
        self.params = params
        self.decay = decay
        self.b1, self.b2 = betas
        self.eps, self.wd, self.max_norm = eps, weight_decay, max_norm
        self.m = {n: torch.zeros_like(p) for n, p in params.items()}
        self.v = {n: torch.zeros_like(p) for n, p in params.items()}
        self.count = 0

    @torch.no_grad()
    def step(self, lr: float) -> dict[str, torch.Tensor]:
        """One update from the parameters' ``.grad``; returns the gradients
        as clipping leaves them (what the moments take)."""
        grads = {n: (p.grad if p.grad is not None else torch.zeros_like(p)) for n, p in self.params.items()}
        norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads.values()]))
        if norm >= self.max_norm:
            grads = {n: g / norm * self.max_norm for n, g in grads.items()}
        self.count += 1
        c1, c2 = 1 - self.b1 ** self.count, 1 - self.b2 ** self.count
        for n, p in self.params.items():
            g = grads[n]
            self.m[n].mul_(self.b1).add_(g, alpha=1 - self.b1)
            self.v[n].mul_(self.b2).addcmul_(g, g, value=1 - self.b2)
            u = (self.m[n] / c1) / ((self.v[n] / c2).sqrt() + self.eps)
            if n in self.decay:
                u = u + self.wd * p
            p.sub_(lr * u)
            p.grad = None
        return grads
