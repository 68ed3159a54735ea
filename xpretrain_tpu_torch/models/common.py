"""Shared transformer building blocks (PyTorch), bf16-compute friendly.

Counterpart of ``xpretrain_tpu/models/common.py``. As there, parameters stay
fp32 and each layer computes in a configurable ``dtype`` (the cast happens at
use, like flax's ``Dense(dtype=...)``); attention scores, softmax and
layer-norm statistics run in fp32. Attention dropout draws its keep mask from
an explicit ``torch.Generator`` (or takes the mask itself), since torch's
bits cannot match ``jax.random``'s.
"""

from __future__ import annotations

import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from xpretrain_tpu_torch.ops import _kernels

NEG_INF = -1e9  # additive-mask fill; large but finite so bf16 stays well-behaved


def device_constant(builder: Callable, args: tuple, device: torch.device) -> torch.Tensor:
    """``builder(*args)`` (numpy) as a tensor on ``device``, made once per
    (builder, args, device) and shared: callers must not write to it. A
    forward that copied a host constant to the card at every call could not
    be captured in a CUDA graph. Made outside inference mode even when first
    asked for inside it, so that a process that serves and then trains can
    use it under autograd. Under a trace (``torch.export``) it is made anew
    and not cached: the trace's tensor is fake, and the program holds it as
    a constant."""
    if _kernels.tracing():
        return _make_constant(builder, args, device)
    return _cached_constant(builder, args, device)


def _make_constant(builder: Callable, args: tuple, device: torch.device) -> torch.Tensor:
    with torch.inference_mode(False):
        return torch.from_numpy(np.array(builder(*args))).to(device)


_cached_constant = functools.lru_cache(maxsize=128)(_make_constant)


def quick_gelu(x: torch.Tensor) -> torch.Tensor:
    """CLIP's activation: x * sigmoid(1.702 x)."""
    return x * torch.sigmoid(1.702 * x)


ACT2FN: dict[str, Callable[[torch.Tensor], torch.Tensor]] = {
    "quick_gelu": quick_gelu,
    # flax.linen.gelu defaults to the tanh approximation, so both names take it
    "gelu": lambda x: F.gelu(x, approximate="tanh"),
    "gelu_new": lambda x: F.gelu(x, approximate="tanh"),
    "relu": F.relu,
}


class Linear(nn.Linear):
    """``nn.Linear`` with fp32 parameters that computes in ``dtype``. Under
    tensor parallelism ``parallel`` is the layer's plan
    (``parallel/tensor_parallel.py``), which computes it on this rank's
    block of the weight."""

    parallel: Optional[Callable] = None

    def __init__(self, in_features: int, out_features: int, bias: bool = True,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_features, out_features, bias=bias, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if self.parallel is not None:
            return self.parallel(self, x)
        dt = self.compute_dtype
        bias = None if self.bias is None else self.bias.to(dt)
        return F.linear(x.to(dt), self.weight.to(dt), bias)


class Embedding(nn.Embedding):
    """``nn.Embedding`` with an fp32 table that looks up in ``dtype`` (flax's
    ``Embed(dtype=...)``: the gathered rows are cast, not the whole table)."""

    def __init__(self, num_embeddings: int, dim: int, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(num_embeddings, dim, device=device)
        self.compute_dtype = dtype

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        return F.embedding(ids, self.weight).to(self.compute_dtype)


class RecordedDraws:
    """The dropout generator of a recomputed (remat) block, in place of its
    ``torch.Generator``: the block's first run (the forward) draws each keep
    mask from ``generator`` and keeps it, and a later run (the backward's
    recompute) takes the masks back in order, so both see the same masks.
    Rewinding the generator would redraw them too, but its state lives on the
    host, where a captured CUDA graph cannot rewind it; kept masks are device
    tensors that it can hold."""

    def __init__(self, generator: torch.Generator):
        self.generator = generator
        self.masks: list[torch.Tensor] = []
        self.runs = 0
        self.taken = 0

    def begin(self) -> None:
        """Mark the start of a run of the block."""
        self.runs += 1
        self.taken = 0

    def keep(self, shape: tuple[int, ...], rate: float, device: torch.device) -> torch.Tensor:
        if self.runs > 1:
            self.taken += 1
            return self.masks[self.taken - 1]
        mask = torch.rand(shape, generator=self.generator, device=device) < 1.0 - rate
        self.masks.append(mask)
        return mask


def recomputed(fn: Callable, generator: Optional[torch.Generator], *args, **kwargs):
    """``fn(*args, draws)`` under ``torch.utils.checkpoint`` (non-reentrant):
    its activations are recomputed in the backward, with the forward's
    dropout masks (:class:`RecordedDraws`); ``kwargs`` go to ``checkpoint``."""
    draws = None if generator is None else RecordedDraws(generator)

    def run(*inputs):
        if draws is not None:
            draws.begin()
        return fn(*inputs, draws)

    return checkpoint(run, *args, use_reentrant=False, **kwargs)


def dropout(
    x: torch.Tensor,
    rate: float,
    generator: Optional[torch.Generator | RecordedDraws] = None,
    keep: Optional[torch.Tensor] = None,
    shape: Optional[tuple[int, ...]] = None,
) -> torch.Tensor:
    """flax's ``nn.Dropout``: drop with probability ``rate`` and rescale the
    kept values by 1/(1 - rate). The boolean keep mask is ``keep`` when
    given, else drawn from ``generator`` in ``shape`` (``x.shape`` by
    default; a shape that broadcasts drops whole slices, as stochastic depth
    drops whole samples). The caller passes a rate only in training."""
    if rate <= 0.0:
        return x
    if keep is None and isinstance(generator, RecordedDraws):
        keep = generator.keep(shape or x.shape, rate, x.device)
    elif keep is None:
        keep = torch.rand(shape or x.shape, generator=generator, device=x.device) < 1.0 - rate
    return torch.where(keep, x / (1.0 - rate), torch.zeros((), dtype=x.dtype, device=x.device))


class LayerNorm(nn.LayerNorm):
    """Layer norm computed in fp32, output in ``dtype`` (flax's LayerNorm)."""

    def __init__(self, dim: int, eps: float = 1e-5, dtype: torch.dtype = torch.float32,
                 device=None):
        super().__init__(dim, eps=eps, device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = F.layer_norm(x.float(), self.normalized_shape, self.weight, self.bias, self.eps)
        return y.to(self.compute_dtype)


def dot_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    scale: float,
    mask: Optional[torch.Tensor] = None,
    dropout_rate: float = 0.0,
    generator: Optional[torch.Generator] = None,
    keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Scaled dot-product attention over [..., Q, D] x [..., K, D].

    Scores and softmax run in fp32 regardless of the input dtype; ``mask`` is
    additive (0 keep / NEG_INF drop), broadcastable to [..., Q, K].

    ``dropout_rate > 0`` drops softmax weights (fp32) and rescales the kept
    ones by 1/(1 - rate), as the flax version does: with the boolean
    ``keep`` mask when given, else with one drawn from ``generator``. The
    caller passes a rate only in training.
    """
    scores = torch.matmul(q.float(), k.float().transpose(-1, -2)) * scale
    if mask is not None:
        scores = scores + mask.float()
    weights = dropout(torch.softmax(scores, dim=-1), dropout_rate, generator, keep)
    return torch.matmul(weights.to(v.dtype), v)


class MultiHeadAttention(nn.Module):
    """Multi-head self-attention with separate q/k/v/out projections (the
    CLIP/BERT checkpoint naming). The head count is read off the
    projections' width, so a tensor-parallel rank attends with its own
    heads."""

    def __init__(self, embed_dim: int, num_heads: int, dtype: torch.dtype = torch.float32,
                 device=None, dropout_rate: float = 0.0):
        super().__init__()
        if embed_dim % num_heads:
            raise ValueError(f"embed_dim {embed_dim} % heads {num_heads} != 0")
        self.embed_dim = embed_dim
        self.num_heads = num_heads
        self.dropout_rate = dropout_rate
        self.q_proj = Linear(embed_dim, embed_dim, dtype=dtype, device=device)
        self.k_proj = Linear(embed_dim, embed_dim, dtype=dtype, device=device)
        self.v_proj = Linear(embed_dim, embed_dim, dtype=dtype, device=device)
        self.out_proj = Linear(embed_dim, embed_dim, dtype=dtype, device=device)

    def _split(self, x: torch.Tensor) -> torch.Tensor:
        b, s, _ = x.shape
        return x.view(b, s, -1, self.embed_dim // self.num_heads).transpose(1, 2)  # [B,H,S,D]

    def forward(
        self,
        hidden_states: torch.Tensor,
        mask: Optional[torch.Tensor] = None,
        generator: Optional[torch.Generator] = None,
        keep: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        """Dropout applies in training mode only (``self.training``)."""
        scale = (self.embed_dim // self.num_heads) ** -0.5
        q = self._split(self.q_proj(hidden_states))
        k = self._split(self.k_proj(hidden_states))
        v = self._split(self.v_proj(hidden_states))
        rate = self.dropout_rate if self.training else 0.0
        out = dot_attention(q, k, v, scale, mask, rate, generator, keep)  # [B,H,Q,D]
        b, _, s, _ = out.shape
        return self.out_proj(out.transpose(1, 2).reshape(b, s, -1))


class TransformerMLP(nn.Module):
    def __init__(self, hidden_size: int, intermediate_size: int, act: str = "quick_gelu",
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.fc1 = Linear(hidden_size, intermediate_size, dtype=dtype, device=device)
        self.fc2 = Linear(intermediate_size, hidden_size, dtype=dtype, device=device)
        self.act = ACT2FN[act]

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return self.fc2(self.act(self.fc1(x)))


def make_causal_mask(seq_len: int, device=None) -> torch.Tensor:
    """Additive causal mask [1, 1, S, S] (upper triangle = NEG_INF), fp32."""
    mask = torch.full((seq_len, seq_len), NEG_INF, dtype=torch.float32, device=device)
    return torch.triu(mask, diagonal=1)[None, None]


def expand_padding_mask(attention_mask: torch.Tensor) -> torch.Tensor:
    """[B, S] 1/0 keep mask -> additive fp32 [B, 1, 1, S]."""
    return ((1.0 - attention_mask.float()) * NEG_INF)[:, None, None, :]
