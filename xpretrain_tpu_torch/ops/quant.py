"""Int8 quantized serving (w8a8, dynamic per-token activation scales), the
counterpart of ``xpretrain_tpu/ops/quant.py``.

- :func:`quantize_weight`: symmetric per-out-channel absmax int8 of an
  [in, out] kernel, as JAX's.
- :func:`int8_matmul`: activations quantized per token (symmetric absmax over
  the feature axis), an int8 x int8 -> int32 product (``torch._int_mm``, the
  library's int8 GEMM: this is no TPU kernel of the JAX package), the int32
  sum rescaled in fp32 by ``act_scale[token] * weight_scale[channel]``, then
  cast back to the activation dtype.
- :func:`int8_serving`: a context manager that swaps the forward of every
  large enough ``nn.Linear`` (the port's ``models.common.Linear`` included)
  for the int8 product, then the bias. Parameters and checkpoints do not
  change; leaving the context restores every class's forward. Each
  module's weight is quantized once per context (its first call), since
  serving weights do not change inside it; under a trace it is quantized in
  the program.

Attention score and PV products, layer norms, softmaxes and embedding
lookups stay in their float dtypes, as in JAX. ``torch._int_mm`` on a card
takes [m, k] x [k, n] with m > 16 and k, n multiples of 8: a product of
fewer rows is padded with zero rows to 17 (the same sums), other shapes
raise; nothing falls back to the float product.

JAX measured this path slower than bf16 inside the full program on its TPU
(``xpretrain_tpu/ops/quant.py``); on the card ``chip_smoke.py`` phase 7e
times it beside the bf16 forward, as a record.
"""

from __future__ import annotations

import contextlib

import torch
from torch import nn

from xpretrain_tpu_torch.ops import _kernels

_INT_MM_MIN_ROWS = 17  # torch._int_mm on CUDA takes more than 16 rows


def quantize_weight(w: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric per-out-channel int8 quantization of an [in, out] kernel:
    ``(q, scale)`` with ``q`` int8 [in, out] (in ``w``'s layout) and
    ``scale`` fp32 [out] such that ``q * scale ~ w``."""
    w = w.float()
    scale = w.abs().amax(dim=0) / 127.0 + 1e-12
    q = torch.clamp(torch.round(w / scale), -127, 127).to(torch.int8)
    return q, scale


def int8_matmul(x: torch.Tensor, q: torch.Tensor, w_scale: torch.Tensor) -> torch.Tensor:
    """``x @ (q * w_scale)`` as an int8 x int8 -> int32 product; ``x``
    [..., in] is quantized per token, the output dtype follows ``x``."""
    lead = x.shape[:-1]
    xf = x.reshape(-1, x.shape[-1]).float()
    s = xf.abs().amax(dim=-1, keepdim=True) / 127.0 + 1e-12
    qx = torch.clamp(torch.round(xf / s), -127, 127).to(torch.int8)
    rows = qx.shape[0]
    if qx.is_cuda:
        k, n = q.shape
        if k % 8 or n % 8:
            raise ValueError(f"torch._int_mm on CUDA takes k and n that are multiples of 8, got k={k}, n={n}")
        if rows < _INT_MM_MIN_ROWS:
            qx = torch.cat([qx, qx.new_zeros((_INT_MM_MIN_ROWS - rows, k))])
    acc = torch._int_mm(qx, q)[:rows]
    out = acc.float() * s * w_scale[None, :]
    return out.reshape(*lead, q.shape[1]).to(x.dtype)


def _linear_classes() -> list[type]:
    """``nn.Linear`` and each subclass that defines its own ``forward``."""
    found, todo = [nn.Linear], [nn.Linear]
    while todo:
        for sub in todo.pop().__subclasses__():
            todo.append(sub)
            if "forward" in sub.__dict__:
                found.append(sub)
    return found


@contextlib.contextmanager
def int8_serving(min_in_features: int = 256, min_features: int = 256):
    """Run every ``nn.Linear`` with at least ``min_in_features`` inputs and
    ``min_features`` outputs as an int8 product while inside; smaller ones
    (classifier heads, tiny configs) keep their float forward::

        with int8_serving():
            feats = model.forward_video(video)
    """
    from xpretrain_tpu_torch.models import common  # noqa: F401  (its Linear is one of the classes)

    originals = {cls: cls.__dict__["forward"] for cls in _linear_classes()}
    quantized: dict[nn.Module, tuple[torch.Tensor, torch.Tensor]] = {}

    def make(original):
        def forward(self, x: torch.Tensor) -> torch.Tensor:
            if x.dim() < 1 or x.shape[-1] < min_in_features or self.out_features < min_features:
                return original(self, x)
            if _kernels.tracing():
                q, scale = quantize_weight(self.weight.detach().t())
            else:
                if self not in quantized:
                    quantized[self] = quantize_weight(self.weight.detach().t())
                q, scale = quantized[self]
            y = int8_matmul(x, q, scale)
            return y if self.bias is None else y + self.bias.to(y.dtype)
        return forward

    for cls, original in originals.items():
        cls.forward = make(original)
    try:
        yield
    finally:
        for cls, original in originals.items():
            cls.forward = original


def maybe_int8_serving(enabled: bool, **kw):
    """``int8_serving(**kw)`` when ``enabled``, else a null context."""
    return int8_serving(**kw) if enabled else contextlib.nullcontext()
