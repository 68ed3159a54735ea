"""The port's ops: the hand-written CUDA kernels (``_kernels`` builds and
binds them), their public wrappers and plain versions (``frozen_bn``: a
kernel of the port's own, which no TPU kernel precedes), the losses, w8a8
serving (``quant``) and ring attention (``ring_attention``). Every name the
JAX package's ``ops`` exports is exported here.

Importing the package registers the ``xpt::`` custom ops the kernels launch
in (``torch.ops.xpt.*``), which an exported program calls
(``xpretrain_tpu_torch.serving.artifact``).
"""

from xpretrain_tpu_torch.ops import frozen_bn, losses, patchify, proxy_attention, window_attention  # noqa: F401
from xpretrain_tpu_torch.ops.losses import build_loss_fn
from xpretrain_tpu_torch.ops.quant import int8_serving, maybe_int8_serving
from xpretrain_tpu_torch.ops.ring_attention import make_ring_attention

__all__ = [
    "losses", "build_loss_fn", "int8_serving", "maybe_int8_serving",
    "make_ring_attention",
]
