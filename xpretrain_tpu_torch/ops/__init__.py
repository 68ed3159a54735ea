"""The port's ops: the hand-written CUDA kernels (``_kernels`` builds and
binds them), their public wrappers and plain versions, and the losses.

Importing the package registers the ``xpt::`` custom ops the kernels launch
in (``torch.ops.xpt.*``), which an exported program calls
(``xpretrain_tpu_torch.serving.artifact``).
"""

from xpretrain_tpu_torch.ops import patchify, proxy_attention, window_attention  # noqa: F401
