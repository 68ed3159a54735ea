"""ResNet backbone (PyTorch) with stage-partial forwards and frozen BN.

Counterpart of ``xpretrain_tpu/models/hd_vila/resnet.py`` (ref the mmdetection
ResNet ``hd-vila/src/modeling/resnet_mmdetection.py:398-805``): depths
18/34/50/101/152, ``out_indices`` multi-stage outputs, and the stage-partial
forwards of HD-VILA's hybrid encoder (``forward_to_stage`` ``:746-761``,
``forward_stage_out`` ``:763-780``, ``forward_in_stage`` ``:782-793``).
Written out here, with no torchvision.

- Parameters are fp32 and every convolution computes in ``dtype``. On CUDA
  the activations are channels_last, so a bf16 model's convolutions run as
  NHWC bf16 cuDNN convolutions.
- :class:`FrozenBatchNorm` is the reference's ``norm_eval=True`` BN: an
  affine transform over stored statistics. As in flax, ``scale``, ``bias``,
  ``mean`` and ``var`` are parameters (the optimizer's frozen patterns decide
  whether they train), and ``rsqrt(var + eps) * scale`` is computed in fp32
  before the cast to the activation dtype. It takes the ReLU after it and, in
  a block's last BN, the residual add, so that on CUDA the three are one
  pass each way (``ops/frozen_bn.py``).
- Convolutions pad ``k // 2`` on each side (the stride-2 1x1 downsample has
  none); the stem max-pool is ``nn.MaxPool2d(3, 2, 1)``, JAX's -inf padding.
- The stem is always the direct 7x7/s2 convolution. ``s2d_stem`` is kept for
  the config's sake: JAX's space-to-depth stem is a TPU layout of the same
  parameters with the same output (and it fails on odd sizes, which the
  direct convolution does not).
- ``num_stages`` builds only the first stages: flax creates parameters
  lazily, so the low-res ResNet that ``forward_to_stage(stage=2)`` drives has
  no ``layer4`` in JAX, and none here.
- ``remat`` recomputes each block in the backward
  (``torch.utils.checkpoint``), the reference's ``with_cp``.

Submodules carry the flax names (``conv1``, ``bn1``, ``layer{s}_{b}`` with
``conv{c}``, ``bn{c}``, ``downsample_conv``, ``downsample_bn``), so
``models/hd_vila/convert.py`` maps parameters by path.
"""

from __future__ import annotations

from typing import Sequence

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from xpretrain_tpu_torch.ops.frozen_bn import frozen_bn_act

ARCH_SETTINGS = {
    18: ("basic", (2, 2, 2, 2)),
    34: ("basic", (3, 4, 6, 3)),
    50: ("bottleneck", (3, 4, 6, 3)),
    101: ("bottleneck", (3, 4, 23, 3)),
    152: ("bottleneck", (3, 8, 36, 3)),
}


class Conv2d(nn.Conv2d):
    """``nn.Conv2d`` with an fp32 weight that computes in ``dtype`` (flax's
    ``Conv(dtype=...)``), padding ``k // 2`` on each side, no bias."""

    def __init__(self, in_channels: int, out_channels: int, kernel: int, stride: int = 1,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__(in_channels, out_channels, kernel, stride=stride, padding=kernel // 2, bias=False,
                         device=device)
        self.compute_dtype = dtype

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        dt = self.compute_dtype
        return F.conv2d(x.to(dt), self.weight.to(dt), None, self.stride, self.padding)


class FrozenBatchNorm(nn.Module):
    """BN with fixed statistics (the ``norm_eval=True`` behavior), NCHW."""

    def __init__(self, features: int, eps: float = 1e-5, device=None):
        super().__init__()
        self.eps = eps
        self.scale = nn.Parameter(torch.ones(features, device=device))
        self.bias = nn.Parameter(torch.zeros(features, device=device))
        self.mean = nn.Parameter(torch.zeros(features, device=device))
        self.var = nn.Parameter(torch.ones(features, device=device))

    def forward(self, x: torch.Tensor, relu: bool = False, identity: torch.Tensor | None = None) -> torch.Tensor:
        """``act(bn(x) [+ identity])``, ``act`` ReLU when ``relu``."""
        inv = torch.rsqrt(self.var + self.eps) * self.scale  # fp32, then the activation dtype
        shift = self.bias - self.mean * inv
        return frozen_bn_act(x, inv, shift, relu, identity)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.conv1 = Conv2d(inplanes, planes, 3, stride, dtype, device)
        self.bn1 = FrozenBatchNorm(planes, device=device)
        self.conv2 = Conv2d(planes, planes, 3, 1, dtype, device)
        self.bn2 = FrozenBatchNorm(planes, device=device)
        if downsample:
            self.downsample_conv = Conv2d(inplanes, planes, 1, stride, dtype, device)
            self.downsample_bn = FrozenBatchNorm(planes, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.conv2(self.bn1(self.conv1(x), relu=True))
        identity = self.downsample_bn(self.downsample_conv(x)) if hasattr(self, "downsample_conv") else x
        return self.bn2(out, relu=True, identity=identity)


class Bottleneck(nn.Module):
    expansion = 4

    def __init__(self, inplanes: int, planes: int, stride: int = 1, downsample: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        out = planes * self.expansion
        self.conv1 = Conv2d(inplanes, planes, 1, 1, dtype, device)
        self.bn1 = FrozenBatchNorm(planes, device=device)
        # pytorch-style: stride on the 3x3
        self.conv2 = Conv2d(planes, planes, 3, stride, dtype, device)
        self.bn2 = FrozenBatchNorm(planes, device=device)
        self.conv3 = Conv2d(planes, out, 1, 1, dtype, device)
        self.bn3 = FrozenBatchNorm(out, device=device)
        if downsample:
            self.downsample_conv = Conv2d(inplanes, out, 1, stride, dtype, device)
            self.downsample_bn = FrozenBatchNorm(out, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        out = self.bn1(self.conv1(x), relu=True)
        out = self.conv3(self.bn2(self.conv2(out), relu=True))
        identity = self.downsample_bn(self.downsample_conv(x)) if hasattr(self, "downsample_conv") else x
        return self.bn3(out, relu=True, identity=identity)


class ResNet(nn.Module):
    """NCHW in and out; ``x`` may be fp32 or the compute dtype."""

    def __init__(
        self,
        depth: int = 50,
        out_indices: Sequence[int] = (0, 1, 2, 3),
        base_channels: int = 64,
        dtype: torch.dtype = torch.float32,
        remat: bool = False,
        s2d_stem: bool = False,
        num_stages: int = 4,
        device=None,
    ):
        super().__init__()
        block_type, stage_blocks = ARCH_SETTINGS[depth]
        self.out_indices = tuple(out_indices)
        self.remat = remat
        self.s2d_stem = s2d_stem  # the TPU stem layout; the output is the direct conv's
        block_cls = Bottleneck if block_type == "bottleneck" else BasicBlock
        # output channels of each stage (of the full depth, built or not)
        self.stage_channels = tuple(base_channels * 2**i * block_cls.expansion for i in range(len(stage_blocks)))
        self.conv1 = Conv2d(3, base_channels, 7, 2, dtype, device)
        self.bn1 = FrozenBatchNorm(base_channels, device=device)
        self.stage_names: list[list[str]] = []
        inplanes = base_channels
        for stage_idx, n_blocks in enumerate(stage_blocks[:num_stages]):
            planes = base_channels * 2**stage_idx
            names = []
            for b in range(n_blocks):
                stride = 2 if (b == 0 and stage_idx > 0) else 1
                needs_down = b == 0 and (stride != 1 or stage_idx > 0 or block_cls.expansion != 1)
                name = f"layer{stage_idx + 1}_{b}"
                self.add_module(name, block_cls(inplanes, planes, stride, needs_down, dtype, device))
                inplanes = planes * block_cls.expansion
                names.append(name)
            self.stage_names.append(names)

    @property
    def num_stages(self) -> int:
        return len(self.stage_names)

    def _stem(self, x: torch.Tensor) -> torch.Tensor:
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        x = self.bn1(self.conv1(x), relu=True)
        return F.max_pool2d(x, 3, 2, 1)  # = JAX's -inf pad by 1 + VALID 3x3/s2

    def _run_stage(self, x: torch.Tensor, stage_idx: int) -> torch.Tensor:
        if stage_idx >= self.num_stages:
            raise ValueError(f"stage {stage_idx} asked for, but only the first {self.num_stages} stages are built")
        for name in self.stage_names[stage_idx]:
            block = getattr(self, name)
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(block, x, use_reentrant=False)
            else:
                x = block(x)
        return x

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, ...]:
        """-> tuple of NCHW stage features at ``out_indices``."""
        x = self._stem(x)
        outs = []
        for i in range(len(self.stage_channels)):
            x = self._run_stage(x, i)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)

    def forward_to_stage(self, x: torch.Tensor, stage: int = 2) -> torch.Tensor:
        """Stem + stages [0, stage]; one NCHW output (ref ``:746-761``)."""
        x = self._stem(x)
        for i in range(stage + 1):
            x = self._run_stage(x, i)
        return x

    def forward_stage_out(self, x: torch.Tensor, stage: int = 0
                          ) -> tuple[torch.Tensor, tuple[torch.Tensor, ...]]:
        """-> (shallow stem feature, outputs up to ``stage``) (ref ``:763-780``)."""
        x = self._stem(x)
        shallow = x
        outs = []
        for i in range(stage + 1):
            x = self._run_stage(x, i)
            if i in self.out_indices:
                outs.append(x)
        return shallow, tuple(outs)

    def forward_in_stage(self, x: torch.Tensor, stage: int = 0) -> tuple[torch.Tensor, ...]:
        """Continue from a mid-network feature through stages > ``stage``
        (ref ``:782-793``)."""
        if x.is_cuda:
            x = x.contiguous(memory_format=torch.channels_last)
        outs = []
        for i in range(stage + 1, len(self.stage_channels)):
            x = self._run_stage(x, i)
            if i in self.out_indices:
                outs.append(x)
        return tuple(outs)
