"""Hierarchical Temporal Window Attention (HTWA) video encoder in PyTorch.

Counterpart of ``xpretrain_tpu/models/lf_vila/swin3d.py`` (ref LF-VILA
``src/models/video_encoder.py:82-620``): 3-D shifted-window attention with a
relative-position bias over 6 stages whose temporal windows grow
[2,4,8,16,16,32] while the spatial windows stay 3x5, spatial-only shifting,
PatchMerging at stages {0,1,4}, and the local branch.

- Window partition and reverse are reshapes and permutes; cyclic shifts are
  ``torch.roll``.
- The static index and masks (``relative_position_index``,
  ``shifted_window_mask``, ``grouped_window_mask``) are numpy, built once per
  (dims, window, shift, G) and kept once per device (``common.device_constant``).
- Window grouping (``group_windows``, the default) merges G consecutive
  windows into one [G*N, G*N] attention under a block-diagonal mask (-100
  off-block), exactly as the JAX module. ``attn_fold`` is a TPU relayout of
  the same math with grouping off; here it is the ungrouped layout.
- With ``use_pallas_attention``, a block whose UNCLIPPED window holds at
  least ``pallas_min_window`` tokens (and has no attention dropout in
  training) attends through :func:`xpretrain_tpu_torch.ops.window_attention.
  window_attention`: the hand-written CUDA kernel on the card, its plain
  version on the CPU. The other blocks compute the same math inline.
- Parameters are fp32 with the flax names; each layer computes in
  ``Swin3DConfig.dtype``; layer norms (eps 1e-5), scores and softmax run in
  fp32; the MLP uses the exact erf gelu. Dropout and drop-path apply in
  training mode only, drawn from the ``torch.Generator`` handed to ``forward``.
- ``remat`` recomputes each block in the backward
  (``torch.utils.checkpoint``, non-reentrant), as flax's ``nn.remat`` around
  each block: with no ``remat_policy`` the block keeps only its input; the
  policies ``dots_saveable`` and ``dots_with_no_batch_dims_saveable`` keep
  the matmul outputs (``mm``/``addmm``/``bmm``, or ``mm``/``addmm`` only)
  through a selective-checkpoint ``context_fn``. A policy without ``remat``
  is ignored and an unknown one raises, as in JAX. The recompute takes the
  forward's dropout masks (``common.recomputed``).
- ``context_parallel_axis`` ("model", JAX's ``--cp``) shards the time axis
  of the activations ``[B, T, H, W, C]`` over the model group of the mesh
  (``parallel/mesh.py``), as JAX's ``with_sharding_constraint`` after the
  patch embed and after every stage: each model rank keeps ``T / cp``
  frames. A block whose temporal window (clipped to T) divides ``T / cp``
  and which has no temporal shift runs on its frames with no communication
  (the presets set ``temporal_no_shifting``); any other block all-gathers
  time first, and the stage re-shards after it. The encoder returns what
  the unsharded one returns, gathered. Every parameter's gradient is then a
  partial sum over the rank's frames: the layout marks them
  ``model_partial`` and the train step sums them over the model group
  (``parallel/fsdp.py``). Outside a mesh with a model axis the setting
  changes nothing, as JAX's constraint outside a mesh. Dropout draws from
  the step's generator, which the model ranks share: a block's drop-path
  drops a sample on every rank's frames alike.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Callable, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import CheckpointPolicy, create_selective_checkpoint_contexts

from xpretrain_tpu_torch.data.transforms import IMAGENET_MEAN, IMAGENET_STD
from xpretrain_tpu_torch.models.common import LayerNorm, Linear, device_constant, dot_attention, dropout, recomputed
from xpretrain_tpu_torch.ops.window_attention import window_attention
from xpretrain_tpu_torch.parallel.mesh import DataMesh, current_mesh, gather_model, model_block


@dataclasses.dataclass(frozen=True)
class Swin3DConfig:
    patch_size: tuple = (1, 8, 8)
    in_chans: int = 3
    embed_dim: int = 128
    depths: tuple = (2, 2, 14, 2, 2, 2)
    num_heads: tuple = (4, 8, 16, 16, 16, 32)
    stages: tuple = (0, 1, 2, 2, 2, 3)  # channel multiplier exponents
    downsample_stages: tuple = (0, 1, 4)
    window_size: tuple = ((2, 3, 5), (4, 3, 5), (8, 3, 5), (16, 3, 5), (16, 3, 5), (32, 3, 5))
    mlp_ratio: float = 4.0
    qkv_bias: bool = True
    drop_rate: float = 0.0
    attn_drop_rate: float = 0.0
    drop_path_rate: float = 0.2
    patch_norm: bool = False
    local_window: int = 4
    temporal_no_shifting: bool = True
    # True reproduces the reference's shipped local branch, which returns the
    # global features unless the capture happened on the last layer
    faithful_local_branch: bool = True
    use_pallas_attention: bool = False
    pallas_min_window: int = 240
    attn_fold: bool = False
    group_windows: bool = True
    dtype: torch.dtype = torch.float32
    remat: bool = False
    remat_policy: Optional[str] = None
    context_parallel_axis: Optional[str] = None

    @property
    def num_features(self) -> int:
        return int(self.embed_dim * 2 ** self.stages[-1])

    @staticmethod
    def tiny(**overrides) -> "Swin3DConfig":
        base = dict(
            embed_dim=32,
            depths=(1, 1, 2, 1, 1, 1),
            num_heads=(2, 2, 4, 4, 4, 4),
            patch_size=(1, 8, 8),
        )
        base.update(overrides)
        return Swin3DConfig(**base)


def _clip_window(x_size, window, shift):
    """Shrink window dims to the input size; zero shift on clipped dims
    (ref ``get_window_size`` ``video_encoder.py:68-80``)."""
    window = list(window)
    shift = list(shift)
    for i, (xs, ws) in enumerate(zip(x_size, window)):
        if xs <= ws:
            window[i] = xs
            shift[i] = 0
    return tuple(window), tuple(shift)


def window_partition(x: torch.Tensor, window: tuple[int, int, int]) -> torch.Tensor:
    """[B, D, H, W, C] -> [B*nW, wd*wh*ww, C]; windows in (nt, nh, nw) order."""
    B, D, H, W, C = x.shape
    wd, wh, ww = window
    x = x.reshape(B, D // wd, wd, H // wh, wh, W // ww, ww, C)
    x = x.permute(0, 1, 3, 5, 2, 4, 6, 7)
    return x.reshape(-1, wd * wh * ww, C)


def window_reverse(windows: torch.Tensor, window: tuple[int, int, int], B: int, D: int, H: int,
                   W: int) -> torch.Tensor:
    wd, wh, ww = window
    x = windows.reshape(B, D // wd, H // wh, W // ww, wd, wh, ww, -1)
    x = x.permute(0, 1, 4, 2, 5, 3, 6, 7)
    return x.reshape(B, D, H, W, -1)


def _frozen(a: np.ndarray) -> np.ndarray:
    a.flags.writeable = False  # cached and shared by every caller
    return a


@functools.lru_cache(maxsize=64)
def relative_position_index(window: tuple[int, int, int]) -> np.ndarray:
    """Static [N, N] index into the (2wd-1)(2wh-1)(2ww-1) bias table."""
    wd, wh, ww = window
    coords = np.stack(np.meshgrid(np.arange(wd), np.arange(wh), np.arange(ww), indexing="ij"))
    flat = coords.reshape(3, -1)
    rel = flat[:, :, None] - flat[:, None, :]
    rel = rel.transpose(1, 2, 0)
    rel[:, :, 0] += wd - 1
    rel[:, :, 1] += wh - 1
    rel[:, :, 2] += ww - 1
    rel[:, :, 0] *= (2 * wh - 1) * (2 * ww - 1)
    rel[:, :, 1] *= 2 * ww - 1
    return _frozen(rel.sum(-1))


def pick_window_group(nw: int, N: int, target: int = 128) -> int:
    """Largest divisor of ``nw`` (the W-axis window count) with G*N <= target."""
    g = 1
    for cand in range(1, nw + 1):
        if nw % cand == 0 and cand * N <= target:
            g = cand
    return g


@functools.lru_cache(maxsize=64)
def shifted_window_mask(dims: tuple[int, int, int], window: tuple[int, int, int],
                        shift: tuple[int, int, int]) -> np.ndarray:
    """Static [nW, N, N] additive mask for SW-MSA (ref ``compute_mask``)."""
    D, H, W = dims
    img = np.zeros((1, D, H, W, 1), np.float32)
    cnt = 0
    for d in (slice(-window[0]), slice(-window[0], -shift[0] or None), slice(-shift[0] or D, None)):
        for h in (slice(-window[1]), slice(-window[1], -shift[1] or None), slice(-shift[1] or H, None)):
            for w in (slice(-window[2]), slice(-window[2], -shift[2] or None), slice(-shift[2] or W, None)):
                img[:, d, h, w, :] = cnt
                cnt += 1
    wd, wh, ww = window
    x = img.reshape(1, D // wd, wd, H // wh, wh, W // ww, ww, 1)
    x = x.transpose(0, 1, 3, 5, 2, 4, 6, 7).reshape(-1, wd * wh * ww)
    diff = x[:, None, :] - x[:, :, None]
    return _frozen(np.where(diff != 0, -100.0, 0.0).astype(np.float32))


@functools.lru_cache(maxsize=64)
def grouped_window_mask(dims: tuple[int, int, int], window: tuple[int, int, int],
                        shift: tuple[int, int, int], G: int) -> np.ndarray:
    """Static [nW/G, G*N, G*N] additive mask: the per-window shifted-window
    masks on the diagonal blocks, -100 off-block. G consecutive windows share
    (nt, nh) in the (nt, nh, nw) window order."""
    D, H, W = dims
    wd, wh, ww = window
    N = wd * wh * ww
    nW = (D // wd) * (H // wh) * (W // ww)
    if any(s > 0 for s in shift):
        m = shifted_window_mask(dims, window, shift)
    else:
        m = np.zeros((nW, N, N), np.float32)
    m = m.reshape(nW // G, G, N, N)
    out = np.full((nW // G, G * N, G * N), -100.0, np.float32)
    for g in range(G):
        out[:, g * N : (g + 1) * N, g * N : (g + 1) * N] = m[:, g]
    return _frozen(out)


def _bias_index(window: tuple[int, int, int], N: int) -> np.ndarray:
    # a clipped window truncates the FULL window's index (ref ``:147``)
    return relative_position_index(window)[:N, :N].reshape(-1).astype(np.int64)


class WindowAttention3D(nn.Module):
    """W-MSA over flattened windows with relative position bias
    (ref ``video_encoder.py:82-164``). ``window`` is the full (unclipped)
    window, which sizes the bias table. Under tensor parallelism the fused
    ``qkv`` holds this rank's heads (``parallel/tensor_parallel.py``) and
    ``tp_heads`` is their range in the bias table."""

    tp_heads: Optional[tuple[int, int]] = None

    def __init__(self, dim: int, window: tuple[int, int, int], num_heads: int, qkv_bias: bool = True,
                 attn_drop: float = 0.0, dtype: torch.dtype = torch.float32, use_pallas: bool = False,
                 device=None):
        super().__init__()
        self.window = tuple(window)
        self.num_heads = num_heads
        self.attn_drop = attn_drop
        self.use_pallas = use_pallas
        self.qkv = Linear(dim, 3 * dim, bias=qkv_bias, dtype=dtype, device=device)
        self.proj = Linear(dim, dim, dtype=dtype, device=device)
        wd, wh, ww = self.window
        table = (2 * wd - 1) * (2 * wh - 1) * (2 * ww - 1)
        self.relative_position_bias_table = nn.Parameter(torch.zeros(table, num_heads, device=device))

    def _bias(self, N: int) -> torch.Tensor:
        idx = device_constant(_bias_index, (self.window, N), self.relative_position_bias_table.device)
        table = self.relative_position_bias_table
        if self.tp_heads is not None:
            table = table[:, self.tp_heads[0]:self.tp_heads[1]]
        return table[idx].view(N, N, -1).permute(2, 0, 1)  # [h, N, N] fp32

    def _attend(self, q, k, v, bias, mask, generator):
        """[Bn, h, N, d] q/k/v -> [Bn, h, N, d] context."""
        rate = self.attn_drop if self.training else 0.0
        if self.use_pallas and rate == 0.0:  # JAX's gate (swin3d.py:270)
            return window_attention(q, k, v, bias, mask)
        # dropout in training takes JAX's einsum branch on every device, as a
        # block under pallas_min_window does: the kernel applies no dropout.
        # The mask of window w = bn % nW: the bias and mask add once, [nW, h, N, N]
        nW = 1 if mask is None else mask.shape[0]
        add = bias[None] if mask is None else bias[None] + mask[:, None]
        split = lambda t: t.unflatten(0, (-1, nW))
        out = dot_attention(split(q), split(k), split(v), q.shape[-1] ** -0.5, add, rate, generator)
        return out.flatten(0, 1)

    def forward(self, x: torch.Tensor, mask: Optional[torch.Tensor] = None, group: int = 1,
                generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """x [Bn, N, C], N = group * window tokens; ``mask`` [nW, N, N] is the
        grouped mask whenever ``group > 1``."""
        Bn, N, C = x.shape
        qkv = self.qkv(x).view(Bn, N, 3, -1, C // self.num_heads).permute(2, 0, 3, 1, 4)
        if group > 1:
            bias = self._bias(N // group)
            eye = torch.eye(group, dtype=bias.dtype, device=bias.device)
            bias = torch.einsum("gk,hij->hgikj", eye, bias).reshape(-1, N, N)
        else:
            bias = self._bias(N)
        out = self._attend(qkv[0], qkv[1], qkv[2], bias, mask, generator)
        return self.proj(out.transpose(1, 2).reshape(Bn, N, -1))


class DropPath(nn.Module):
    """Stochastic depth per sample, in training mode only."""

    def __init__(self, rate: float):
        super().__init__()
        self.rate = rate

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        if not self.training:
            return x
        return dropout(x, self.rate, generator, shape=(x.shape[0],) + (1,) * (x.dim() - 1))


class SwinBlock3D(nn.Module):
    """W-MSA/SW-MSA block (ref ``SwinTransformerBlock3D`` ``:166-268``)."""

    def __init__(self, dim: int, num_heads: int, window: tuple, shift: tuple, mlp_ratio: float = 4.0,
                 qkv_bias: bool = True, attn_drop: float = 0.0, drop_path: float = 0.0,
                 dtype: torch.dtype = torch.float32, use_pallas: bool = False, fold: bool = False,
                 group_windows: bool = False, device=None):
        super().__init__()
        self.window = tuple(window)
        self.shift = tuple(shift)
        # the fold layout computes per-window scores, so grouping does not
        # compose with it (as in JAX); the outputs are the same either way
        self.group_windows = group_windows and not fold
        self.norm1 = LayerNorm(dim, 1e-5, dtype, device)
        self.attn = WindowAttention3D(dim, window, num_heads, qkv_bias, attn_drop, dtype, use_pallas, device)
        self.norm2 = LayerNorm(dim, 1e-5, dtype, device)
        self.mlp_fc1 = Linear(dim, int(dim * mlp_ratio), dtype=dtype, device=device)
        self.mlp_fc2 = Linear(int(dim * mlp_ratio), dim, dtype=dtype, device=device)
        self.drop_path1 = DropPath(drop_path)
        self.drop_path2 = DropPath(drop_path)

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None) -> torch.Tensor:
        B, D, H, W, C = x.shape
        window, shift = _clip_window((D, H, W), self.window, self.shift)

        shortcut = x
        x = self.norm1(x)
        pad_d, pad_h, pad_w = (-D) % window[0], (-H) % window[1], (-W) % window[2]
        if pad_d or pad_h or pad_w:
            x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h, 0, pad_d))
        Dp, Hp, Wp = D + pad_d, H + pad_h, W + pad_w

        shifted = any(s > 0 for s in shift)
        if shifted:
            x = torch.roll(x, shifts=(-shift[0], -shift[1], -shift[2]), dims=(1, 2, 3))

        N = window[0] * window[1] * window[2]
        G = pick_window_group(Wp // window[2], N) if self.group_windows else 1
        if G > 1:
            mask = device_constant(grouped_window_mask, ((Dp, Hp, Wp), window, shift, G), x.device)
        elif shifted:
            mask = device_constant(shifted_window_mask, ((Dp, Hp, Wp), window, shift), x.device)
        else:
            mask = None

        windows = window_partition(x, window)  # [B*nW, N, C]
        if G > 1:  # grouped windows are contiguous in B*nW
            windows = windows.reshape(windows.shape[0] // G, G * N, C)
        windows = self.attn(windows, mask, G, generator)
        if G > 1:
            windows = windows.reshape(-1, N, C)
        x = window_reverse(windows, window, B, Dp, Hp, Wp)

        if shifted:
            x = torch.roll(x, shifts=shift, dims=(1, 2, 3))
        if pad_d or pad_h or pad_w:
            x = x[:, :D, :H, :W]

        x = shortcut + self.drop_path1(x, generator)
        y = self.mlp_fc2(F.gelu(self.mlp_fc1(self.norm2(x))))  # exact erf gelu, as the JAX block
        return x + self.drop_path2(y, generator)


class PatchMerging(nn.Module):
    """2x2 spatial merge to ``2 * dim`` channels (ref ``:270-305``); the input
    has ``in_dim`` channels (default ``dim``)."""

    def __init__(self, dim: int, dtype: torch.dtype = torch.float32, device=None,
                 in_dim: Optional[int] = None):
        super().__init__()
        in_dim = dim if in_dim is None else in_dim
        self.norm = LayerNorm(4 * in_dim, 1e-5, dtype, device)
        self.reduction = Linear(4 * in_dim, 2 * dim, bias=False, dtype=dtype, device=device)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        _, _, H, W, _ = x.shape
        if H % 2 or W % 2:
            x = F.pad(x, (0, 0, 0, W % 2, 0, H % 2))
        x0 = x[:, :, 0::2, 0::2]
        x1 = x[:, :, 1::2, 0::2]
        x2 = x[:, :, 0::2, 1::2]
        x3 = x[:, :, 1::2, 1::2]
        return self.reduction(self.norm(torch.cat([x0, x1, x2, x3], dim=-1)))


class PatchEmbed3D(nn.Module):
    """Conv3D video patchify (ref ``:409-448``), two input paths with the same
    parameters: fp32 [B, C, D, H, W] frames normalized on the host, or raw
    uint8 [B, D, H, W, 3] frames normalized here in fp32 with the ImageNet
    statistics. Returns [B, D', H', W', embed_dim]. ``proj`` holds the conv
    weight [embed_dim, C, pd, ph, pw] and its bias."""

    def __init__(self, patch_size: tuple, embed_dim: int, in_chans: int = 3, patch_norm: bool = False,
                 dtype: torch.dtype = torch.float32, device=None):
        super().__init__()
        self.patch_size = tuple(patch_size)
        self.compute_dtype = dtype
        self.proj = nn.Conv3d(in_chans, embed_dim, self.patch_size, stride=self.patch_size, device=device)
        self.norm = LayerNorm(embed_dim, 1e-5, dtype, device) if patch_norm else None
        self.register_buffer("mean", torch.from_numpy(IMAGENET_MEAN.copy()).to(device), persistent=False)
        self.register_buffer("std", torch.from_numpy(IMAGENET_STD.copy()).to(device), persistent=False)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if x.dtype == torch.uint8:
            x = (x.float() / 255.0 - self.mean) / self.std  # [B, D, H, W, 3]
            x = x.permute(0, 4, 1, 2, 3)  # -> [B, C, D, H, W]
        pd, ph, pw = self.patch_size
        D, H, W = x.shape[2:]
        pad = ((-D) % pd, (-H) % ph, (-W) % pw)
        if any(pad):
            x = F.pad(x, (0, pad[2], 0, pad[1], 0, pad[0]))
        dt = self.compute_dtype
        x = F.conv3d(x.to(dt), self.proj.weight.to(dt), self.proj.bias.to(dt), stride=self.patch_size)
        x = x.permute(0, 2, 3, 4, 1)  # [B, D', H', W', C]
        return x if self.norm is None else self.norm(x)


_aten = torch.ops.aten
# jax.checkpoint_policies name -> the ops whose outputs the recompute keeps
REMAT_POLICIES = {
    "dots_saveable": (_aten.mm.default, _aten.addmm.default, _aten.bmm.default),
    "dots_with_no_batch_dims_saveable": (_aten.mm.default, _aten.addmm.default),
}


def remat_context_fn(policy: Optional[str]) -> Optional[Callable]:
    """The ``context_fn`` of ``torch.utils.checkpoint`` for a JAX remat policy
    name (None, full remat, for no policy); an unknown name raises."""
    if policy is None:
        return None
    if policy not in REMAT_POLICIES:
        raise ValueError(f"unknown remat_policy {policy!r}; known: {sorted(REMAT_POLICIES)}")
    saved = REMAT_POLICIES[policy]

    def policy_fn(ctx, op, *args, **kwargs):
        return CheckpointPolicy.MUST_SAVE if op in saved else CheckpointPolicy.PREFER_RECOMPUTE

    return functools.partial(create_selective_checkpoint_contexts, policy_fn)


class SwinTransformer3D(nn.Module):
    """The full HTWA encoder with the local branch (ref ``:450-620``).

    ``forward`` returns ``(global_feat [B, D, H, W, C], local_feat)``; the
    local branch is the PatchMerging-projected map captured when the temporal
    window first exceeds ``local_window``. Under ``faithful_local_branch`` it
    is the global map unless the capture happens on the last layer (the
    reference's shipped behaviour), and then it is not computed at all."""

    def __init__(self, config: Swin3DConfig, device=None):
        super().__init__()
        cfg = self.config = config
        # as JAX, a policy counts only under remat
        self.remat_context_fn = remat_context_fn(cfg.remat_policy or None) if cfg.remat else None
        dt = cfg.dtype
        self.patch_embed = PatchEmbed3D(cfg.patch_size, cfg.embed_dim, cfg.in_chans, cfg.patch_norm, dt, device)
        n = len(cfg.depths)
        dpr = np.linspace(0, cfg.drop_path_rate, sum(cfg.depths))
        last_window = tuple(cfg.window_size[n - 1])
        captured_on_last = last_window[0] > cfg.local_window and all(
            tuple(cfg.window_size[i])[0] <= cfg.local_window for i in range(n - 1)
        )
        self.local_used = not cfg.faithful_local_branch or captured_on_last
        self.local_at = next((i for i in range(n) if cfg.window_size[i][0] > cfg.local_window), None)
        channels, block_idx = cfg.embed_dim, 0
        for i_layer in range(n):
            window = tuple(cfg.window_size[i_layer])
            if i_layer == self.local_at:
                self.local_feat_proj = PatchMerging(cfg.embed_dim * 4, dt, device, in_dim=channels)
                self.norm_local = LayerNorm(cfg.embed_dim * 8, 1e-5, dt, device)
            dim = int(cfg.embed_dim * 2 ** cfg.stages[i_layer])
            shift = [w // 2 for w in window]
            if cfg.temporal_no_shifting:
                shift[0] = 0
            window_tokens = window[0] * window[1] * window[2]
            for b in range(cfg.depths[i_layer]):
                block = SwinBlock3D(
                    dim, cfg.num_heads[i_layer], window, (0, 0, 0) if b % 2 == 0 else tuple(shift),
                    cfg.mlp_ratio, cfg.qkv_bias, cfg.attn_drop_rate, float(dpr[block_idx]), dt,
                    use_pallas=cfg.use_pallas_attention and window_tokens >= cfg.pallas_min_window,
                    fold=cfg.attn_fold, group_windows=cfg.group_windows, device=device,
                )
                self.add_module(f"layers_{i_layer}_blocks_{b}", block)
                block_idx += 1
            channels = dim
            if i_layer in cfg.downsample_stages:
                self.add_module(f"layers_{i_layer}_downsample", PatchMerging(dim, dt, device))
                channels = 2 * dim
        self.norm = LayerNorm(channels, 1e-5, dt, device)

    def context_mesh(self) -> Optional[DataMesh]:
        """The mesh whose model group shards time (``context_parallel_axis``),
        or None."""
        if not self.config.context_parallel_axis:
            return None
        mesh = current_mesh()
        return mesh if mesh is not None and mesh.has_model_axis else None

    @staticmethod
    def runs_local(block: "SwinBlock3D", dims: tuple[int, int, int], cp: int) -> bool:
        """Whether ``block`` computes on ``T / cp`` frames as it would on the
        ``T`` of ``dims``: no temporal shift, and the window, clipped to the
        full input, tiles the local frames."""
        window, shift = _clip_window(dims, block.window, block.shift)
        return shift[0] == 0 and (dims[0] // cp) % window[0] == 0

    def forward(self, x: torch.Tensor, generator: Optional[torch.Generator] = None
                ) -> tuple[torch.Tensor, torch.Tensor]:
        cfg = self.config
        x = self.patch_embed(x)
        x = dropout(x, cfg.drop_rate if self.training else 0.0, generator)
        mesh = self.context_mesh()
        if mesh is not None:
            if x.shape[1] % mesh.model_size:
                raise ValueError(f"--cp {mesh.model_size} does not divide the {x.shape[1]} frames after the "
                                 "patch embed")
            x = model_block(x, 1, mesh).contiguous()
        local = mesh is not None  # x holds this rank's frames only
        local_feat = None
        for i_layer in range(len(cfg.depths)):
            if i_layer == self.local_at and self.local_used:
                local_feat = self.norm_local(self.local_feat_proj(x))
            for b in range(cfg.depths[i_layer]):
                block = getattr(self, f"layers_{i_layer}_blocks_{b}")
                if mesh is not None:
                    T = x.shape[1] * (mesh.model_size if local else 1)
                    fits = self.runs_local(block, (T, x.shape[2], x.shape[3]), mesh.model_size)
                    if fits and not local:
                        x = model_block(x, 1, mesh).contiguous()
                    elif local and not fits:  # the ranks' downstream work is split: sum the gradient
                        x = gather_model(x, 1, True, mesh)
                    local = fits
                if cfg.remat and torch.is_grad_enabled():
                    kwargs = {} if self.remat_context_fn is None else {"context_fn": self.remat_context_fn}
                    x = recomputed(block, generator, x, **kwargs)
                else:
                    x = block(x, generator)
            if i_layer in cfg.downsample_stages:
                x = getattr(self, f"layers_{i_layer}_downsample")(x)
            if mesh is not None and not local:  # re-shard after the stage
                x = model_block(x, 1, mesh).contiguous()
                local = True
        x = self.norm(x)
        if mesh is not None:  # what follows is the same on every model rank
            if local_feat is not None:
                local_feat = gather_model(local_feat, 1, False, mesh)
            x = gather_model(x, 1, False, mesh)
        if local_feat is None:
            local_feat = x
        return x, local_feat
