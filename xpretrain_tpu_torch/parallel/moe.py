"""Expert parallelism: the mixture-of-experts FFN, its experts split over
an ``expert`` axis of the mesh (``xpretrain_tpu/parallel/moe.py``).

JAX's GShard/Switch dense dispatch, op for op: a router in fp32, top-k
routing with a fixed per-expert capacity ``C`` (tokens past it are dropped:
their output is zero), and the [T, E, C] one-hot ``dispatch`` / gate-
weighted ``combine`` tensors that turn routing into three einsums
(``td,tec->ecd``, the expert MLP over the E axis, ``ecd,tec->td``). The
Switch load-balancing loss comes back beside the output. The parameters are
JAX's einsum weights, not ``Linear``s: ``router`` [d, E] fp32, ``w1`` [E, d,
d_ff], ``b1`` [E, d_ff], ``w2`` [E, d_ff, d], ``b2`` [E, d], stored fp32
and cast to ``dtype`` at use (the biases at the add).

Under pjit JAX's module sees the global token array. The port's sees this
data index's tokens and routes them as the global array would be routed:
the capacity counts the tokens of every data index (``T_local · dp``), each
pass's queue positions are offset by the tokens the lower data indices
send to each expert (an all-gather of the [E] counts over the data group),
the fill after each pass counts every index's kept tokens, and the
auxiliary loss takes its means over the global tokens
(``mesh.gather_rows``, whose backward sums over the data group). So the
drops are JAX's whatever the capacity.

With ``expert_axis`` the module holds only its ``E / ep`` experts (rank
``e`` of the axis: experts ``[e·E/ep, (e+1)·E/ep)``) and computes them on
its tokens' slots: its input enters through ``mesh.copy_to_model`` (the
backward sums the input's gradient over the expert group), it dispatches
into its own experts' slots, and the experts' outputs are all-gathered over
the expert group (``mesh.gather_model``; the backward keeps the rank's
block) before the combine. A slot holds at most one token, so the sum over
the data group that JAX's layout implies adds exact zeros and is not
computed. ``state_dict`` gathers the expert leaves back to the reference
layout and ``load_state_dict`` takes the rank's block (``parallel/fsdp.py``'s
checkpoint hooks).

Gradient convention, the mesh's: every rank computes the global loss, and
the step averages every gradient over the data group. An expert leaf's
gradient on its rank is complete for that data index's tokens (no sum over
the expert group); the router, replicated, likewise.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Mapping, Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from xpretrain_tpu_torch.parallel.mesh import (
    DataMesh,
    LeafLayout,
    axis_group,
    copy_to_model,
    current_mesh,
    gather_model,
    gather_rows,
    local_leaf,
)

EXPERT_AXIS = "expert"
_EXPERT_LEAVES = ("w1", "w2", "b1", "b2")


def _gelu(x: torch.Tensor) -> torch.Tensor:
    return F.gelu(x, approximate="tanh")  # flax's nn.gelu default


def _topk_dispatch(probs: torch.Tensor, k: int, capacity: int, mesh: Optional[DataMesh] = None
                   ) -> tuple[torch.Tensor, torch.Tensor]:
    """Top-k capacity-bounded routing masks, both [T, E, C]: ``dispatch`` the
    0/1 send-token-t-to-slot-(e, c) tensor, ``combine`` the same carrying the
    gate. Greedy passes (every token's 1st choice, then its 2nd, ...), each
    filling expert slots in token order; ``probs`` [T, E] are this data
    index's tokens of the global order across ``mesh``'s data group."""
    _, E = probs.shape
    n, index = (1, 0) if mesh is None else (mesh.world_size, mesh.rank)
    remaining = probs
    fill = torch.zeros(E, dtype=probs.dtype, device=probs.device)  # slots used per expert (integers)
    slots = torch.arange(capacity, device=probs.device)
    dispatch = probs.new_zeros((probs.shape[0], E, capacity))
    combine = probs.new_zeros((probs.shape[0], E, capacity))
    for _ in range(k):
        expert = torch.argmax(remaining, dim=-1)  # the first maximum, as jnp.argmax
        gate = torch.gather(remaining, -1, expert[:, None])[:, 0]
        mask = F.one_hot(expert, E).to(probs.dtype)
        counts = mask.sum(dim=0)
        offset = torch.zeros_like(counts)
        if n > 1:  # the lower data indices' tokens go first in each expert's queue
            every = gather_rows(counts[None].detach(), mesh)
            offset, counts = every[:index].sum(dim=0), every.sum(dim=0)
        pos = (torch.cumsum(mask, dim=0) - 1.0) + (fill + offset)[None, :]
        pos = (pos * mask).to(torch.int64)
        keep = mask * (pos < capacity).to(probs.dtype)
        sel = keep[..., None] * (pos[..., None] == slots).to(probs.dtype)
        dispatch = dispatch + sel
        combine = combine + sel * gate[:, None, None]
        fill = fill + torch.minimum((capacity - fill).clamp_min(0), counts)  # every index's kept tokens
        remaining = remaining * (1.0 - mask)  # the next pass picks a new expert
    return dispatch, combine


def load_balance_loss(probs: torch.Tensor, dispatch: torch.Tensor, mesh: Optional[DataMesh] = None
                      ) -> torch.Tensor:
    """Switch auxiliary loss over the global tokens: E · Σ_e (mean router
    prob)·(mean routed fraction); 1 when routing is uniform."""
    E = probs.shape[-1]
    density = gather_rows(dispatch.sum(dim=-1), mesh).mean(dim=0)
    density_proxy = gather_rows(probs, mesh).mean(dim=0)
    return E * torch.sum(density * density_proxy)


def moe_pspec(path: str, shape: tuple[int, ...]) -> tuple:
    """JAX's partition spec of one MoE leaf, as a tuple: the expert-major
    [E, ...] leaves (``w1``, ``w2``, ``b1``, ``b2``) split dim 0 over
    ``expert``; the router (and anything else) is replicated. ``path`` is a
    flax path ("/") or a port name (".")."""
    if re.split(r"[/.]", path)[-1] in _EXPERT_LEAVES and len(shape) >= 1:
        return (EXPERT_AXIS,) + (None,) * (len(shape) - 1)
    return ()


def _expert_layouts(params: Mapping[str, torch.Tensor]) -> dict[str, LeafLayout]:
    return {n: LeafLayout(tuple(p.shape), tp_dim=0) for n, p in params.items() if moe_pspec(n, tuple(p.shape))}


def moe_param_shardings(params: Mapping[str, torch.Tensor], mesh: Optional[DataMesh] = None
                        ) -> dict[str, torch.Tensor]:
    """JAX's ``moe_param_shardings`` as what it places on a rank: the rank's
    block of each expert leaf of ``params`` (a state dict in the reference
    layout) along dim 0 over the mesh's expert axis (its trailing axis), the
    other leaves whole."""
    mesh = mesh or current_mesh()
    layouts = _expert_layouts(params)
    if mesh is None or not layouts:
        return dict(params)
    return {n: local_leaf(p, layouts[n], mesh) if n in layouts else p for n, p in params.items()}


class MoeFfn(nn.Module):
    """Expert-parallel FFN block: router -> dispatch -> per-expert MLP ->
    combine; ``forward(x)`` [..., d_model] -> (y [..., d_model], aux scalar).

    ``expert_axis`` names the mesh axis the experts split over (None: every
    rank holds all of them); ``mesh`` defaults to the current mesh, whose
    data group the routing spans."""

    def __init__(self, d_model: int, num_experts: int, d_ff: int, num_selected: int = 1,
                 capacity_factor: float = 1.25, expert_axis: Optional[str] = None,
                 mesh: Optional[DataMesh] = None, dtype: torch.dtype = torch.float32,
                 activation: Callable[[torch.Tensor], torch.Tensor] = _gelu, device=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.num_experts, self.d_ff, self.num_selected = num_experts, d_ff, num_selected
        self.capacity_factor, self.dtype, self.activation = capacity_factor, dtype, activation
        self.mesh = mesh
        E = num_experts

        def lecun(*shape: int) -> nn.Parameter:  # flax's lecun_normal: fan_in = shape[-2] x the leading dims
            t = torch.empty(shape, dtype=torch.float32, device=device)
            std = (1.0 / (shape[-2] * math.prod(shape[:-2]))) ** 0.5 / 0.87962566103423978
            return nn.Parameter(nn.init.trunc_normal_(t, std=std, a=-2 * std, b=2 * std, generator=generator))

        self.router = lecun(d_model, E)
        self.w1 = lecun(E, d_model, d_ff)
        self.b1 = nn.Parameter(torch.zeros(E, d_ff, device=device))
        self.w2 = lecun(E, d_ff, d_model)
        self.b2 = nn.Parameter(torch.zeros(E, d_model, device=device))
        self.experts = (0, E)
        self.expert_mesh: Optional[DataMesh] = None
        if expert_axis is not None:
            self._shard_experts(mesh or current_mesh(), expert_axis)

    @torch.no_grad()
    def _shard_experts(self, mesh: Optional[DataMesh], axis: str) -> None:
        from xpretrain_tpu_torch.parallel.fsdp import _register_checkpoint_hooks

        size, index, _ = axis_group(mesh, axis)
        if self.num_experts % size:
            raise ValueError(f"{self.num_experts} experts not divisible by {axis}={size}")
        if mesh is None or not mesh.has_model_axis:
            return
        per = self.num_experts // size
        self.experts, self.expert_mesh = (index * per, (index + 1) * per), mesh
        layouts = _expert_layouts(dict(self.named_parameters()))
        for name, layout in layouts.items():
            p = getattr(self, name)
            p.data = local_leaf(p.data, layout, mesh).clone()
        _register_checkpoint_hooks(self, layouts, mesh)
        self.__dict__["param_layouts"] = layouts

    def forward(self, x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        *lead, d = x.shape
        mesh = self.mesh or current_mesh()
        T = math.prod(lead) * (1 if mesh is None else mesh.world_size)  # the global token count
        E, k, dt = self.num_experts, self.num_selected, self.dtype
        capacity = max(1, int(math.ceil(k * T / E * self.capacity_factor)))
        xt = x.reshape(-1, d)

        # router in fp32, gates renormalized over the k picks (GShard); top-1
        # keeps the raw prob (Switch), which feeds the main loss's gradient
        # back into the router
        probs = torch.softmax(xt.float() @ self.router, dim=-1)
        dispatch, combine = _topk_dispatch(probs, k, capacity, mesh)
        if k > 1:
            combine = combine / combine.sum(dim=(1, 2), keepdim=True).clamp_min(1e-9)
        aux = load_balance_loss(probs, dispatch, mesh)

        lo, hi = self.experts
        xin = xt.to(dt) if self.expert_mesh is None else copy_to_model(xt.to(dt), self.expert_mesh)
        ein = torch.einsum("td,tec->ecd", xin, dispatch[:, lo:hi].to(dt))
        h = self.activation(torch.einsum("ecd,edf->ecf", ein, self.w1.to(dt)) + self.b1[:, None, :].to(dt))
        out_e = torch.einsum("ecf,efd->ecd", h, self.w2.to(dt)) + self.b2[:, None, :].to(dt)
        if self.expert_mesh is not None:
            out_e = gather_model(out_e, 0, reduce=False, mesh=self.expert_mesh)
        y = torch.einsum("ecd,tec->td", out_e, combine.to(dt))
        return y.reshape(*lead, d), aux


def moe_params_from_flax(params: Mapping) -> dict[str, torch.Tensor]:
    """A flax ``MoeFfn`` params tree (numpy or jax arrays, with or without
    the ``params`` level) -> the port's state dict in the reference layout:
    key for key, no transpose (einsum weights), fp32. ``load_state_dict``
    of an expert-sharded module takes the rank's block."""
    tree = params.get("params", params)
    return {k: torch.from_numpy(np.array(v, dtype=np.float32)) for k, v in tree.items()}


__all__ = [
    "EXPERT_AXIS",
    "MoeFfn",
    "load_balance_loss",
    "moe_param_shardings",
    "moe_params_from_flax",
    "moe_pspec",
]
