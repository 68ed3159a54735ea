"""ZeRO-3 / FSDP and the layout policy of the trainers
(``xpretrain_tpu/parallel/fsdp.py``).

:func:`fsdp_pspec` is JAX's rule: a leaf of at least ``min_size`` elements
is split over ``data`` along its largest dim that the data axis divides
(after the model-axis dim when ``tp > 1``); smaller leaves stay replicated.
:func:`resolve_shardings` is JAX's one policy for ``--tp / --zero2 /
--zero3``, here on the flax paths and shapes of the port's parameters:

- ``zero3``: parameters and moments over ``data`` (on top of TP when
  ``tp > 1``);
- ``tp > 1`` alone: the Megatron layout, moments hybrid (TP where the
  parameter is TP-sharded, else ZeRO-2 over ``data`` unless ``zero2`` is
  off);
- otherwise parameters replicated, moments ZeRO-2 unless ``zero2`` is off.

:func:`apply_layouts` puts that policy on a model in place, before its
optimizer is built (both trainers call it): tensor parallelism and Swin3D's
context parallelism (``parallel/tensor_parallel.py``,
``models/lf_vila/swin3d.py``), then ZeRO-3. Under ZeRO-3 each sharded
parameter keeps its tensor object and holds this rank's block along JAX's
dim (mapped through the flax layout to the port's). A module ``unit`` (a
transformer block: ``layers.<i>``, ``layer_<i>``, ``blocks_<i>``,
``layers_<i>_blocks_<j>``) all-gathers its parameters when it is called and
drops them after; the root holds the rest, gathered while the model is
called (and for the whole train step, :func:`step_scope`, or the whole
evaluation, :func:`gathered`). A gathered parameter shadows the block in
its module's ``__dict__``, so ``named_parameters`` still names the blocks
the optimizer updates. The gather's backward reduce-scatters the gradient
over the data group and averages it (the data-parallel convention: every
rank computes the global loss). The gather is autograd's, so a recomputed
(remat) block gathers again in the backward.

Checkpoints hold the reference layout under every layout: a sharded
parameter's ``state_dict`` entry is gathered (a collective: every rank
calls ``state_dict``), and ``load_state_dict`` takes this rank's block of a
full tensor, so a file written under any layout loads under any other.
"""

from __future__ import annotations

import contextlib
import re
from typing import Iterator, Mapping, Optional

import torch
import torch.distributed as dist
from torch import nn

from xpretrain_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    DataMesh,
    LeafLayout,
    _blocks,
    _gather,
    _reduce_scatter_single,
    full_leaf,
    local_leaf,
    mesh_from_config,
)
from xpretrain_tpu_torch.parallel.tensor_parallel import (
    apply_tensor_parallel,
    flax_shape,
    hybrid_state_pspec,
    param_rules,
    torch_dim,
    tp_pspec,
    zero2_pspec,
)

MIN_SIZE = 16384  # JAX's min_size of ZeRO-2 and ZeRO-3
_UNIT = re.compile(r"(^|\.)(layers\.\d+|layer_\d+|blocks_\d+|layers_\d+_blocks_\d+)$")


def fsdp_pspec(path: str, shape: tuple[int, ...], dp: int, tp: int = 1, min_size: int = MIN_SIZE) -> tuple:
    """JAX's ``fsdp_pspec`` as a tuple: the TP layout when ``tp > 1``, then
    the largest remaining dim ``dp`` divides over ``data`` for a leaf of at
    least ``min_size`` elements; trailing Nones dropped."""
    spec: list = [None] * len(shape)
    if tp > 1:
        for dim, axis in enumerate(tp_pspec(path, shape, tp)):
            spec[dim] = axis
    size = 1
    for extent in shape:
        size *= extent
    if size >= min_size:
        best = None
        for dim, extent in enumerate(shape):
            if spec[dim] is None and extent % dp == 0 and extent >= dp:
                if best is None or extent > shape[best]:
                    best = dim
        if best is not None:
            spec[best] = DATA_AXIS
    while spec and spec[-1] is None:
        spec.pop()
    return tuple(spec)


def resolve_shardings(cfg, model: nn.Module, dp: int, mp: int = 1, min_size: int = MIN_SIZE
                      ) -> tuple[Optional[dict], Optional[dict]]:
    """JAX's ``resolve_shardings`` on ``model``'s parameters at a mesh of
    ``dp`` data by ``mp`` model indices: ({parameter name: the flax spec of
    the parameter} or None, {parameter name: the flax spec of its moments}
    or None), None where JAX's tree is None."""
    tp = int(cfg.get("tp", 1) or 1)
    zero2 = bool(cfg.get("zero2", True))
    rules = param_rules(model)
    shapes = {n: flax_shape(tuple(p.shape), rules[n][1]) for n, p in model.named_parameters()}
    paths = {n: rules[n][0] for n in shapes}
    if cfg.get("zero3"):
        specs = {n: fsdp_pspec(paths[n], s, dp, tp, min_size) for n, s in shapes.items()}
        return specs, dict(specs)
    if tp > 1:
        return ({n: tp_pspec(paths[n], s, mp) for n, s in shapes.items()},
                {n: hybrid_state_pspec(paths[n], s, mp, dp, min_size if zero2 else 1 << 62)
                 for n, s in shapes.items()})
    return None, ({n: zero2_pspec(s, dp, min_size) for n, s in shapes.items()} if zero2 else None)


def fsdp_param_shardings(model: nn.Module, mesh: DataMesh, tp: int = 1, min_size: int = MIN_SIZE
                         ) -> dict[str, tuple]:
    """JAX's ``fsdp_param_shardings`` on the port's parameters: {parameter
    name: :func:`fsdp_pspec` of its flax path and shape} (flax-layout specs;
    :func:`apply_zero3` places them)."""
    rules = param_rules(model)
    return {n: fsdp_pspec(rules[n][0], flax_shape(tuple(p.shape), rules[n][1]), mesh.world_size, tp, min_size)
            for n, p in model.named_parameters()}


def fsdp_state_shardings(model: nn.Module, mesh: DataMesh, tp: int = 1, min_size: int = MIN_SIZE
                         ) -> dict[str, tuple]:
    """JAX's ``fsdp_state_shardings``: the moments of each parameter take its
    :func:`fsdp_param_shardings` spec (optax's state paths end in the
    parameter's path)."""
    return fsdp_param_shardings(model, mesh, tp, min_size)


class _GatherShard(torch.autograd.Function):
    """All-gather a ZeRO-3 block over the data group along ``dim``; the
    backward reduce-scatters the gradient and averages it over the group."""

    @staticmethod
    def forward(ctx, shard: torch.Tensor, dim: int, mesh: DataMesh) -> torch.Tensor:
        ctx.dim, ctx.mesh = dim, mesh
        return _gather(shard.movedim(dim, 0), mesh).movedim(0, dim).contiguous()

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh, dim = ctx.mesh, ctx.dim
        moved = grad.movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // mesh.world_size, *moved.shape[1:]), dtype=grad.dtype,
                          device=grad.device)
        _reduce_scatter_single(out, moved, op=dist.ReduceOp.SUM, group=mesh.group)
        return out.div_(mesh.world_size).movedim(0, dim), None, None


def _gather_shard(p: torch.Tensor, dim: int, mesh: DataMesh) -> torch.Tensor:
    if p.requires_grad and torch.is_grad_enabled():
        return _GatherShard.apply(p, dim, mesh)
    with torch.no_grad():
        return _gather(p.detach().movedim(dim, 0), mesh).movedim(0, dim).contiguous()


class Zero3:
    """The ZeRO-3 state of a model: per unit (and the root, key ""), the
    (module, attribute, parameter, dim) of its sharded parameters."""

    def __init__(self, mesh: DataMesh, units: dict[str, list[tuple[nn.Module, str, nn.Parameter, int]]]):
        self.mesh = mesh
        self.units = units
        self.stack: list[list[tuple[nn.Module, str]]] = []

    def materialize(self, entries) -> list[tuple[nn.Module, str]]:
        """Gather each entry's parameter into its module's ``__dict__``
        (skipping those already there); returns what it set."""
        done = []
        for module, attr, p, dim in entries:
            if attr in module.__dict__:
                continue
            module.__dict__[attr] = _gather_shard(p, dim, self.mesh)
            done.append((module, attr))
        return done

    @staticmethod
    def release(done) -> None:
        for module, attr in done:
            module.__dict__.pop(attr, None)

    def hooks(self, key: str):
        entries = self.units[key]

        def pre(module, args):
            self.stack.append(self.materialize(entries))

        def post(module, args, output):
            self.release(self.stack.pop())

        return pre, post

    @contextlib.contextmanager
    def scope(self, keys) -> Iterator[None]:
        done = []
        try:
            for key in keys:
                done += self.materialize(self.units[key])
            yield
        finally:
            self.release(done)


def _zero3_of(model: nn.Module) -> Optional[Zero3]:
    return model.__dict__.get("zero3")


def step_scope(model: nn.Module):
    """The root's parameters gathered (with gradients) for a train step's
    forward and backward; a null context without ZeRO-3."""
    z = _zero3_of(model)
    return contextlib.nullcontext() if z is None else z.scope([""])


@contextlib.contextmanager
def gathered(model: nn.Module) -> Iterator[None]:
    """Every parameter gathered, without gradients, for an evaluation: no
    collective runs per forward, so ranks may run different numbers of
    batches. Nothing happens without ZeRO-3."""
    z = _zero3_of(model)
    if z is None:
        yield
        return
    with torch.no_grad(), z.scope(list(z.units)):
        yield


def _unit_of(module_name: str, unit_names: list[str]) -> str:
    """The innermost unit that holds ``module_name`` ("" for the root)."""
    best = ""
    for u in unit_names:
        if (module_name == u or module_name.startswith(u + ".")) and len(u) > len(best):
            best = u
    return best


@torch.no_grad()
def apply_zero3(model: nn.Module, mesh: DataMesh, layouts: dict[str, LeafLayout], specs: Mapping[str, tuple]
                ) -> dict[str, LeafLayout]:
    """Shard ``model``'s parameters over the data group of ``mesh`` in place,
    each along the data dim of its flax spec in ``specs``
    (:func:`resolve_shardings`' ``zero3`` specs; JAX's dim mapped through the
    flax layout to the port's), on top of the TP ``layouts``; registers the
    units' gather hooks. Returns the updated layouts."""
    rules = param_rules(model)
    modules = dict(model.named_modules())
    unit_names = [n for n in modules if n and _UNIT.search(n)]
    units: dict[str, list] = {"": [], **{u: [] for u in unit_names}}
    layouts = dict(layouts)
    for name, p in model.named_parameters():
        spec = specs[name]
        if DATA_AXIS not in spec:
            continue
        prev = layouts.get(name, LeafLayout(tuple(p.shape)))
        dim = torch_dim(spec.index(DATA_AXIS), rules[name][1], len(prev.full_shape))
        if prev.tp_dim == dim:  # cannot happen with JAX's rule: the TP dim is taken
            raise AssertionError(f"{name}: ZeRO-3 and TP split the same dim")
        layouts[name] = LeafLayout(prev.full_shape, prev.tp_dim, prev.tp_parts, dim, prev.model_partial)
        p.data = _blocks(p.data, dim, mesh.world_size)[mesh.rank].clone()
        owner_name, _, attr = name.rpartition(".")
        units[_unit_of(owner_name, unit_names)].append((modules[owner_name], attr, p, dim))
    z = Zero3(mesh, {k: v for k, v in units.items() if v or k == ""})
    for key in z.units:
        module = modules[key]
        pre, post = z.hooks(key)
        module.register_forward_pre_hook(pre)
        module.register_forward_hook(post)
    model.__dict__["zero3"] = z
    return layouts


def _register_checkpoint_hooks(model: nn.Module, layouts: Mapping[str, LeafLayout], mesh: DataMesh) -> None:
    """``state_dict`` gathers each sharded parameter to the reference layout;
    ``load_state_dict`` takes this rank's block of a full tensor."""
    modules = dict(model.named_modules())
    by_owner: dict[str, dict[str, LeafLayout]] = {}
    for name, layout in layouts.items():
        if layout.sharded:
            owner, _, attr = name.rpartition(".")
            by_owner.setdefault(owner, {})[attr] = layout

    for owner, attrs in by_owner.items():
        def save(module, state_dict, prefix, local_metadata, attrs=attrs):
            for attr, layout in attrs.items():
                if prefix + attr in state_dict:
                    state_dict[prefix + attr] = full_leaf(module._parameters[attr].detach(), layout, mesh)

        def load(module, state_dict, prefix, local_metadata, strict, missing, unexpected, errors, attrs=attrs):
            for attr, layout in attrs.items():
                value = state_dict.get(prefix + attr)
                if value is not None and tuple(value.shape) == tuple(layout.full_shape):
                    state_dict[prefix + attr] = local_leaf(value, layout, mesh).contiguous()

        modules[owner].register_state_dict_post_hook(save)
        modules[owner].register_load_state_dict_pre_hook(load)


def full_shapes(model: nn.Module) -> dict[str, tuple[int, ...]]:
    """{parameter name: its shape in the reference layout} (the stored shape
    where the model is not laid out)."""
    layouts = model.__dict__.get("param_layouts", {})
    return {n: tuple(layouts[n].full_shape) if n in layouts else tuple(p.shape)
            for n, p in model.named_parameters()}


def apply_layouts(cfg, model: nn.Module) -> dict[str, LeafLayout]:
    """Lay ``model`` out in place as ``cfg`` asks (``--tp``, ``--cp``,
    ``--zero3``) on the mesh of :func:`mesh_from_config`, by
    :func:`resolve_shardings`' policy, before its optimizer is built; returns
    the layout of every parameter it touched ({} for a replicated model,
    which is left as it is)."""
    mesh = mesh_from_config(cfg)
    tp = int(cfg.get("tp", 1) or 1)
    cp = int(cfg.get("cp", 1) or 1)
    layouts: dict[str, LeafLayout] = {}
    if mesh is None:
        return layouts
    specs, _ = resolve_shardings(cfg, model, mesh.world_size, mesh.model_size, MIN_SIZE)
    swin = _context_parallel_encoders(model) if cp > 1 else ()
    if tp > 1:
        layouts = apply_tensor_parallel(model, mesh, skip=swin)
    for encoder in swin:
        prefix = next(n for n, m in model.named_modules() if m is encoder)
        for name, p in encoder.named_parameters():
            full = f"{prefix}.{name}" if prefix else name
            layouts[full] = LeafLayout(tuple(p.shape), model_partial=True)
    if cfg.get("zero3"):
        layouts = apply_zero3(model, mesh, layouts, specs)
    if layouts:
        _register_checkpoint_hooks(model, layouts, mesh)
        model.__dict__["param_layouts"] = layouts
    return layouts


def _context_parallel_encoders(model: nn.Module) -> tuple[nn.Module, ...]:
    from xpretrain_tpu_torch.models.lf_vila.swin3d import SwinTransformer3D

    return tuple(m for m in model.modules()
                 if isinstance(m, SwinTransformer3D) and m.config.context_parallel_axis)


__all__ = [
    "MIN_SIZE",
    "apply_layouts",
    "apply_zero3",
    "full_shapes",
    "fsdp_param_shardings",
    "fsdp_pspec",
    "fsdp_state_shardings",
    "gathered",
    "resolve_shardings",
    "step_scope",
]
