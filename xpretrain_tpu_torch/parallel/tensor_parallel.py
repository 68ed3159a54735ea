"""Tensor (Megatron) parallelism over the mesh's ``model`` axis
(``xpretrain_tpu/parallel/tensor_parallel.py``).

:func:`tp_pspec` is JAX's rule table, rule for rule: on the flax path of a
parameter, the q/k/v, fused ``qkv``, ``fc1`` and ``intermediate_dense``
projections are column-sharded (kernel and bias), the out, ``proj``,
``fc2``, ``attention_output_dense`` and ``output_dense`` kernels are
row-sharded (2-D kernels only: PatchEmbed3D's 5-D ``proj`` conv stays
replicated), their biases stay replicated, and a dim the model axis does not
divide falls back to replicated. TimeSformer's and Swin3D's ``mlp_fc1`` /
``mlp_fc2`` match no rule (the regex wants a ``/`` before ``fc1``), so they
stay replicated, as in JAX. The port applies the rule to each parameter
through its flax path (``models/clip_vip/convert.py:clip_key_rules``,
``models/lf_vila/convert.py:key_rules``), so it shards the leaves JAX
shards.

Where JAX annotates and lets GSPMD place the collectives, the port computes
each sharded layer on its block (:func:`apply_tensor_parallel`, a plan per
``common.Linear``): a column layer takes the replicated input through
:func:`~xpretrain_tpu_torch.parallel.mesh.copy_to_model` (its backward sums
the input gradient over the model group) and returns this rank's columns; a
row layer multiplies this rank's columns by its rows, adds the bias on model
rank 0 only and sums over the model group
(:func:`~xpretrain_tpu_torch.parallel.mesh.reduce_from_model`). Attention
runs on the rank's own heads: the attention modules read their head count
off the projections' width, so the kernels receive plain local tensors
(``[B, H/tp, S, D]`` for the proxy attention). Two differences from JAX's
layout, which change no number (ROADMAP Queue 3):

- a fused ``qkv`` is sharded per head, each rank holding its heads' rows of
  q, k and v (``LeafLayout.tp_parts`` = 3), where JAX splits the fused
  columns in one contiguous block;
- an attention whose head count the model axis does not divide stays
  replicated (q, k, v, out), where GSPMD shards its width: attention cannot
  stay head-local there (CLIP-ViP B/32's 12 heads at ``--tp 8``).

A replicated parameter that each rank uses for its share only (a row
layer's bias, a Swin3D bias table sliced to the rank's heads) gets a partial
gradient; its layout is ``model_partial`` and the train step sums it over
the model group. The optimizer state follows the parameters
(:func:`hybrid_state_pspec`): a TP-sharded leaf's moments are its TP
blocks, and under ``--zero2`` the other leaves of at least 16384 elements
are sharded over the data axis (``optim/optimizer.py:zero2_shard``).
"""

from __future__ import annotations

import re

import torch
import torch.nn.functional as F
from torch import nn

from xpretrain_tpu_torch.parallel.mesh import (
    DATA_AXIS,
    MODEL_AXIS,
    DataMesh,
    LeafLayout,
    copy_to_model,
    gather_model,
    local_leaf,
    model_block,
    reduce_from_model,
)

# (regex on the '/'-joined param path) -- JAX's, verbatim
_COLUMN = re.compile(
    r"/(q_proj|k_proj|v_proj|query|key|value|qkv|fc1|intermediate_dense)/(kernel|bias)$"
)
_ROW = re.compile(
    r"/(out_proj|proj|fc2|attention_output_dense|output_dense)/kernel$"
)

# flax kernel layout -> torch weight layout: torch dim i holds flax dim PERM[kind][i]
_PERM = {"linear": (1, 0), "conv2d": (3, 2, 0, 1), "conv3d": (4, 3, 0, 1, 2)}


def tp_pspec(path: str, shape: tuple[int, ...], mp: int) -> tuple:
    """JAX's ``tp_pspec`` as a tuple (``PartitionSpec`` entries): the mesh
    axis of each dim of the flax leaf at ``path`` of ``shape``."""
    path = path if path.startswith("/") else "/" + path
    if _COLUMN.search(path) is not None:
        dim = len(shape) - 1  # kernel: output dim; bias: its only dim
        if shape[dim] % mp == 0 and shape[dim] >= mp:
            spec = [None] * len(shape)
            spec[dim] = MODEL_AXIS
            return tuple(spec)
        return ()
    if _ROW.search(path) is not None and len(shape) == 2:
        if shape[0] % mp == 0 and shape[0] >= mp:
            spec = [None] * len(shape)
            spec[0] = MODEL_AXIS
            return tuple(spec)
    return ()


def hybrid_state_pspec(path: str, shape: tuple[int, ...], mp: int, dp: int, min_size: int = 16384) -> tuple:
    """JAX's ``hybrid_state_shardings`` for one optimizer-state leaf: the TP
    layout where the leaf is TP-sharded, else :func:`zero2_pspec`."""
    return tp_pspec(path, shape, mp) or zero2_pspec(shape, dp, min_size)


def zero2_pspec(shape: tuple[int, ...], dp: int, min_size: int = 16384) -> tuple:
    """JAX's ZeRO-2 rule for one leaf (``zero2_state_shardings``): the first
    dim ``dp`` divides, over ``data``, for a leaf of at least ``min_size``
    elements."""
    size = 1
    for extent in shape:
        size *= extent
    if size >= min_size:
        for dim, extent in enumerate(shape):
            if extent % dp == 0 and extent >= dp:
                zspec = [None] * len(shape)
                zspec[dim] = DATA_AXIS
                return tuple(zspec)
    return ()


def param_rules(model: nn.Module) -> dict[str, tuple[str, str]]:
    """Port parameter name -> ("/"-joined flax path, kernel layout kind) for
    the three families (CLIP-ViP's key table, or the module-path table of
    LF-VILA and HD-VILA)."""
    from xpretrain_tpu_torch.models.clip_vip.convert import clip_key_rules
    from xpretrain_tpu_torch.models.clip_vip.model import CLIPViPModel
    from xpretrain_tpu_torch.models.lf_vila.convert import key_rules

    if isinstance(model, CLIPViPModel):
        cfg = model.config
        rules = clip_key_rules(cfg.text.num_hidden_layers, cfg.vision.num_hidden_layers)
        names = dict(model.named_parameters())
        rules = {k: v for k, v in rules.items() if k in names}
    else:
        rules = key_rules(model)
    return {name: ("/" + "/".join(path), kind) for name, (path, kind) in rules.items()}


def flax_shape(shape: tuple[int, ...], kind: str) -> tuple[int, ...]:
    """The flax shape of a port parameter of ``shape`` and layout ``kind``."""
    perm = _PERM.get(kind)
    if perm is None or len(shape) != len(perm):
        return tuple(shape)
    out = [0] * len(shape)
    for i, f in enumerate(perm):
        out[f] = shape[i]
    return tuple(out)


def torch_dim(flax_dim: int, kind: str, ndim: int) -> int:
    """The port's dim of a parameter's flax dim ``flax_dim``."""
    perm = _PERM.get(kind)
    if perm is None or len(perm) != ndim:
        return flax_dim
    return perm.index(flax_dim)


class ColumnParallel:
    """The plan of a column-sharded ``common.Linear``: its weight holds this
    rank's output rows (and its bias their entries). A layer outside a unit
    (``gather``) all-gathers its output columns for what follows, which every
    model rank computes alike."""

    def __init__(self, mesh: DataMesh, gather: bool = False):
        self.mesh = mesh
        self.gather = gather

    def __call__(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = layer.compute_dtype
        bias = None if layer.bias is None else layer.bias.to(dt)
        y = F.linear(copy_to_model(x, self.mesh).to(dt), layer.weight.to(dt), bias)
        return gather_model(y, y.dim() - 1, False, self.mesh) if self.gather else y


class RowParallel:
    """The plan of a row-sharded ``common.Linear``: its weight holds this
    rank's input columns; the bias (replicated) adds on model rank 0, before
    the sum over the model group. A layer outside a unit (``scatter``) takes
    its input columns from a replicated input."""

    def __init__(self, mesh: DataMesh, scatter: bool = False):
        self.mesh = mesh
        self.scatter = scatter

    def __call__(self, layer: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        dt = layer.compute_dtype
        if self.scatter:
            x = model_block(copy_to_model(x, self.mesh), x.dim() - 1, self.mesh)
        bias = layer.bias.to(dt) if layer.bias is not None and self.mesh.model_rank == 0 else None
        return reduce_from_model(F.linear(x.to(dt), layer.weight.to(dt), bias), self.mesh)


def _units(model: nn.Module) -> list[tuple[str, nn.Module, list[str], list[str], int, int]]:
    """Every TP unit of the three families: (module name, module, column
    layer names, row layer names, head count or 0 for an MLP, fused parts of
    the column layers)."""
    from xpretrain_tpu_torch.models.bert import BertLayer
    from xpretrain_tpu_torch.models.clip_vip.model import ProxyAttention
    from xpretrain_tpu_torch.models.common import MultiHeadAttention, TransformerMLP
    from xpretrain_tpu_torch.models.hd_vila.timesformer import _MHA
    from xpretrain_tpu_torch.models.lf_vila.swin3d import WindowAttention3D

    units = []
    for name, m in model.named_modules():
        if isinstance(m, (ProxyAttention, MultiHeadAttention)):
            units.append((name, m, ["q_proj", "k_proj", "v_proj"], ["out_proj"], m.num_heads, 1))
        elif isinstance(m, BertLayer):
            units.append((name, m, ["attention_self.query", "attention_self.key", "attention_self.value"],
                          ["attention_output_dense"], m.config.num_attention_heads, 1))
            units.append((name, m, ["intermediate_dense"], ["output_dense"], 0, 1))
        elif isinstance(m, TransformerMLP):
            units.append((name, m, ["fc1"], ["fc2"], 0, 1))
        elif isinstance(m, (WindowAttention3D, _MHA)):
            units.append((name, m, ["qkv"], ["proj"], m.num_heads, 3))
    return units


def plan_tensor_parallel(model: nn.Module, mp: int, skip: tuple[nn.Module, ...] = ()
                         ) -> tuple[dict[str, tuple[str, int]], list[str]]:
    """The TP plan of ``model`` at model-axis size ``mp``: ({parameter name:
    (role, fused parts)}, [the attention units kept replicated because
    ``mp`` does not divide their heads]). Roles: ``column`` / ``row`` in a
    unit, ``column_gather`` / ``row_scatter`` for a layer outside one,
    ``partial`` for a row layer's bias, ``bias_table`` for a Swin3D table
    sliced to the rank's heads. A unit under a module of ``skip`` stays
    replicated (Swin3D under ``--cp``). Every parameter that
    :func:`tp_pspec` shards is planned or in a listed unit; one that is not
    a ``common.Linear``'s raises."""
    rules = param_rules(model)
    shapes = {n: tuple(p.shape) for n, p in model.named_parameters()}

    def sharded(name: str) -> bool:
        path, kind = rules[name]
        return bool(tp_pspec(path, flax_shape(shapes[name], kind), mp))

    skipped = {n for s in skip for n, _ in s.named_parameters()}
    skip_ids = {id(p) for s in skip for p in s.parameters()}
    plan: dict[str, tuple[str, int]] = {}
    indivisible: list[str] = []
    covered: set[str] = set()
    for name, m, cols, rows, heads, parts in _units(model):
        prefix = f"{name}." if name else ""
        members = [f"{prefix}{layer}.{leaf}" for layer in cols + rows for leaf in ("weight", "bias")]
        members = [n for n in members if n in shapes]
        covered.update(members)
        if any(id(p) in skip_ids for p in m.parameters()) or not any(sharded(n) for n in members):
            continue
        if heads and heads % mp:
            indivisible.append(name)
            continue
        for layer in cols:
            for leaf in ("weight", "bias"):
                if f"{prefix}{layer}.{leaf}" in shapes:
                    plan[f"{prefix}{layer}.{leaf}"] = ("column", parts)
        for layer in rows:
            plan[f"{prefix}{layer}.weight"] = ("row", 1)
            if f"{prefix}{layer}.bias" in shapes:
                plan[f"{prefix}{layer}.bias"] = ("partial", 1)
        if hasattr(m, "relative_position_bias_table"):
            plan[f"{prefix}relative_position_bias_table"] = ("bias_table", 1)
    # a layer JAX shards outside any unit (HD-VILA's ITC ``v_proj``): a column
    # layer gathers its output, a row layer takes its block of the input
    modules = dict(model.named_modules())
    for n in sorted(n for n in shapes if n not in covered and n not in skipped and sharded(n)):
        owner, _, leaf = n.rpartition(".")
        if not isinstance(modules[owner], nn.Linear) or not hasattr(modules[owner], "compute_dtype"):
            raise NotImplementedError(f"--tp {mp}: JAX shards {n}, which the port has no plan for")
        if _COLUMN.search(rules[n][0]):
            plan[n] = ("column_gather", 1)
        else:
            plan[n] = ("row_scatter", 1)
            if f"{owner}.bias" in shapes:
                plan[f"{owner}.bias"] = ("partial", 1)
    return plan, indivisible


@torch.no_grad()
def apply_tensor_parallel(model: nn.Module, mesh: DataMesh, skip: tuple[nn.Module, ...] = ()
                          ) -> dict[str, LeafLayout]:
    """Shard ``model`` in place over the model axis of ``mesh``
    (:func:`plan_tensor_parallel`): each planned parameter keeps its tensor
    object and holds this rank's block, each planned ``common.Linear`` gets
    its plan, and each sliced bias table its head range. Returns the layout
    of every parameter the plan touches (the others stay replicated with
    complete gradients). At ``model_size`` 1 the blocks are the whole leaves
    and the collectives run on one rank, exactly."""
    mp, r = mesh.model_size, mesh.model_rank
    plan, _ = plan_tensor_parallel(model, mp, skip)
    params = dict(model.named_parameters())
    modules = dict(model.named_modules())
    layouts: dict[str, LeafLayout] = {}
    for name, (role, parts) in plan.items():
        p = params[name]
        owner_name, _, leaf = name.rpartition(".")
        owner = modules[owner_name]
        full = tuple(p.shape)
        if role in ("column", "column_gather"):
            layout = LeafLayout(full, tp_dim=0, tp_parts=parts)
            owner.parallel = ColumnParallel(mesh, gather=role == "column_gather")
        elif role in ("row", "row_scatter"):
            layout = LeafLayout(full, tp_dim=1)
            owner.parallel = RowParallel(mesh, scatter=role == "row_scatter")
        else:
            layout = LeafLayout(full, model_partial=True)
            if role == "bias_table":
                h = full[1] // mp
                owner.tp_heads = (r * h, (r + 1) * h)
        if layout.tp_dim is not None:
            p.data = local_leaf(p.data, layout, mesh).clone()
        layouts[name] = layout
    return layouts


def tp_param_shardings(model: nn.Module, mesh: DataMesh) -> dict[str, tuple]:
    """JAX's ``tp_param_shardings`` on the port's parameters: {parameter
    name: :func:`tp_pspec` of its flax path and shape at the mesh's model
    size} (specs of the flax layout; :func:`apply_tensor_parallel` places
    them)."""
    rules = param_rules(model)
    return {n: tp_pspec(rules[n][0], flax_shape(tuple(p.shape), rules[n][1]), mesh.model_size)
            for n, p in model.named_parameters()}


def hybrid_state_shardings(model: nn.Module, mesh: DataMesh, min_size: int = 16384) -> dict[str, tuple]:
    """JAX's ``hybrid_state_shardings`` on the port's parameters: {parameter
    name: :func:`hybrid_state_pspec` of its moments} (the port's moments
    take the spec of their parameter's path, as optax's state paths end in
    it)."""
    rules = param_rules(model)
    return {n: hybrid_state_pspec(rules[n][0], flax_shape(tuple(p.shape), rules[n][1]), mesh.model_size,
                                  mesh.world_size, min_size)
            for n, p in model.named_parameters()}


__all__ = [
    "ColumnParallel",
    "RowParallel",
    "apply_tensor_parallel",
    "flax_shape",
    "hybrid_state_pspec",
    "hybrid_state_shardings",
    "param_rules",
    "plan_tensor_parallel",
    "torch_dim",
    "tp_param_shardings",
    "tp_pspec",
]

