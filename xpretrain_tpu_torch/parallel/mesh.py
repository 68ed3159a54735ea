"""The process groups of the mesh and their collectives
(``xpretrain_tpu/parallel/mesh.py``).

JAX runs one SPMD program over a device mesh; here each rank is a process
that drives one device, joined by a ``torch.distributed`` group: NCCL for
CUDA devices, gloo for the CPU (the CPU tests). The reference bootstraps the
same way (Horovod ``hvd.init()`` at ``CLIP-ViP/src/pretrain/run_pretrain.py:470``,
``deepspeed.init_distributed()`` at ``LF-VILA/src/run_pretrain.py:120``).

:class:`DataMesh` stands for the mesh of this process. Without a model axis
it is JAX's 1-D ``data`` mesh: ``rank`` and ``world_size`` are the process's
rank and the group's size. ``--tp`` / ``--cp`` > 1 (:func:`mesh_from_config`)
make it JAX's 2-D ``(data, model)`` mesh of ``world // mp`` by ``mp``, with
the model axis trailing as in JAX's ``create_mesh((n // mp, mp))``: global
rank ``r`` sits at data index ``r // mp`` and model index ``r % mp``. Then
``rank`` / ``world_size`` are the data index and count, ``group`` is the
rank's data group (the ranks of its model index), and ``model_rank`` /
``model_size`` / ``model_group`` are its place on the model axis (the ranks
of its data index). The ranks of one model group read the same batch rows
(:func:`process_index_count` returns the data index and count), draw the
same dropout masks (``parallel/train_step.py`` seeds by the data index) and
compute the same loss; every collective of this module but the model-axis
ones acts on the data group.

The losses see the global batch as JAX's do: :func:`gather_rows` all-gathers
features with a backward that sums the gradient over ranks (LF-VILA's
``SyncFunction``, ``LF-VILA/src/utils/dist.py:21-41``). Every rank then
computes the same global loss, so each rank's gradient is N times its share,
and the train step *averages* the parameter gradients over ranks
(:func:`all_reduce_mean_`). A loss that stays on a rank's own rows follows
the same convention when its value is a per-rank term whose mean over ranks
is the global loss (a mean over equal per-rank batches is one; a mean over a
data-dependent count takes the global count, ``ops/losses.py``).

Every collective here runs on the group's device: a CUDA tensor never goes
through a gloo group (it raises). Without a group (no ``WORLD_SIZE`` in the
environment) every helper is the identity and nothing is communicated.

The current mesh (:func:`current_mesh`) is the run's: the group's 1-D mesh,
or the 2-D mesh of ``--tp`` / ``--cp``. The helpers default to it, as JAX's
code defaults to the ambient ``with mesh:``. :func:`create_mesh` builds the
``seq``, ``pipe`` and ``expert`` meshes of ring attention, the pipeline and
the MoE FFN, as JAX's does: it returns them and never makes one current.
"""

from __future__ import annotations

import dataclasses
import datetime
import os
from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
NO_GROUP = "none"  # the backend of create_mesh's one-rank mesh in a process without a group

# torch 2.13 renamed the tensor forms; the card's torch has only the old names
_all_gather_single = getattr(dist, "all_gather_single", None) or dist.all_gather_into_tensor
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or dist.reduce_scatter_tensor


@dataclasses.dataclass(frozen=True)
class DataMesh:
    """The mesh of this process: data index ``rank`` of ``world_size``,
    driving ``device`` (``cuda:LOCAL_RANK`` under NCCL, ``cpu`` under gloo).
    ``group`` is the data group (None: the default group, when the mesh has
    no model axis); ``model_group`` is None without a model axis.
    ``global_rank`` is the process's rank in the default group.
    ``model_axis`` names the trailing axis: ``model`` (``--tp`` / ``--cp``),
    or the ``seq``, ``pipe`` or ``expert`` axis of :func:`create_mesh`.
    ``backend`` is ``nccl``, ``gloo``, or :data:`NO_GROUP` for the one-rank
    mesh of a process without a group, whose collectives are the identity."""

    rank: int
    world_size: int
    device: torch.device
    backend: str
    group: Optional[dist.ProcessGroup] = None
    model_rank: int = 0
    model_size: int = 1
    model_group: Optional[dist.ProcessGroup] = None
    global_rank: int = 0
    model_axis: str = MODEL_AXIS

    @property
    def has_model_axis(self) -> bool:
        return self.model_group is not None


_MESH: Optional[DataMesh] = None


def maybe_init_distributed(device: str | torch.device = "cuda", init_method: Optional[str] = None,
                           timeout: Optional[datetime.timedelta] = None) -> Optional[DataMesh]:
    """Join the data-parallel group that the environment describes, once.

    The decision is made from the environment only, as JAX's: torchrun's
    ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK``, with ``MASTER_ADDR`` /
    ``MASTER_PORT`` for the rendezvous, or the ``init_method`` the caller
    passes (``file://...`` in the CPU tests). Without ``WORLD_SIZE`` and
    without ``init_method`` this is one process with no group: returns None.
    ``WORLD_SIZE=1`` makes a group of one, whose collectives run (and are
    exact). The backend is NCCL for a CUDA ``device``, whose index becomes
    ``LOCAL_RANK``, and gloo for the CPU. A second call returns the group of
    the first. An init that fails raises: the process never falls back to
    running alone."""
    global _MESH
    if _MESH is not None:
        return _MESH
    env = os.environ
    if init_method is None and "WORLD_SIZE" not in env:
        return None
    world = int(env.get("WORLD_SIZE", "1"))
    rank = int(env.get("RANK", "0"))
    local_rank = int(env.get("LOCAL_RANK", str(rank)))
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"WORLD_SIZE={world} with a CUDA device, but torch sees no CUDA device")
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
        backend = "nccl"
    elif dev.type == "cpu":
        backend = "gloo"
    else:
        raise ValueError(f"data parallelism runs on cuda or cpu devices, not {dev}")
    try:
        if not dist.is_initialized():
            kwargs = {} if timeout is None else {"timeout": timeout}
            if backend == "nccl":
                kwargs["device_id"] = dev  # the communicator forms now, before any graph capture
            dist.init_process_group(backend, init_method=init_method or "env://", world_size=world, rank=rank,
                                    **kwargs)
        if dist.get_backend() != backend or dist.get_world_size() != world:
            raise RuntimeError(f"a {dist.get_backend()} group of {dist.get_world_size()} ranks is already "
                               f"initialized; this process asked for {backend} at WORLD_SIZE={world}")
    except Exception as e:
        raise RuntimeError(f"rank {rank} of WORLD_SIZE={world}: the {backend} process group did not form "
                           f"({type(e).__name__}: {e}); not running as one process") from e
    _MESH = DataMesh(rank=dist.get_rank(), world_size=world, device=dev, backend=backend,
                     global_rank=dist.get_rank())
    return _MESH


def current_mesh() -> Optional[DataMesh]:
    """The group :func:`maybe_init_distributed` joined, or None."""
    return _MESH


def destroy_distributed() -> None:
    """Leave the group (a no-op without one)."""
    global _MESH
    if _MESH is not None:
        dist.destroy_process_group()
        _MESH = None


def process_index_count() -> tuple[int, int]:
    """(data index, data count) for the loaders' ``process_index`` /
    ``process_count``: (0, 1) without a group. The ranks of one model group
    share a data index, so they read the same rows."""
    return (0, 1) if _MESH is None else (_MESH.rank, _MESH.world_size)


def process_rank() -> int:
    """This process's rank in the default group (0 without a group): the
    index that logs and scalar writers key on."""
    return 0 if _MESH is None else _MESH.global_rank


def is_main_process() -> bool:
    """Global rank 0 (or no group): the process that writes logs,
    checkpoints and reports."""
    return process_rank() == 0


def mesh_from_config(cfg) -> Optional[DataMesh]:
    """The mesh of a run, as JAX's ``mesh_from_config``: the 1-D data mesh
    (the group, or None without one), or for ``tp`` / ``cp`` > 1 the 2-D
    ``(data, model)`` mesh of ``mp = max(tp, cp)`` (:func:`init_model_axis`).
    ``tp`` and ``cp`` share the model axis, so when both exceed 1 they must
    agree; ``mp`` must divide the world size (1 without a group, which JAX
    refuses as it refuses 2 on one device). A second call returns the mesh
    of the first."""
    tp = int(cfg.get("tp", 1) or 1)
    cp = int(cfg.get("cp", 1) or 1)
    if tp > 1 and cp > 1 and tp != cp:
        raise ValueError(f"tp={tp} and cp={cp} share the mesh's model axis; set them equal")
    mp = max(tp, cp)
    if mp <= 1:
        return _MESH
    n = 1 if _MESH is None else dist.get_world_size()
    if n % mp:
        raise ValueError(f"tp/cp={mp} does not divide the {n} available ranks")
    return init_model_axis(mp)


def init_model_axis(mp: int) -> DataMesh:
    """Form the run's 2-D ``(data, model)`` mesh (:func:`_form_model_axis`)
    and make it the current mesh, JAX's ``with mesh:`` of the run; a second
    call with the same ``mp`` returns it, another ``mp`` raises. Needs a
    group."""
    global _MESH
    if _MESH is None:
        raise ValueError(f"a model axis of {mp} ranks needs a process group; this process has none")
    if _MESH.has_model_axis:
        if _MESH.model_size != mp:
            raise ValueError(f"the mesh already has a model axis of {_MESH.model_size}, not {mp}")
        return _MESH
    _MESH = _form_model_axis(_MESH, mp)
    return _MESH


def _form_model_axis(base: DataMesh, mp: int, axis: str = MODEL_AXIS) -> DataMesh:
    """The 2-D ``(data, axis)`` mesh of the group whose 1-D mesh is ``base``:
    ``world // mp`` data indices by ``mp`` indices on ``axis``, one data
    group per index on ``axis`` and one ``axis`` group per data index (every
    rank creates every group, in the same order, as
    ``torch.distributed.new_group`` requires). ``mp = 1`` makes an axis of
    one rank per group, whose collectives run (and are exact). Returns the
    mesh and leaves the current one as it is."""
    world, rank = dist.get_world_size(), dist.get_rank()
    if mp < 1 or world % mp:
        raise ValueError(f"tp/cp={mp} does not divide the {world} available ranks")
    dp = world // mp
    data_group = None  # the default group when it is the whole data axis
    if mp > 1:
        for m in range(mp):
            g = dist.new_group([d * mp + m for d in range(dp)])
            if rank % mp == m:
                data_group = g
    model_group = None
    for d in range(dp):
        g = dist.new_group([d * mp + m for m in range(mp)])
        if rank // mp == d:
            model_group = g
    return dataclasses.replace(base, rank=rank // mp, world_size=dp, group=data_group, model_rank=rank % mp,
                               model_size=mp, model_group=model_group, global_rank=rank, model_axis=axis)


def create_mesh(mesh_shape: Optional[Sequence[int]] = None, axis_names: Sequence[str] = (DATA_AXIS,),
                devices: Optional[Sequence[str | torch.device]] = None) -> DataMesh:
    """JAX's ``create_mesh``: builds a mesh and returns it; the current mesh
    (the run's) stays as it is. ``(n,)`` named ``data`` is the 1-D data
    mesh; ``(k,)`` under another name (``seq``, ``pipe``, ``expert``) is one
    data index by ``k``; ``(dp, k)`` named ``("data", <name>)`` is the 2-D
    mesh of :func:`_form_model_axis`, rank ``r`` at data index ``r // k`` and
    index ``r % k`` on the named trailing axis, as JAX lays devices out.
    The shape defaults to JAX's ``(n,)``, or ``(n, 1)`` for two names.

    Under a group the mesh spans its ranks (new groups, every call) on the
    group's devices; ``devices``, if given, must count them. In a process
    with no group it is the mesh of one rank on ``devices[0]`` (default
    ``cuda:0``, JAX's first device; pass ``cpu`` for the CPU), whose
    collectives are the identity. Either way a shape that does not cover the
    devices raises JAX's ``ValueError``."""
    names = tuple(axis_names)
    world = 1 if _MESH is None else dist.get_world_size()
    n = world if devices is None else len(devices)
    shape = ((n,) if len(names) == 1 else (n, 1)) if mesh_shape is None else tuple(int(s) for s in mesh_shape)
    if len(shape) != len(names) or len(shape) not in (1, 2) or (len(shape) == 2 and names[0] != DATA_AXIS):
        raise ValueError(f"mesh {shape} over {names}: the port forms (n,) and (data, <axis>) meshes")
    for count in (n, world):  # JAX's check, then one device a rank
        if int(np.prod(shape)) != count:
            raise ValueError(f"mesh shape {shape} does not cover {count} devices")
    axis = MODEL_AXIS if names == (DATA_AXIS,) else names[-1]
    if _MESH is None:
        device = torch.device("cuda", 0) if devices is None else torch.device(devices[0])
        return DataMesh(rank=0, world_size=1, device=device, backend=NO_GROUP, model_axis=axis)
    rank = dist.get_rank()
    base = DataMesh(rank=rank, world_size=world, device=_MESH.device, backend=_MESH.backend, global_rank=rank)
    return base if names == (DATA_AXIS,) else _form_model_axis(base, shape[-1], axis)


def axis_group(mesh: Optional[DataMesh], name: str) -> tuple[int, int, Optional[dist.ProcessGroup]]:
    """(size, this rank's index, group) of the mesh axis ``name``: ``data``
    or the mesh's trailing axis. No mesh, or an axis of one rank: (1, 0,
    None). Another name raises, as JAX's mesh does."""
    if mesh is None:
        return 1, 0, None
    if name == DATA_AXIS:
        if mesh.world_size == 1:
            return 1, 0, None
        return mesh.world_size, mesh.rank, dist.group.WORLD if mesh.group is None else mesh.group
    if name == mesh.model_axis:
        return mesh.model_size, mesh.model_rank, mesh.model_group if mesh.model_size > 1 else None
    raise ValueError(f"the mesh has no axis {name!r}: its axes are {DATA_AXIS!r} and {mesh.model_axis!r}")


def batch_sharding(mesh: Optional[DataMesh] = None, axis: str = DATA_AXIS) -> tuple:
    """JAX's ``batch_sharding`` as the port writes a partition spec (a tuple of
    mesh axes per dim, as ``tp_pspec`` returns): dim 0 over ``axis``; the
    rows it gives a rank are :func:`shard_host_batch`'s."""
    axis_group(mesh, axis)
    return (axis,)


def replicated_sharding(mesh: Optional[DataMesh] = None) -> tuple:
    """JAX's ``replicated_sharding`` as a partition spec: no dim split."""
    return ()


def local_batch_size(global_batch: int, mesh: Optional[DataMesh] = None) -> int:
    """This rank's rows of a global batch."""
    n = 1 if mesh is None else mesh.world_size
    if global_batch % n:
        raise ValueError(f"global batch {global_batch} not divisible by {DATA_AXIS}={n}")
    return global_batch // n


def shard_host_batch(batch: dict, mesh: Optional[DataMesh] = None, leading_stack: bool = False) -> dict:
    """This rank's contiguous block of a global host (numpy) batch, as
    tensors on its device (a per-process loader's batch is the rank's own
    already: ``parallel/train_step.py:batch_to_device`` places it).
    ``leading_stack``: the leaves carry a leading steps-per-call axis ([K, B,
    ...]) and the batch axis is the second. Leaves of fewer dims, and what
    is not an array, stay as they are."""
    n, rank = (1, 0) if mesh is None else (mesh.world_size, mesh.rank)
    target = torch.device("cpu") if mesh is None else mesh.device
    axis = 1 if leading_stack else 0

    def put(x):
        if not isinstance(x, np.ndarray) or x.ndim <= axis:
            return x
        b = x.shape[axis] // n
        x = np.take(x, np.arange(rank * b, (rank + 1) * b), axis=axis) if n > 1 else x
        return torch.from_numpy(np.ascontiguousarray(x)).to(target)

    return {k: put(v) for k, v in batch.items()}


def _resolve(mesh: Optional[DataMesh]) -> Optional[DataMesh]:
    """``mesh``, else the current one; None when that is no mesh or one
    without a group (the collectives below are then the identity)."""
    mesh = mesh or _MESH
    return None if mesh is None or mesh.backend == NO_GROUP else mesh


def _check(t: torch.Tensor, mesh: DataMesh) -> None:
    if t.device.type != mesh.device.type:
        raise RuntimeError(f"a {t.device.type} tensor cannot go through the {mesh.backend} group of "
                           f"{mesh.device}")


def _gather(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    _check(x, mesh)
    x = x.contiguous()
    out = torch.empty((mesh.world_size * x.shape[0], *x.shape[1:]), dtype=x.dtype, device=x.device)
    _all_gather_single(out, x, group=mesh.group)
    return out


class _GatherRows(torch.autograd.Function):
    """All-gather along dim 0; the backward reduce-scatters (sums over ranks)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
        ctx.mesh = mesh
        return _gather(x, mesh)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh = ctx.mesh
        grad = grad.contiguous()
        out = torch.empty((grad.shape[0] // mesh.world_size, *grad.shape[1:]), dtype=grad.dtype,
                          device=grad.device)
        _reduce_scatter_single(out, grad, op=dist.ReduceOp.SUM, group=mesh.group)
        return out, None


def gather_rows(x: torch.Tensor, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """The global batch of ``x``: every rank's rows along dim 0, in rank
    order. Carries gradients (summed over ranks in the backward) when ``x``
    needs them. The identity without a group."""
    mesh = _resolve(mesh)
    if mesh is None:
        return x
    if x.requires_grad and torch.is_grad_enabled():
        return _GatherRows.apply(x, mesh)
    return _gather(x, mesh)


def all_reduce_sum(x: torch.Tensor, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """The sum of ``x`` over ranks, as a new tensor without gradient (counts
    and metrics). The identity without a group."""
    mesh = _resolve(mesh)
    if mesh is None:
        return x
    _check(x, mesh)
    out = x.detach().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.group)
    return out


def world_size(mesh: Optional[DataMesh] = None) -> int:
    mesh = mesh or _MESH
    return 1 if mesh is None else mesh.world_size


def rank_slice(global_rows: torch.Tensor, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """This rank's block of rows of a global-batch tensor."""
    mesh = mesh or _MESH
    if mesh is None:
        return global_rows
    b = global_rows.shape[0] // mesh.world_size
    return global_rows[mesh.rank * b:(mesh.rank + 1) * b]


@torch.no_grad()
def all_reduce_mean_(tensors: Sequence[torch.Tensor], mesh: Optional[DataMesh] = None) -> None:
    """Average ``tensors`` over ranks in place, one collective per dtype over
    a flat copy (the gradient all-reduce of the train step). NCCL averages
    with ``AVG`` (at one rank it still launches its reduce kernel, exactly x
    * 1); gloo has no ``AVG`` and sums, then divides. A no-op without a
    group."""
    mesh = _resolve(mesh)
    if mesh is None or not tensors:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        for t in group:
            _check(t, mesh)
        flat = torch.cat([t.reshape(-1) for t in group])
        if mesh.backend == "nccl":
            dist.all_reduce(flat, op=dist.ReduceOp.AVG, group=mesh.group)
        else:
            dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.group)
            flat.div_(mesh.world_size)
        for t, chunk in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(chunk.view_as(t))


@torch.no_grad()
def all_gather_shards_(pieces: Sequence[tuple[torch.Tensor, int]], mesh: Optional[DataMesh] = None) -> None:
    """Rebuild sharded tensors in place: each ``(full, dim)`` holds this rank's
    block of ``full`` along ``dim`` (block r of ``world_size`` equal blocks);
    one all-gather per dtype fills every rank's block (ZeRO-2's parameter
    all-gather after the sharded update)."""
    mesh = _resolve(mesh)
    if mesh is None or not pieces:
        return
    n, rank = mesh.world_size, mesh.rank
    by_dtype: dict[torch.dtype, list[tuple[torch.Tensor, int]]] = {}
    for full, dim in pieces:
        by_dtype.setdefault(full.dtype, []).append((full, dim))
    for group in by_dtype.values():
        blocks = [_blocks(full, dim, n) for full, dim in group]
        local = torch.cat([b[rank].reshape(-1) for b in blocks])
        _check(local, mesh)
        out = torch.empty((n, local.numel()), dtype=local.dtype, device=local.device)
        _all_gather_single(out.view(-1), local, group=mesh.group)
        offset = 0
        for b in blocks:
            size = b[rank].numel()
            b.copy_(out[:, offset:offset + size].reshape(b.shape))
            offset += size


def _blocks(full: torch.Tensor, dim: int, n: int) -> torch.Tensor:
    """``full`` viewed as [n, ...] blocks along ``dim`` (a view)."""
    return full.unflatten(dim, (n, full.shape[dim] // n)).movedim(dim, 0)


def gather_shards(shard: torch.Tensor, dim: int, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """The full tensor of equal per-rank blocks ``shard`` along ``dim``, as a
    new tensor on every rank (the optimizer's ``state_dict``)."""
    mesh = _resolve(mesh)
    if mesh is None:
        return shard
    out = _gather(shard.movedim(dim, 0), mesh)  # [n * block, ...] along dim 0
    return out.movedim(0, dim).contiguous()


def host_rows(x, mesh: Optional[DataMesh] = None) -> np.ndarray:
    """A host array of this rank's rows -> every rank's rows in rank order
    (the eval gather of features, predictions and ids; JAX's ``_host_rows``
    for metadata). Numeric arrays go through the group's device; others
    (strings) through ``all_gather_object``."""
    mesh = _resolve(mesh)
    x = np.asarray(x)
    if mesh is None:
        return x
    if x.dtype.kind in "biuf":
        t = torch.from_numpy(np.ascontiguousarray(x)).to(mesh.device)
        return _gather(t, mesh).cpu().numpy()
    rows: list = [None] * mesh.world_size
    dist.all_gather_object(rows, x, group=mesh.group)
    return np.concatenate(rows)


# -- the model axis ----------------------------------------------------------------


def _model_axis(mesh: Optional[DataMesh]) -> Optional[DataMesh]:
    mesh = mesh or _MESH
    return mesh if mesh is not None and mesh.has_model_axis else None


@torch.no_grad()
def all_reduce_model_sum_(tensors: Sequence[torch.Tensor], mesh: Optional[DataMesh] = None) -> None:
    """Sum ``tensors`` over the model group in place, one collective per
    dtype over a flat copy (the gradients that are partial sums over the
    model axis). A no-op without a model axis."""
    mesh = _model_axis(mesh)
    if mesh is None or not tensors:
        return
    by_dtype: dict[torch.dtype, list[torch.Tensor]] = {}
    for t in tensors:
        _check(t, mesh)
        by_dtype.setdefault(t.dtype, []).append(t)
    for group in by_dtype.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        dist.all_reduce(flat, op=dist.ReduceOp.SUM, group=mesh.model_group)
        for t, chunk in zip(group, flat.split([t.numel() for t in group])):
            t.copy_(chunk.view_as(t))


def _model_sum(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    _check(x, mesh)
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.SUM, group=mesh.model_group)
    return out


def _model_stack(x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
    """[model_size, *x.shape]: every model rank's ``x``, in model order."""
    _check(x, mesh)
    x = x.contiguous()
    out = torch.empty((mesh.model_size, *x.shape), dtype=x.dtype, device=x.device)
    _all_gather_single(out.view(-1), x.view(-1), group=mesh.model_group)
    return out


def _model_cat(x: torch.Tensor, dim: int, mesh: DataMesh) -> torch.Tensor:
    return torch.cat(_model_stack(x, mesh).unbind(0), dim=dim)


def _model_block(x: torch.Tensor, dim: int, mesh: DataMesh) -> torch.Tensor:
    return _blocks(x, dim, mesh.model_size)[mesh.model_rank]


class _CopyToModel(torch.autograd.Function):
    """Identity; the backward sums the gradient over the model group."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _model_sum(grad, ctx.mesh), None


class _ReduceFromModel(torch.autograd.Function):
    """The sum over the model group; the backward is the identity."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, mesh: DataMesh) -> torch.Tensor:
        return _model_sum(x, mesh)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


class _GatherModel(torch.autograd.Function):
    """All-gather along ``dim`` over the model group. The backward either sums
    the gradient over the group and keeps this rank's block (``reduce``: the
    ranks' downstream work is split between them) or keeps this rank's block
    alone (the ranks' downstream work is the same on every rank)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, reduce: bool, mesh: DataMesh) -> torch.Tensor:
        ctx.dim, ctx.reduce, ctx.mesh = dim, reduce, mesh
        return _model_cat(x, dim, mesh)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        mesh, dim = ctx.mesh, ctx.dim
        if not ctx.reduce:
            return _model_block(grad, dim, mesh).contiguous(), None, None, None
        moved = grad.movedim(dim, 0).contiguous()
        out = torch.empty((moved.shape[0] // mesh.model_size, *moved.shape[1:]), dtype=grad.dtype,
                          device=grad.device)
        _reduce_scatter_single(out, moved, op=dist.ReduceOp.SUM, group=mesh.model_group)
        return out.movedim(0, dim), None, None, None


def _grad(x: torch.Tensor) -> bool:
    return x.requires_grad and torch.is_grad_enabled()


def copy_to_model(x: torch.Tensor, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """A replicated activation entering model-sharded work (Megatron's ``f``):
    the identity, whose backward sums the gradient over the model group."""
    mesh = _model_axis(mesh)
    if mesh is None or not _grad(x):
        return x
    return _CopyToModel.apply(x, mesh)


def reduce_from_model(x: torch.Tensor, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """Partial sums of the model ranks -> their sum on every rank
    (Megatron's ``g``); the backward is the identity."""
    mesh = _model_axis(mesh)
    if mesh is None:
        return x
    return _ReduceFromModel.apply(x, mesh) if _grad(x) else _model_sum(x, mesh)


def gather_model(x: torch.Tensor, dim: int, reduce: bool, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """Every model rank's block of ``x`` along ``dim``, in model order (see
    :class:`_GatherModel` for ``reduce``)."""
    mesh = _model_axis(mesh)
    if mesh is None:
        return x
    return _GatherModel.apply(x, dim, reduce, mesh) if _grad(x) else _model_cat(x, dim, mesh)


def model_block(x: torch.Tensor, dim: int, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """This model rank's block of ``x`` along ``dim`` (a view; the backward
    puts the gradient in the block and zeros elsewhere)."""
    mesh = _model_axis(mesh)
    return x if mesh is None else _model_block(x, dim, mesh)


# -- the layouts of a leaf ---------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class LeafLayout:
    """How one parameter and its optimizer state are split over the mesh.

    ``full_shape`` is the parameter's shape in the reference layout.
    ``tp_dim`` is the dim split over the model axis, in ``tp_parts`` fused
    parts (a fused qkv projection has 3: each rank holds its heads' rows of
    q, of k and of v, in that order); ``dp_dim`` is the dim of the model
    block split over the data axis (ZeRO-3). ``model_partial``: the
    gradient of each model rank is a partial sum, to be summed over the
    model group (a replicated parameter that each rank uses for its share of
    the work)."""

    full_shape: tuple
    tp_dim: Optional[int] = None
    tp_parts: int = 1
    dp_dim: Optional[int] = None
    model_partial: bool = False

    @property
    def sharded(self) -> bool:
        return self.tp_dim is not None or self.dp_dim is not None


def local_leaf(full: torch.Tensor, layout: LeafLayout, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """This rank's block of a leaf in the reference layout (a view)."""
    mesh = mesh or _MESH
    x = full
    if layout.tp_dim is not None:
        d, parts = layout.tp_dim, layout.tp_parts
        x = x.unflatten(d, (parts, mesh.model_size, -1)).select(d + 1, mesh.model_rank).flatten(d, d + 1)
    if layout.dp_dim is not None:
        x = _blocks(x, layout.dp_dim, mesh.world_size)[mesh.rank]
    return x


@torch.no_grad()
def full_leaf(local: torch.Tensor, layout: LeafLayout, mesh: Optional[DataMesh] = None) -> torch.Tensor:
    """The leaf in the reference layout from every rank's block, as a new
    tensor on every rank (a collective over the data and the model groups)."""
    mesh = mesh or _MESH
    x = local
    if layout.dp_dim is not None:
        x = gather_shards(x, layout.dp_dim, mesh)
    if layout.tp_dim is not None:
        d, parts = layout.tp_dim, layout.tp_parts
        y = _model_stack(x, mesh).movedim(0, d)  # [..., mp, parts * block, ...]
        y = y.unflatten(d + 1, (parts, -1)).transpose(d, d + 1)  # [..., parts, mp, block, ...]
        x = y.flatten(d, d + 2).contiguous()
    return x
