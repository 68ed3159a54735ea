"""Grouped AdamW with the JAX package's update rule
(``xpretrain_tpu/optim/optimizer.py``, ref ``CLIP-ViP/src/optimization/utils.py:96-154``).

Parameters are labelled ``frozen`` or {``top_``, ``base_``} x {``decay``,
``no_decay``} by their path in the flax params tree (for CLIP-ViP,
``models/clip_vip/convert.py:flax_param_paths``), so the pattern rules hit the
same leaves as in JAX. :class:`GroupedAdamW` is ``fused_grouped_adamw``, and
``grad_accum_steps > 1`` wraps it the way ``optax.MultiSteps`` does:

- the lr is ``schedule(count)`` evaluated before the increment, so a
  warmup's first step has lr = 1e-8 (the floor);
- clipping is by the global norm over all gradients, frozen ones included,
  as ``(g / gnorm) * max_norm`` and only when ``gnorm >= max_norm``;
- decoupled decay: ``u = m_hat / (sqrt(v_hat) + eps) + wd * p``, step
  ``-lr * mul * u``; frozen parameters never move;
- accumulation keeps the running mean of the k gradients (Welford, as
  ``MultiSteps``) and updates on every k-th call.

The update runs in place on the parameters. On a card every trained leaf
takes one hand-written multi-tensor kernel (``optim/adamw_kernel.py``,
``csrc/adamw_multi_tensor.cu``): the clip, both moments, the bias
corrections, the decay and the parameter add in one read and one write per
element, every group in one launch, with the bits of the ``torch._foreach_*``
chain that the CPU runs, a few launches per group. The counters
``xpt.adamw.kernel`` and ``xpt.adamw.plain`` count the leaves that took each
path.

A step splits into a host part and a device part, so that the device part
can be captured in a CUDA graph and replayed: :meth:`GroupedAdamW.prepare`
evaluates the schedule and Adam's bias corrections for the next call on the
host and writes them into 0-d fp32 tensors beside the parameters;
:meth:`GroupedAdamW.apply` reads them there and touches no host state;
:meth:`GroupedAdamW.advance` moves the host counters. :meth:`step` is the
three in turn. The eager and the graphed steps read the same tensors, so
they run the same arithmetic.

``param_dtype`` bf16 (:func:`cast_params_for_storage` and
:func:`master_weights`, JAX ``optim/optimizer.py:170-271``) stores the
parameters of two or more dims in bf16 and keeps their fp32 masters in the
optimizer: the update runs on the masters, in fp32, from upcast gradients,
and lands each stored parameter on ``bf16(master)`` exactly.

ZeRO-2 (:func:`zero2_shard`, JAX's ``zero2_state_shardings``): in a
data-parallel group of N ranks, each trained leaf of at least ``min_size``
elements keeps only its rank's block of ``mu``, ``nu`` and (with masters)
its fp32 master, along the leaf's first dimension divisible by N. Each rank
updates its block from the averaged gradient, and one all-gather per dtype
rebuilds the parameters. ``state_dict`` gathers the full state and
``load_state_dict`` takes this rank's block of it, so a checkpoint written
at N ranks resumes at any other count.

The model-axis layouts (``parallel/fsdp.py:apply_layouts``: ``--tp``,
``--cp``, ``--zero3``) reach the optimizer as one ``LeafLayout`` per
parameter (:meth:`GroupedAdamW.set_layouts`). A TP- or ZeRO-3-sharded
parameter is its block, so its moments and master are blocks too and the
update runs on them unchanged; ZeRO-2 leaves such leaves alone.
:meth:`GroupedAdamW.reduce_gradients` averages the gradients over the data
group (a ZeRO-3 block's gradient arrives averaged from its gather's
backward) and sums the model-partial ones over the model group;
:meth:`GroupedAdamW.grad_norm` counts every element once: a sharded leaf's
squares are summed over the groups that hold its blocks, a replicated leaf
is not multiplied by the number of its copies. ``state_dict`` gathers every
leaf to the reference layout and ``load_state_dict`` takes this rank's
block, so a file written under one layout resumes under any other.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional, Sequence

import numpy as np
import torch

import torch.distributed as dist

from xpretrain_tpu_torch.optim import adamw_kernel
from xpretrain_tpu_torch.parallel.mesh import (
    DataMesh,
    LeafLayout,
    _blocks,
    all_gather_shards_,
    all_reduce_mean_,
    all_reduce_model_sum_,
    current_mesh,
    full_leaf,
    gather_shards,
    local_leaf,
)
from xpretrain_tpu_torch.utils.profiling import count

NO_DECAY_DEFAULT = ("bias", "layer_norm", "layernorm", "_norm", "norm_", "logit_scale")
# LF-VILA also exempts position embeddings and the relative-position-bias
# tables (ref ``LF-VILA/src/optimization/optimizer.py:6-31``)
NO_DECAY_LFVILA = NO_DECAY_DEFAULT + ("pos_embed", "position_embedding", "relative_position_bias")

LOGIT_SCALE_MAX = 5.2983  # ln(200), ref run_pretrain.py:335-340


def _is_no_decay(path_s: str, ndim: int, patterns: Sequence[str]) -> bool:
    # 1-D (and 0-D) leaves are biases, norm scales and embedding-like vectors
    return ndim <= 1 or any(p in path_s for p in patterns)


def param_group_labels(
    named_params: Mapping[str, torch.Tensor],
    lr_mul_prefix: str = "",
    no_decay_patterns: Sequence[str] = NO_DECAY_DEFAULT,
    frozen_patterns: Sequence[str] = (),
    paths: Optional[Mapping[str, str]] = None,
) -> dict[str, str]:
    """Label per parameter name: ``frozen`` or {top_,base_} x {decay,no_decay}.

    ``paths`` maps a parameter name to its "/"-joined flax path, where the
    patterns are matched (lower case); without it the dotted name is used."""
    labels = {}
    for name, p in named_params.items():
        path_s = (paths[name] if paths is not None else name.replace(".", "/")).lower()
        if any(pat.lower() in path_s for pat in frozen_patterns):
            labels[name] = "frozen"
            continue
        top = bool(lr_mul_prefix) and lr_mul_prefix.lower() in path_s
        nd = _is_no_decay(path_s, p.dim(), no_decay_patterns)
        labels[name] = ("top_" if top else "base_") + ("no_decay" if nd else "decay")
    return labels


def _leaf_norms(tensors: Sequence[torch.Tensor]) -> list[torch.Tensor]:
    """Each tensor's norm: fp64 on the CPU, fp32 elsewhere (:func:`global_norm`)."""
    if tensors and tensors[0].device.type == "cpu":
        return list(torch._foreach_norm([t.double() for t in tensors]))
    return list(torch._foreach_norm([t.float() for t in tensors]))


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt of the sum of squares over every element (``optax.global_norm``),
    fp32.

    On the CPU the per-tensor norms accumulate in fp64: torch's fp32 CPU norm
    of a 31 M-element tensor (BERT-large's word embeddings) lands 1.7e-3 off,
    where XLA's reduction (and the CUDA one) stays within 1e-6."""
    return torch.linalg.vector_norm(torch.stack(_leaf_norms(tensors))).float()


class GroupedAdamW:
    """``fused_grouped_adamw`` (+ ``MultiSteps`` when ``grad_accum_steps > 1``)
    over named torch parameters, updated in place by :meth:`step`."""

    def __init__(
        self,
        named_params: Mapping[str, torch.Tensor],
        labels: Mapping[str, str],
        schedule: Callable[[int], float],
        weight_decay: float,
        betas: tuple[float, float],
        eps: float,
        lr_mul: float,
        max_grad_norm: Optional[float],
        moment_dtype: Optional[torch.dtype] = None,
        grad_accum_steps: int = 1,
        group_schedules: Optional[Mapping[str, Callable[[int], float]]] = None,
    ):
        self.names = list(named_params)
        self.params = [named_params[n] for n in self.names]
        self.labels = [labels[n] for n in self.names]
        self.schedule = schedule
        self.b1, self.b2 = betas
        self.eps = eps
        self.max_grad_norm = max_grad_norm if max_grad_norm and max_grad_norm > 0 else None
        self.hyper = adamw_kernel.hyper(self.b1, self.b2, eps, self.max_grad_norm)
        self.moment_dtype = moment_dtype
        self.k = max(1, int(grad_accum_steps))
        self.count = 0  # inner Adam steps taken
        self.mini_step = 0  # gradients accumulated towards the next step
        # what the update writes: the parameter itself, or its fp32 master
        # (``master_weights``); ``masters`` lists the indices that have one
        self.targets = list(self.params)
        self.masters: list[int] = []
        # ZeRO-2: index -> (dim, ranks, rank) of the leaves whose state this
        # rank holds one block of (``zero2_shard``)
        self.shards: dict[int, tuple[int, int, int]] = {}
        self.mesh: Optional[DataMesh] = None
        # index -> the parameter's layout over the mesh's model axis and, under
        # ZeRO-3, its data axis (set_layouts)
        self.layouts: dict[int, LeafLayout] = {}
        # the AdamW kernel's leaf table, built at the first update on a card,
        # and the indices of its leaves
        self._table: Optional[adamw_kernel.LeafTable] = None
        self._index: list[int] = []
        self._init_state()
        # (lr multiplier or schedule group, weight decay) -> indices of the
        # parameters that use it, and each group's lr at an update count
        self.groups: dict[tuple, list[int]] = {}
        self.group_lrs: list[Callable[[int], float]] = []
        for i, label in enumerate(self.labels):
            if label == "frozen":
                continue
            wd = weight_decay if label.endswith("_decay") and not label.endswith("no_decay") else 0.0
            if group_schedules is not None:  # "<group>_decay" / "<group>_no_decay"
                tag = label.rsplit("_no_decay", 1)[0] if label.endswith("_no_decay") else label.rsplit("_decay", 1)[0]
                lr = group_schedules[tag]
            else:
                tag = lr_mul if label.startswith("top_") else 1.0
                lr = (lambda mul: lambda count: self.schedule(count) * mul)(tag)
            if (tag, wd) not in self.groups:
                self.group_lrs.append(lr)
            self.groups.setdefault((tag, wd), []).append(i)
        # what the next update reads, filled by prepare(): Adam's bias
        # corrections c1 and c2, then -lr * mul for each group
        device = self.params[0].device if self.params else torch.device("cpu")
        self.scalars = torch.zeros(2 + len(self.groups), dtype=torch.float32, device=device)

    def _init_state(self) -> None:
        """Zero moments (and accumulators) shaped and typed as the targets."""

        def moment(p: torch.Tensor, label: str) -> torch.Tensor:
            dt = self.moment_dtype or p.dtype
            # frozen leaves carry scalar placeholder moments, as in JAX
            if label == "frozen":
                return torch.zeros((), dtype=dt, device=p.device)
            return torch.zeros_like(p, dtype=dt, memory_format=torch.contiguous_format)

        self._table = None
        with torch.no_grad():
            self.mu = [moment(p, lb) for p, lb in zip(self.targets, self.labels)]
            self.nu = [moment(p, lb) for p, lb in zip(self.targets, self.labels)]
            self.acc = [torch.zeros_like(p) for p in self.targets] if self.k > 1 else []

    def set_layouts(self, layouts: Mapping[str, LeafLayout]) -> None:
        """Take the parameters' layouts by name (``parallel/fsdp.py:
        apply_layouts``); call it before :func:`zero2_shard`."""
        if self.shards:
            raise ValueError("layouts are set before zero2_shard")
        self.layouts = {i: layouts[n] for i, n in enumerate(self.names) if n in layouts}

    def reduce_gradients(self, grads: Sequence[torch.Tensor]) -> None:
        """Average ``grads`` over the data group in place, except ZeRO-3
        blocks (averaged by their gathers' backward), and sum the
        model-partial ones over the model group."""
        dp_sharded = {i for i, lay in self.layouts.items() if lay.dp_dim is not None}
        all_reduce_mean_([g for i, g in enumerate(grads) if i not in dp_sharded])
        all_reduce_model_sum_([grads[i] for i, lay in self.layouts.items() if lay.model_partial])

    def grad_norm(self, grads: Sequence[torch.Tensor]) -> torch.Tensor:
        """:func:`global_norm` of the global gradients whose blocks ``grads``
        holds: a sharded leaf's squares are summed over the data group (ZeRO-3)
        and the model group (TP) before they count; a replicated leaf counts
        once."""
        norms = _leaf_norms(grads)
        mesh = current_mesh()
        if mesh is not None:
            classes: dict[tuple[bool, bool], list[int]] = {}
            for i, lay in self.layouts.items():
                over_data = lay.dp_dim is not None and mesh.world_size > 1
                over_model = lay.tp_dim is not None and mesh.model_size > 1
                if over_data or over_model:
                    classes.setdefault((over_data, over_model), []).append(i)
            for (over_data, over_model), idx in classes.items():
                squares = torch.stack([norms[i] for i in idx]).square()
                if over_data:
                    dist.all_reduce(squares, op=dist.ReduceOp.SUM, group=mesh.group)
                if over_model:
                    dist.all_reduce(squares, op=dist.ReduceOp.SUM, group=mesh.model_group)
                for i, sq in zip(idx, squares.sqrt().unbind(0)):
                    norms[i] = sq
        return torch.linalg.vector_norm(torch.stack(norms)).float()

    def _block(self, t: torch.Tensor, i: int) -> torch.Tensor:
        """This rank's block of a full-shaped tensor of leaf ``i`` (a view;
        ``t`` itself when the leaf is not sharded)."""
        if i not in self.shards:
            return t
        dim, n, rank = self.shards[i]
        return _blocks(t, dim, n)[rank]

    def _target(self, i: int) -> torch.Tensor:
        """What the update of leaf ``i`` writes: its master (a block under
        ZeRO-2), else the parameter or this rank's block of it."""
        if i in self.masters:
            return self.targets[i]
        return self._block(self.params[i], i)

    @torch.no_grad()
    def sync_masters(self) -> None:
        """Set each master to its stored parameter (after weights were loaded
        into the stored copies)."""
        for i in self.masters:
            self.targets[i].copy_(self._block(self.params[i], i))

    @torch.no_grad()
    def _store(self) -> None:
        """Land every trained parameter that has a master on ``bf16(master)``,
        then rebuild the sharded parameters from every rank's block."""
        idx = [i for i in self.masters if self.labels[i] != "frozen"]
        if idx:
            torch._foreach_copy_([self._block(self.params[i], i) for i in idx], [self.targets[i] for i in idx])
        if self.shards:
            all_gather_shards_([(self.params[i], self.shards[i][0]) for i in self.shards], self.mesh)

    @torch.no_grad()
    def step(self, grads: Sequence[torch.Tensor], grad_norm: Optional[torch.Tensor] = None) -> None:
        """Take one gradient (one per parameter, in order); under
        accumulation, update the parameters on every k-th call only.

        ``grad_norm`` is :func:`global_norm` of ``grads`` when the caller
        already has it; clipping reuses it when ``grads`` are what is applied
        (no accumulation)."""
        self.prepare()
        self.apply(grads, grad_norm)
        self.advance()

    def _updates_now(self) -> bool:
        """Whether the next call updates the parameters (its k-th gradient)."""
        return self.mini_step + 1 == self.k

    @torch.no_grad()
    def prepare(self) -> None:
        """The host part of the next call: when it updates, evaluate the lr
        (before the increment, as optax) and the fp32 bias corrections, and
        copy them into :attr:`scalars` (from pinned memory, without waiting,
        on a card)."""
        if not self._updates_now():
            return
        count = self.count + 1
        # bias corrections in fp32, as JAX computes them
        c1 = float(1 - np.float32(self.b1) ** np.float32(count))
        c2 = float(1 - np.float32(self.b2) ** np.float32(count))
        values = torch.tensor([c1, c2] + [-float(lr(self.count)) for lr in self.group_lrs], dtype=torch.float32)
        cuda = self.scalars.is_cuda
        self.scalars.copy_(values.pin_memory() if cuda else values, non_blocking=cuda)

    def advance(self) -> None:
        """Move the host counters past the call that :meth:`prepare` set up."""
        if self._updates_now():
            self.count += 1
            self.mini_step = 0
        else:
            self.mini_step += 1

    @torch.no_grad()
    def apply(self, grads: Sequence[torch.Tensor], grad_norm: Optional[torch.Tensor] = None) -> None:
        """The device part of the call: accumulate ``grads`` and, on the
        k-th, update. Reads the host counters and writes none, so that a
        CUDA graph can hold it; the micro-step index is part of what it
        runs, so accumulation takes one graph per index."""
        grads = self.upcast(grads)
        if self.k == 1:
            self._update(grads, grad_norm)
            return
        n = self.mini_step
        # acc + (g - acc) / (n + 1), as MultiSteps' running mean
        diff = torch._foreach_sub(grads, self.acc)
        torch._foreach_div_(diff, float(n + 1))
        torch._foreach_add_(self.acc, diff)
        if n + 1 < self.k:
            return
        grads = [a.clone() for a in self.acc]
        for a in self.acc:
            a.zero_()
        self._update(grads, None)

    def upcast(self, grads: Sequence[torch.Tensor]) -> list[torch.Tensor]:
        """``grads`` in the dtype of what the update writes: a bf16 gradient
        of a parameter with a master comes back fp32 (a no-op otherwise). A
        step that upcasts before its gradient norm saves :meth:`apply` a
        second pass."""
        return [g if g.dtype == t.dtype else g.to(t.dtype) for g, t in zip(grads, self.targets)]

    def _update(self, grads: list[torch.Tensor], gnorm: Optional[torch.Tensor]) -> None:
        if self.max_grad_norm is not None and gnorm is None:
            gnorm = self.grad_norm(grads)
        if self.scalars.is_cuda:
            self._update_kernel(grads, gnorm)
        else:
            self._update_plain(grads, gnorm)
        self._store()

    def _update_kernel(self, grads: list[torch.Tensor], gnorm: Optional[torch.Tensor]) -> None:
        """The update on a card: every trained leaf through the multi-tensor
        kernel, with the leaf table built at the first call."""
        if self._table is None:
            # group by group, in the order of the _foreach chain
            self._index = [i for idx in self.groups.values() for i in idx]
            group_of = {i: (2 + group, wd) for group, ((_, wd), idx) in enumerate(self.groups.items()) for i in idx}
            self._table = adamw_kernel.LeafTable(
                [self._target(i) for i in self._index], [self.mu[i] for i in self._index],
                [self.nu[i] for i in self._index], [group_of[i][0] for i in self._index],
                [group_of[i][1] for i in self._index], self.scalars.device)
        count("xpt.adamw.kernel", len(self._table))
        index = self._index
        block = [self._block(grads[i], i) for i in index] if self.shards else [grads[i] for i in index]
        adamw_kernel.adamw_multi_tensor(self._table, block, self.scalars, gnorm, self.hyper)

    def _update_plain(self, grads: list[torch.Tensor], gnorm: Optional[torch.Tensor]) -> None:
        """The update as ``torch._foreach_*`` ops, a few per group: the CPU's
        path and the kernel's reference (``adamw_kernel.adamw_update_plain``
        computes it leaf by leaf)."""
        count("xpt.adamw.plain", sum(len(idx) for idx in self.groups.values()))
        if self.max_grad_norm is not None:
            keep = gnorm < self.max_grad_norm
            # (g / gnorm) * max_norm when clipping, g / 1 * 1 (exact) when not;
            # 0-d device tensors, so no host sync
            one = torch.ones_like(gnorm)
            grads = torch._foreach_div(grads, torch.where(keep, one, gnorm))
            torch._foreach_mul_(grads, torch.where(keep, one, torch.full_like(gnorm, self.max_grad_norm)))
        c1, c2 = self.scalars[0], self.scalars[1]
        for group, ((_, wd), idx) in enumerate(self.groups.items()):
            p = [self._target(i) for i in idx]
            g = [self._block(grads[i], i) for i in idx]
            if self.moment_dtype is not None:  # stored reduced, accumulated in fp32
                g = [t.float() for t in g]
                m = [self.mu[i].float() for i in idx]
                v = [self.nu[i].float() for i in idx]
            else:
                m = [self.mu[i] for i in idx]
                v = [self.nu[i] for i in idx]
            torch._foreach_mul_(m, self.b1)
            torch._foreach_add_(m, torch._foreach_mul(g, 1 - self.b1))
            torch._foreach_mul_(v, self.b2)
            torch._foreach_add_(v, torch._foreach_mul(torch._foreach_mul(g, g), 1 - self.b2))
            denom = torch._foreach_div(v, c2)
            torch._foreach_sqrt_(denom)
            torch._foreach_add_(denom, self.eps)
            u = torch._foreach_div(m, c1)
            torch._foreach_div_(u, denom)
            if wd:
                torch._foreach_add_(u, torch._foreach_mul([t.float() for t in p], wd))
            torch._foreach_mul_(u, self.scalars[2 + group])
            if self.moment_dtype is not None:
                for j, i in enumerate(idx):
                    self.mu[i].copy_(m[j])
                    self.nu[i].copy_(v[j])
                u = [t.to(q.dtype) for t, q in zip(u, p)]
            torch._foreach_add_(p, u)

    def _full(self, t: torch.Tensor, i: int, zero2: bool = True) -> torch.Tensor:
        """The full tensor of leaf ``i``'s state ``t``, in the reference
        layout (gathered under ZeRO-2 and the model-axis layouts; a frozen
        leaf's 0-d placeholder as it is)."""
        layout = self.layouts.get(i)
        if layout is not None and layout.sharded and t.dim() > 0:
            return full_leaf(t, layout)
        if i not in self.shards or not zero2:
            return t
        return gather_shards(t, self.shards[i][0], self.mesh)

    def state_dict(self) -> dict:
        """Counters, moments, accumulators and, with ``master_weights``, the
        fp32 masters by parameter name (JAX's ``MasterWeightsState.master``;
        the leaves that are their own master have none). Under ZeRO-2 the
        sharded state is gathered, so every rank calls this (a collective)
        and gets the full state."""
        state = {
            "count": self.count,
            "mini_step": self.mini_step,
            "mu": {n: self._full(t, i) for i, (n, t) in enumerate(zip(self.names, self.mu))},
            "nu": {n: self._full(t, i) for i, (n, t) in enumerate(zip(self.names, self.nu))},
            "acc": {n: self._full(t, i, zero2=False) for i, (n, t) in enumerate(zip(self.names, self.acc))},
        }
        if self.masters:
            state["master"] = {self.names[i]: self._full(self.targets[i], i) for i in self.masters}
        return state

    def load_state_dict(self, state: Mapping) -> None:
        """Restore :meth:`state_dict`'s output (full tensors; under ZeRO-2
        this rank keeps its block of each); with masters, the stored
        parameters are set to ``bf16(master)``, so a run resumes from its
        masters."""
        if bool(self.masters) != ("master" in state):
            raise KeyError("optimizer state: the checkpoint and this run disagree on master weights "
                           "(param_dtype)")
        self.count = int(state["count"])
        self.mini_step = int(state["mini_step"])
        with torch.no_grad():
            everyone = range(len(self.names))
            for key, tensors, index in (("mu", self.mu, everyone), ("nu", self.nu, everyone),
                                        ("acc", self.acc, everyone if self.acc else []),
                                        ("master", [self.targets[i] for i in self.masters], self.masters)):
                if key == "master" and not self.masters:
                    continue
                saved = state[key]
                names = [self.names[i] for i in index]
                if set(saved) != set(names):
                    raise KeyError(f"optimizer state {key!r} does not match the parameters")
                for i, name, t in zip(index, names, tensors):
                    full = saved[name]
                    layout = self.layouts.get(i)
                    if layout is not None and layout.sharded and t.dim() > 0:
                        want, piece = tuple(layout.full_shape), lambda x, lay=layout: local_leaf(x, lay)
                    elif i in self.shards and key != "acc":
                        want, piece = tuple(self.params[i].shape), lambda x, i=i: self._block(x, i)
                    else:
                        want, piece = tuple(t.shape), lambda x: x
                    if tuple(full.shape) != want:
                        raise ValueError(f"optimizer state {key}[{name}]: shape {tuple(full.shape)} != {want}")
                    t.copy_(piece(full.to(t.device)))
            for i in self.masters:
                self._block(self.params[i], i).copy_(self.targets[i])
            if self.shards:
                all_gather_shards_([(self.params[i], self.shards[i][0]) for i in self.shards], self.mesh)


def moment_dtype_from_cfg(cfg: Mapping) -> Optional[torch.dtype]:
    """``moment_dtype`` config key ("fp32"/"bf16") -> None or torch.bfloat16."""
    name = str(cfg.get("moment_dtype", "fp32") or "fp32").lower()
    if name in ("fp32", "float32", "none", ""):
        return None
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"unsupported moment_dtype {name!r} (use fp32 or bf16)")


def param_dtype_from_cfg(cfg: Mapping) -> Optional[torch.dtype]:
    """``param_dtype`` config key ("fp32"/"bf16") -> None (keep fp32) or the
    storage dtype for :func:`cast_params_for_storage`."""
    name = str(cfg.get("param_dtype", "fp32") or "fp32").lower()
    if name in ("fp32", "float32", "none", ""):
        return None
    if name in ("bf16", "bfloat16"):
        return torch.bfloat16
    raise ValueError(f"unsupported param_dtype {name!r} (use fp32 or bf16)")


@torch.no_grad()
def cast_params_for_storage(params, dtype: torch.dtype, min_ndim: int = 2):
    """Store the floating parameters of ``params`` (a module, or a mapping of
    names to tensors) with ``min_ndim`` or more dims in ``dtype``, in place
    (the same tensor objects, so an optimizer built on them keeps them);
    1-D and 0-D leaves (biases, norm scales, ``logit_scale``) stay fp32, as
    in JAX. Returns ``params``."""
    tensors = params.parameters() if isinstance(params, torch.nn.Module) else params.values()
    for p in tensors:
        if p.is_floating_point() and p.dim() >= min_ndim:
            p.data = p.data.to(dtype)
    return params


def master_weights(optimizer: GroupedAdamW, master_dtype: torch.dtype = torch.float32) -> GroupedAdamW:
    """Reduced-precision parameter storage with fp32 masters (JAX
    ``master_weights``): call it after :func:`cast_params_for_storage` and
    before the first step. The optimizer keeps a ``master_dtype`` copy of
    every parameter stored in another dtype, upcasts those gradients, runs
    clipping, the moments and weight decay on the masters, and copies each
    master into its stored parameter after the update, so ``param ==
    master.to(param.dtype)`` holds after every step. Leaves already in
    ``master_dtype`` are their own master."""
    if optimizer.count or optimizer.mini_step:
        raise ValueError("master weights are attached before the first step")
    if optimizer.shards:
        raise ValueError("master weights are attached before zero2_shard, which shards them")
    with torch.no_grad():
        for i, p in enumerate(optimizer.params):
            if p.is_floating_point() and p.dtype != master_dtype:
                optimizer.targets[i] = p.detach().to(master_dtype)
                optimizer.masters.append(i)
        optimizer._init_state()  # the moments in the masters' dtype
    return optimizer


def build_multi_schedule_optimizer(
    named_params: Mapping[str, torch.Tensor],
    groups: Mapping[str, tuple[Sequence[str], Callable[[int], float]]],
    default_schedule: Callable[[int], float],
    weight_decay: float = 0.01,
    betas: tuple[float, float] = (0.9, 0.98),
    eps: float = 1e-6,
    max_grad_norm: Optional[float] = 1.0,
    no_decay_patterns: Sequence[str] = NO_DECAY_DEFAULT,
    paths: Optional[Mapping[str, str]] = None,
) -> tuple[GroupedAdamW, dict[str, str]]:
    """AdamW with independent LR schedules per named param group.

    The HD-VILA pattern of three schedules over transformer/cnn/align groups
    (ref ``hd-vila/src/pretrain/run_pretrain_stage1_group.py:402-437``):
    ``groups`` maps a group name to (path substrings, schedule); params not
    matching any group use ``default_schedule``. Each group still splits
    decay/no-decay. Labels are ``<group>_decay`` / ``<group>_no_decay``,
    matched on the flax ``paths`` as :func:`param_group_labels`."""
    labels = {}
    for name, p in named_params.items():
        path_s = (paths[name] if paths is not None else name.replace(".", "/")).lower()
        group = next((g for g, (patterns, _) in groups.items() if any(pat.lower() in path_s for pat in patterns)),
                     "default")
        labels[name] = group + ("_no_decay" if _is_no_decay(path_s, p.dim(), no_decay_patterns) else "_decay")
    schedules = {**{g: sched for g, (_, sched) in groups.items()}, "default": default_schedule}
    opt = GroupedAdamW(named_params, labels, default_schedule, weight_decay, betas, eps, 1.0, max_grad_norm,
                       group_schedules=schedules)
    return opt, labels


@torch.no_grad()
def zero2_shard(optimizer: GroupedAdamW, mesh: Optional[DataMesh] = None, min_size: int = 16384) -> GroupedAdamW:
    """ZeRO-2 over the data-parallel group (``mesh``, default the current
    one; without a group nothing is sharded): every trained leaf of at least
    ``min_size`` elements keeps only this rank's block of its moments and
    master, along its first dimension the world size divides; smaller or
    indivisible leaves stay whole on every rank. Call it after
    :func:`master_weights` and before the first step."""
    mesh = mesh or current_mesh()
    if mesh is None:
        return optimizer
    if optimizer.count or optimizer.mini_step:
        raise ValueError("zero2_shard runs before the first step")
    optimizer.mesh = mesh
    n, rank = mesh.world_size, mesh.rank
    for i, (p, label) in enumerate(zip(optimizer.params, optimizer.labels)):
        if label == "frozen" or p.numel() < min_size or (i in optimizer.layouts and optimizer.layouts[i].sharded):
            continue
        # JAX's zero2_state_shardings rule: the first dimension the ranks divide
        dim = next((d for d, extent in enumerate(p.shape) if extent % n == 0 and extent >= n), None)
        if dim is None:
            continue
        optimizer.shards[i] = (dim, n, rank)
        optimizer._table = None
        if i in optimizer.masters:
            optimizer.targets[i] = optimizer._block(optimizer.targets[i], i).clone()
        dt = optimizer.moment_dtype or optimizer.targets[i].dtype
        shape = optimizer._block(p, i).shape
        optimizer.mu[i] = torch.zeros(shape, dtype=dt, device=p.device)
        optimizer.nu[i] = torch.zeros(shape, dtype=dt, device=p.device)
    return optimizer


def build_optimizer(
    named_params: Mapping[str, torch.Tensor],
    schedule: Callable[[int], float],
    weight_decay: float = 0.2,
    betas: tuple[float, float] = (0.9, 0.98),
    eps: float = 1e-6,
    lr_mul: float = 1.0,
    lr_mul_prefix: str = "",
    max_grad_norm: Optional[float] = 2.0,
    no_decay_patterns: Sequence[str] = NO_DECAY_DEFAULT,
    grad_accum_steps: int = 1,
    frozen_patterns: Sequence[str] = (),
    fused: bool = True,
    moment_dtype: Optional[torch.dtype] = None,
    paths: Optional[Mapping[str, str]] = None,
) -> tuple[GroupedAdamW, dict[str, str]]:
    """Build the grouped AdamW; returns (optimizer, labels).

    ``fused`` is JAX's ``--fused_adamw``, which there picks between two
    optimizer-state layouts of the same update; the port has one layout,
    ``GroupedAdamW``'s, under both values. As in JAX, reduced-precision
    moments (``moment_dtype``) need ``fused=True``."""
    if moment_dtype is not None and not fused:
        raise ValueError("moment_dtype requires fused=True (--fused_adamw 1)")
    labels = param_group_labels(named_params, lr_mul_prefix, no_decay_patterns, frozen_patterns, paths)
    opt = GroupedAdamW(
        named_params, labels, schedule, weight_decay, betas, eps, lr_mul, max_grad_norm,
        moment_dtype=moment_dtype, grad_accum_steps=grad_accum_steps,
    )
    return opt, labels


@torch.no_grad()
def clamp_logit_scale(named_params: Mapping[str, torch.Tensor], max_value: float = LOGIT_SCALE_MAX) -> None:
    """Clamp every ``logit_scale`` to [0, max_value] in place (ref
    ``run_pretrain.py:335-340``: ``torch.clamp_(logit_scale, 0, np.log(200))``)."""
    for name, p in named_params.items():
        if "logit_scale" in name.lower():
            p.clamp_(0.0, max_value)
