"""GPipe pipeline parallelism over a ``pipe`` axis of the mesh
(``xpretrain_tpu/parallel/pipeline.py``).

A uniform layer stack (the BERT towers' post-LN layers) has its per-layer
parameters stacked on a leading L axis (:func:`stack_layer_params`, on the
port's flat state dicts: ``layer_{i}.<name>`` -> ``<name>`` [L, ...]), and
stage ``i`` of ``P`` holds layers ``[i·L/P, (i+1)·L/P)``
(:func:`pipeline_param_shardings` gives a stage its slice). The batch is cut
into M microbatches; at tick ``t`` every stage that holds a microbatch
applies its layers to it and hands its activation, with the microbatch's
mask beside it, to the next stage (``parallel/p2p.py:shift``, JAX's
``lax.ppermute``). Stage 0 injects microbatch ``t`` at tick ``t``; the last
stage emits microbatch ``t - (P - 1)``; ``M + P - 1`` ticks in all, ``P - 1``
of them the bubble. At the end the last stage's outputs are broadcast over
the pipe group, so every stage returns them (JAX's ``psum`` from the last
stage). A stage with no microbatch at a tick computes nothing: JAX computes
on zeros there and discards the result, so the outputs are the same.

The backward is an explicit schedule (:class:`_Pipeline`), not autograd
across ranks: the forward keeps each tick's local graph (GPipe's activation
memory, as JAX's), and the backward replays the ticks in reverse on every
rank, receiving the activation's gradient from the next stage, running the
tick's graph backward and sending the input's gradient to the previous
stage. The order of the point-to-point operations is thus fixed on every
rank. Every rank computes the same loss from the replicated output, so the
last stage takes its own copy of the output's gradient (one copy, not the
sum over the P stages), and stage 0's input gradient is broadcast over the
pipe group (the input is replicated over it).

Gradient convention: the stacked leaves of a stage get complete gradients
(summed over its microbatches); under a data axis the step averages them
over the data group, as it averages every gradient. Data shards hold
contiguous rows (``mesh.shard_host_batch``) and cut them into microbatches;
JAX's microbatch spans the data shards, which changes no row's output.
"""

from __future__ import annotations

from typing import Callable, Mapping, Optional

import torch
import torch.distributed as dist

from xpretrain_tpu_torch.parallel.mesh import DataMesh, axis_group
from xpretrain_tpu_torch.parallel.p2p import shift

PIPE_AXIS = "pipe"


def stack_layer_params(params: Mapping[str, torch.Tensor], n_layers: int, prefix: str = "layer_"
                       ) -> dict[str, torch.Tensor]:
    """``{layer_0.<name>: t, layer_1.<name>: t, ...}`` -> ``{<name>: [L, ...]}``
    (keys without the prefix are left out). Every layer must hold the same
    names and shapes (true of the BERT towers)."""
    first = f"{prefix}0."
    names = [k[len(first):] for k in params if k.startswith(first)]
    for i in range(1, n_layers):
        if sorted(k for k in params if k.startswith(f"{prefix}{i}.")) != sorted(f"{prefix}{i}.{n}" for n in names):
            raise ValueError(f"{prefix}{i} holds other parameters than {prefix}0")
    return {n: torch.stack([params[f"{prefix}{i}.{n}"] for i in range(n_layers)]) for n in names}


def unstack_layer_params(stacked: Mapping[str, torch.Tensor], n_layers: int, prefix: str = "layer_"
                         ) -> dict[str, torch.Tensor]:
    """Inverse of :func:`stack_layer_params` (for checkpoint export)."""
    return {f"{prefix}{i}.{n}": t[i] for i in range(n_layers) for n, t in stacked.items()}


def pipeline_param_shardings(stacked: Mapping[str, torch.Tensor], mesh: Optional[DataMesh],
                             axis: str = PIPE_AXIS) -> dict[str, torch.Tensor]:
    """JAX's ``pipeline_param_shardings`` (the stacked leaves split over
    ``pipe`` on their leading axis) as what it places on a stage: this
    stage's layers ``[i·L/P, (i+1)·L/P)`` of each stacked leaf (views)."""
    size, index, _ = axis_group(mesh, axis)
    out = {}
    for name, full in stacked.items():
        if full.shape[0] % size:
            raise ValueError(f"{name}: {full.shape[0]} layers not divisible by {axis}={size}")
        per = full.shape[0] // size
        out[name] = full[index * per:(index + 1) * per]
    return out


class _Schedule:
    """What one pipeline's forward and backward share: the stage's place on
    the pipe axis and how it applies its layers."""

    def __init__(self, layer_apply: Callable, per_stage: int, size: int, stage: int, group, names: list[str]):
        self.layer_apply, self.per_stage = layer_apply, per_stage
        self.size, self.stage, self.group, self.names = size, stage, group, names

    def active(self, tick: int, n_micro: int) -> bool:
        return self.stage <= tick < self.stage + n_micro

    def run_stage(self, leaves: list[torch.Tensor], h: torch.Tensor, m: Optional[torch.Tensor]) -> torch.Tensor:
        for j in range(self.per_stage):
            h = self.layer_apply({n: t[j] for n, t in zip(self.names, leaves)}, h, m)
        return h

    def broadcast(self, t: torch.Tensor, src_stage: int) -> None:
        if self.group is not None:
            dist.broadcast(t, src=dist.get_global_rank(self.group, src_stage), group=self.group)


class _Pipeline(torch.autograd.Function):
    """The GPipe schedule as one autograd node: ``x`` [M, mb, ...] and the
    mask ``m`` [M, mb, ...] (or None) in, the last stage's outputs [M, mb,
    ...] out on every stage."""

    @staticmethod
    def forward(ctx, sched: _Schedule, x: torch.Tensor, m: Optional[torch.Tensor], *leaves: torch.Tensor):
        need = any(ctx.needs_input_grad[1:])
        n_micro, last = x.shape[0], sched.size - 1
        params = [p.detach().requires_grad_(need and p.requires_grad) for p in leaves]
        state = torch.zeros_like(x[0])
        smask = None if m is None else torch.zeros_like(m[0])
        out = torch.zeros_like(x)
        ticks = []
        n_ticks = n_micro + last
        for t in range(n_ticks):
            if sched.stage == 0 and t < n_micro:  # stage 0 injects microbatch t
                state, smask = x[t], None if m is None else m[t]
            y = state
            if sched.active(t, n_micro):
                inp = state.detach().requires_grad_(need)
                with torch.set_grad_enabled(need):
                    y = sched.run_stage(params, inp, smask)
                if need:
                    ticks.append((inp, y))
                y = y.detach()
                if sched.stage == last:  # the last stage emits microbatch t - (P - 1)
                    out[t - last] = y
            if t < n_ticks - 1:  # the last tick's handoff reaches no stage in time
                handed = shift((y,) if smask is None else (y, smask), sched.group)
                state, smask = handed[0], None if smask is None else handed[1]
        sched.broadcast(out, last)
        ctx.sched, ctx.ticks, ctx.params = sched, ticks, params
        ctx.x_shape, ctx.x_dtype = x.shape, x.dtype
        return out

    @staticmethod
    def backward(ctx, g_out: torch.Tensor):
        sched, params = ctx.sched, ctx.params
        n_micro, last = ctx.x_shape[0], sched.size - 1
        g_out = g_out.contiguous()
        grads = [torch.zeros_like(p) if p.requires_grad else None for p in params]
        g_x = g_out.new_zeros(ctx.x_shape, dtype=ctx.x_dtype)
        g_hand = g_x[0].clone()  # the gradient of this tick's output from the next stage
        for t in reversed(range(n_micro + last)):
            g_y = g_hand
            if sched.stage == last and t >= last:  # this rank's own copy of the output's gradient
                g_y = g_y + g_out[t - last]
            g_in = torch.zeros_like(g_y)
            if sched.active(t, n_micro):
                inp, y = ctx.ticks.pop()
                wrt = [inp] + [p for p in params if p.requires_grad]
                got = iter(torch.autograd.grad(y, wrt, g_y, allow_unused=True))
                g_in = next(got)
                for i, p in enumerate(params):
                    if p.requires_grad:
                        g = next(got)
                        if g is not None:
                            grads[i] += g
            if sched.stage == 0 and t < n_micro:  # stage 0's input at tick t was microbatch t
                g_x[t] = g_in
                g_in = torch.zeros_like(g_in)
            if t > 0:
                (g_hand,) = shift((g_in,), sched.group, -1)
        ctx.ticks = None
        if ctx.needs_input_grad[1]:
            sched.broadcast(g_x, 0)
        return (None, g_x if ctx.needs_input_grad[1] else None, None, *grads)


def make_pipeline(layer_apply: Callable[[dict, torch.Tensor, Optional[torch.Tensor]], torch.Tensor], n_layers: int,
                  mesh: Optional[DataMesh], *, pipe_axis: str = PIPE_AXIS, data_axis: Optional[str] = None,
                  n_microbatches: Optional[int] = None):
    """Build ``fn(stage_params, hidden, mask=None) -> hidden`` running the
    layer stack as a P-stage pipeline over ``mesh``'s ``pipe_axis``.

    ``layer_apply(layer_params, hidden, mask)`` applies ONE layer, the same
    function for every layer, from ``{<name>: tensor}`` (one layer's slice
    of the stacked leaves). ``stage_params`` is this stage's slice of the
    stacked leaves (:func:`pipeline_param_shardings`), ``hidden`` this data
    index's rows [B, S, H] (the same on every stage), ``mask`` the optional
    additive [B, 1, 1, S] mask. ``n_microbatches`` defaults to the stage
    count and must divide B. Every stage returns the [B, S, H] output."""
    size, stage, group = axis_group(mesh, pipe_axis)
    if data_axis is not None:
        axis_group(mesh, data_axis)
    if n_layers % size:
        raise ValueError(f"{n_layers} layers not divisible by pipe={size}")
    per_stage = n_layers // size
    n_micro = n_microbatches or size

    def run(stage_params: Mapping[str, torch.Tensor], hidden: torch.Tensor,
            mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        batch = hidden.shape[0]
        if batch % n_micro:
            raise ValueError(f"batch {batch} not divisible by microbatches {n_micro}")
        names = list(stage_params)
        for name in names:
            if stage_params[name].shape[0] != per_stage:
                raise ValueError(f"{name}: {stage_params[name].shape[0]} layers on this stage, expected "
                                 f"{per_stage} ({n_layers} over pipe={size})")
        mb = batch // n_micro
        x = hidden.reshape(n_micro, mb, *hidden.shape[1:])
        m = None if mask is None else mask.detach().reshape(n_micro, mb, *mask.shape[1:])
        sched = _Schedule(layer_apply, per_stage, size, stage, group, names)
        y = _Pipeline.apply(sched, x, m, *(stage_params[n] for n in names))
        return y.reshape(batch, *hidden.shape[1:])

    return run


def pipelined_bert_encoder(bert_config, mesh: Optional[DataMesh], *, dtype: torch.dtype = torch.float32,
                           pipe_axis: str = PIPE_AXIS, data_axis: Optional[str] = None,
                           n_microbatches: Optional[int] = None, deterministic: bool = True):
    """The pipeline of :class:`~xpretrain_tpu_torch.models.bert.BertLayer`
    stacks: ``fn(stage_params, hidden, additive_mask)`` equal to
    ``StagedBertEncoder(cfg)(hidden, mask)`` over all layers, each layer
    applied by ``torch.func.functional_call`` on its slice of the stacked
    leaves. As in JAX, dropout inside the pipeline is out of scope: the
    layers run deterministically, and ``deterministic=False`` with a dropout
    rate raises."""
    from xpretrain_tpu_torch.models.bert import BertLayer

    if not deterministic and (bert_config.hidden_dropout_prob or bert_config.attention_probs_dropout_prob):
        raise ValueError("dropout inside the pipeline is out of scope: pass deterministic=True")
    layer = BertLayer(bert_config, dtype=dtype, device="meta").eval()

    def layer_apply(p: dict, h: torch.Tensor, m: Optional[torch.Tensor]) -> torch.Tensor:
        return torch.func.functional_call(layer, p, (h, m))

    return make_pipeline(layer_apply, bert_config.num_hidden_layers, mesh, pipe_axis=pipe_axis,
                         data_axis=data_axis, n_microbatches=n_microbatches)


def stacked_bert_params_from_flax(params: Mapping, bert_config, prefix: str = "layer_") -> dict[str, torch.Tensor]:
    """A flax ``StagedBertEncoder`` params tree (numpy or jax arrays, with or
    without the ``params`` level) -> the port's stacked leaves: through the
    port's BERT key table (``models/lf_vila/convert.py:load_jax_params`` on
    a ``StagedBertEncoder``), then :func:`stack_layer_params`. fp32, on the
    CPU."""
    from xpretrain_tpu_torch.models.bert import StagedBertEncoder
    from xpretrain_tpu_torch.models.lf_vila.convert import load_jax_params

    encoder = load_jax_params(StagedBertEncoder(bert_config), params)
    return stack_layer_params(encoder.state_dict(), bert_config.num_hidden_layers, prefix)


__all__ = [
    "PIPE_AXIS",
    "make_pipeline",
    "pipeline_param_shardings",
    "pipelined_bert_encoder",
    "stack_layer_params",
    "stacked_bert_params_from_flax",
    "unstack_layer_params",
]
