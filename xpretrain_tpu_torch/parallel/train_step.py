"""Data-parallel train and eval steps (``xpretrain_tpu/parallel/train_step.py``).

The JAX step is one jitted SPMD program over a mesh; here each rank of the
data-parallel group (``parallel/mesh.py``) runs it eagerly on its own
device and batch. The losses see the global batch through autograd-carrying
gathers (``ops/losses.py``); after the backward the step averages the
gradients over ranks with explicit collectives (not DDP hooks, so the same
code runs eagerly, inside a captured CUDA graph and under gloo), takes the
global grad norm on the averaged gradients, and averages the metrics, so
``loss`` and ``grad_norm`` are the global ones on every rank. Without a
group the step is one device's, with no collective. The train step updates
the model's parameters and the optimizer's state in place (JAX returns new
arrays; in place saves a copy of every parameter and moment); under ZeRO-2
the optimizer updates its shard and all-gathers the parameters
(``optim/optimizer.py:zero2_shard``).

``steps_per_call = K > 1`` (JAX's ``_scan_steps``: K steps chained in one
``lax.scan`` dispatch) takes batches stacked on a leading axis and returns
the metrics with a leading axis. On the CPU it is a loop of eager steps. On
a card it is a CUDA graph of one step (:class:`GraphedStep`), replayed once
per batch after that batch is copied into the graph's input buffers: the
first call of each micro-step index (accumulation takes one graph each) runs
eagerly on a side stream as the warm-up (which also runs the group's first
collectives, so NCCL's communicator exists before the capture), the second
captures. Step ``s`` of a chunk seeds its generator with ``seed + s`` (and
the data index, ``utils/prng.py:rank_seed``) in every path, so a run at K = 4
equals a run at K = 1, bit for bit.

On a 2-D ``(data, model)`` mesh (``--tp`` / ``--cp``, ``parallel/mesh.py``)
the ranks of one model group hold the same rows and seed the same
generator, so they draw the same dropout masks on replicated activations
(different masks would make their replicated parameters drift apart), and
they compute the same loss. The gradient conventions (the optimizer's
``reduce_gradients``, ``optim/optimizer.py``):

- every gradient is averaged over the data group, as above; a ZeRO-3 block
  arrives averaged from its gather's backward (``parallel/fsdp.py``);
- a TP-sharded parameter's gradient is complete for its block: the column
  layers' inputs sum their gradients over the model group in the backward
  (``parallel/tensor_parallel.py``), so every replicated parameter upstream
  of them gets the whole gradient on every model rank;
- a ``model_partial`` parameter's gradient is this rank's share and is
  summed over the model group: a row layer's bias (added on model rank 0),
  a Swin3D bias table sliced to the rank's heads, and under ``--cp`` every
  Swin3D parameter, whose rank computes on its own frames.

The grad norm counts each element once (``GroupedAdamW.grad_norm``). The
captured graph of ``steps_per_call > 1`` holds the layouts' collectives as it
holds the data-parallel ones, and ZeRO-3's gathers run in forward hooks,
which the capture records like any other op.

The host side of a step is spanned (``utils/profiling.py``): ``xpt.step``
around a call of the public step, ``xpt.step.forward``, ``.backward`` and
``.optimizer`` inside the device part (on a card's graphed step, only at its
warm-up and capture), ``xpt.step.warm_up``, ``.capture`` and ``.replay`` in
:class:`GraphedStep`, and ``xpt.ingest.place`` around a batch's upload.
"""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional

import numpy as np
import torch
from torch import nn

from xpretrain_tpu_torch.ops import _kernels
from xpretrain_tpu_torch.optim.optimizer import LOGIT_SCALE_MAX, GroupedAdamW, clamp_logit_scale
from xpretrain_tpu_torch.parallel.fsdp import step_scope
from xpretrain_tpu_torch.parallel.mesh import all_reduce_mean_, current_mesh
from xpretrain_tpu_torch.utils.prng import rank_seed
from xpretrain_tpu_torch.utils.profiling import span


@dataclasses.dataclass
class TrainState:
    """``step`` counts train-step calls; the parameters live in ``model`` and
    the Adam state in ``optimizer``."""

    step: int
    model: nn.Module
    optimizer: GroupedAdamW


def contrastive_loss_from_outputs(outputs: dict, loss_fn: Callable) -> torch.Tensor:
    """Dispatch model outputs into a loss-zoo function by its signature kind."""
    kind = getattr(loss_fn, "signature_kind", "pair_scale")
    if kind == "pair_temp":
        return loss_fn(outputs["vis_features"], outputs["text_features"])
    if kind == "pair_scale":
        return loss_fn(outputs["vis_features"], outputs["text_features"], outputs["logit_scale"])
    if kind == "quad_scale":
        return loss_fn(
            outputs["vis_features"],
            outputs["text_features"],
            outputs.get("img_features", outputs["vis_features"]),
            outputs.get("cap_features", outputs["text_features"]),
            outputs["logit_scale"],
        )
    raise ValueError(f"unknown loss signature {kind!r}")


def batch_to_device(device: torch.device | str) -> Callable[[dict], dict]:
    """numpy batch -> tensors on ``device``, through pinned memory with
    ``non_blocking`` copies on CUDA (span ``xpt.ingest.place``)."""
    device = torch.device(device)
    pin = device.type == "cuda"

    def to_device(x: np.ndarray) -> torch.Tensor:
        t = torch.from_numpy(np.ascontiguousarray(x))
        if pin:
            t = t.pin_memory()
        return t.to(device, non_blocking=pin)

    def place(batch: dict) -> dict:
        with span("xpt.ingest.place"):
            return {k: to_device(v) if isinstance(v, np.ndarray) else v for k, v in batch.items()}

    return place


def make_train_step(
    apply_fn: Callable[[nn.Module, dict, torch.Generator], dict],
    loss_fn: Callable,
    device: torch.device | str,
    steps_per_call: int = 1,
) -> Callable[[TrainState, dict, int], tuple[TrainState, dict]]:
    """Build ``step(state, batch, seed) -> (state, metrics)``.

    ``apply_fn(model, batch, generator)`` returns the feature dict that
    ``loss_fn`` takes (:func:`contrastive_loss_from_outputs`); ``batch`` holds
    tensors on ``device``; ``seed`` seeds the step's dropout generator. In
    order: clamp logit_scale to [0, ln 200], forward, loss, backward,
    update, clamp. The metrics (``loss``, ``grad_norm`` of the raw
    gradients, ``logit_scale`` of the forward) stay device tensors, so the
    step does not wait for the card. With ``steps_per_call > 1`` the batch
    is stacked on a leading axis (see the module's docstring). In a group
    the gradients and ``loss`` are averaged over ranks."""

    def run(state: TrainState, batch: dict, generator: torch.Generator) -> dict:
        model = state.model
        named = dict(model.named_parameters())
        # clamp before the forward, as the reference does each iteration
        clamp_logit_scale(named, LOGIT_SCALE_MAX)
        model.train()
        for p in named.values():
            p.grad = None
        with step_scope(model):
            with span("xpt.step.forward"):
                outputs = apply_fn(model, batch, generator)
                loss = contrastive_loss_from_outputs(outputs, loss_fn)
            with span("xpt.step.backward"):
                loss.backward()
        with span("xpt.step.optimizer"):
            grads = _global_grads(state.optimizer, named.values())
            metrics = _global_metrics({"loss": loss.detach()})
            metrics["grad_norm"] = state.optimizer.grad_norm(grads)
            metrics["logit_scale"] = outputs["logit_scale"].detach().clone()
            # the metric's norm is the one clipping needs: one pass, not two
            state.optimizer.apply(grads, metrics["grad_norm"])
        for p in named.values():
            p.grad = None
        clamp_logit_scale(named, LOGIT_SCALE_MAX)
        return metrics

    return _stepper(run, device, steps_per_call)


def make_model_train_step(
    apply_fn: Callable[[nn.Module, dict, torch.Generator], dict],
    device: torch.device | str,
    loss_key: str = "loss",
    metric_keys: tuple[str, ...] = (),
    steps_per_call: int = 1,
) -> Callable[[TrainState, dict, int], tuple[TrainState, dict]]:
    """Build ``step(state, batch, seed) -> (state, metrics)`` for models that
    compute their own loss (LF-VILA; ``GenericTrainer`` drives it).

    ``apply_fn(model, batch, generator)`` returns a dict holding ``loss_key``;
    the ``metric_keys`` it also holds are copied (detached) into the metrics,
    beside ``loss`` (fp32) and ``grad_norm`` of the raw gradients; in a group
    each is averaged over ranks (the model's losses and metrics are per-rank
    terms whose mean is the global value, ``parallel/mesh.py``). In order:
    forward, backward, update. ``steps_per_call`` as :func:`make_train_step`."""

    def run(state: TrainState, batch: dict, generator: torch.Generator) -> dict:
        model = state.model
        params = list(model.parameters())
        model.train()
        for p in params:
            p.grad = None
        with step_scope(model):
            with span("xpt.step.forward"):
                outputs = apply_fn(model, batch, generator)
                loss = outputs[loss_key].float()
            with span("xpt.step.backward"):
                loss.backward()
        with span("xpt.step.optimizer"):
            grads = _global_grads(state.optimizer, params)
            metrics = {"loss": loss.detach()}
            for key in metric_keys:
                if key in outputs:
                    metrics[key] = outputs[key].detach()
            metrics = _global_metrics(metrics)
            metrics["grad_norm"] = state.optimizer.grad_norm(grads)
            state.optimizer.apply(grads, metrics["grad_norm"])
        for p in params:
            p.grad = None
        return metrics

    return _stepper(run, device, steps_per_call)


def _global_grads(optimizer: GroupedAdamW, params) -> list[torch.Tensor]:
    """Every parameter's gradient (zeros where none), in the update's dtype,
    reduced over the mesh (``GroupedAdamW.reduce_gradients``)."""
    grads = optimizer.upcast([p.grad if p.grad is not None else torch.zeros_like(p) for p in params])
    optimizer.reduce_gradients(grads)
    return grads


def _global_metrics(metrics: dict) -> dict:
    """The metrics averaged over the group's ranks (in place: they are
    fresh detached tensors)."""
    all_reduce_mean_(list(metrics.values()))
    return metrics


def _stepper(run: Callable[[TrainState, dict, torch.Generator], dict], device: torch.device | str,
             steps_per_call: int) -> Callable[[TrainState, dict, int], tuple[TrainState, dict]]:
    """The public step around ``run``, the device part of one step: the
    optimizer's host part before and after it, and, for ``steps_per_call >
    1``, the loop over a stacked batch (graphed on a card)."""
    device = torch.device(device)
    if steps_per_call < 1:
        raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")

    def eager(state: TrainState, batch: dict, seed: int) -> dict:
        state.optimizer.prepare()
        metrics = run(state, batch, torch.Generator(device=device).manual_seed(_seed(seed)))
        state.optimizer.advance()
        state.step += 1
        return metrics

    if steps_per_call == 1:
        def step_fn(state: TrainState, batch: dict, seed: int) -> tuple[TrainState, dict]:
            with span("xpt.step"):
                return state, eager(state, batch, seed)

        return step_fn

    one = GraphedStep(run, device) if device.type == "cuda" else eager

    def multi(state: TrainState, batches: dict, seed: int) -> tuple[TrainState, dict]:
        with span("xpt.step"):
            lengths = {int(v.shape[0]) for v in batches.values()}
            if len(lengths) != 1:
                raise ValueError(f"stacked batch leaves differ in their leading (step) axis: {sorted(lengths)}")
            rows = [one(state, {k: v[i] for k, v in batches.items()}, seed + i) for i in range(lengths.pop())]
            return state, {key: torch.stack([row[key] for row in rows]) for key in rows[0]}

    multi.graphed = one if isinstance(one, GraphedStep) else None
    return multi


def _seed(seed: int) -> int:
    """The generator seed of this rank for the step seeded ``seed``: a
    function of its data index, which the ranks of a model group share."""
    mesh = current_mesh()
    return rank_seed(seed, 0 if mesh is None else mesh.rank)


def _schema(batch: dict) -> tuple:
    return tuple((k, tuple(v.shape), v.dtype) for k, v in sorted(batch.items()))


@dataclasses.dataclass
class _Capture:
    graph: "torch.cuda.CUDAGraph"
    inputs: dict  # the static batch the graph reads
    generator: torch.Generator  # registered with the graph, reseeded per replay
    metrics: dict  # the static metrics the graph writes
    launches: tuple  # (wrapper, kernel launches recorded during the capture)


class GraphedStep:
    """One train step on a card as a captured CUDA graph.

    ``step(state, batch, seed) -> metrics`` runs the optimizer's host part,
    then the device part ``run``: the first time for a (batch schema,
    micro-step index) eagerly, on a side stream (the warm-up: the kernel
    library, cuBLAS and the autograd threads come up outside the capture);
    the second time it captures ``run`` into a graph; from then on it copies
    ``batch`` into the graph's input buffers, reseeds the graph's generator
    with ``seed`` and replays. The Python launch counters count once, at
    capture; each replay adds the launches the capture recorded, so they
    count kernels run (every wrapper in ``ops._kernels.COUNTED``). Metrics
    come back as copies, since the next replay overwrites the graph's own. A
    new schema (the eval batch never comes here) captures anew.

    All the graphs allocate from one memory pool, so accumulation's graphs
    hold one step's activations, not one each. That is safe because they
    replay one after another on one stream and nothing reads a graph's
    output after another graph has replayed: the metrics are copied at once,
    and what carries over between replays (parameters, moments, accumulated
    gradients, the input buffers) is allocated outside the pool."""

    def __init__(self, run: Callable[[TrainState, dict, torch.Generator], dict], device: torch.device):
        self.run = run
        self.device = device
        self.captures: dict[tuple, Optional[_Capture]] = {}
        self.side: Optional[torch.cuda.Stream] = None  # the warm-ups' stream
        self.pool = None  # the memory pool the captures share

    def __call__(self, state: TrainState, batch: dict, seed: int) -> dict:
        state.optimizer.prepare()
        key = (_schema(batch), state.optimizer.mini_step)
        if key not in self.captures:
            metrics = self._warm_up(state, batch, seed)
            self.captures[key] = None
        else:
            capture = self.captures[key]
            if capture is None:
                capture = self.captures[key] = self._capture(state, batch)
            metrics = self._replay(capture, batch, seed)
        state.optimizer.advance()
        state.step += 1
        return metrics

    def _warm_up(self, state: TrainState, batch: dict, seed: int) -> dict:
        with span("xpt.step.warm_up"):
            main = torch.cuda.current_stream(self.device)
            # one stream for every warm-up, so each reuses the blocks the last cached
            side = self.side = self.side or torch.cuda.Stream(self.device)
            side.wait_stream(main)
            for t in batch.values():
                t.record_stream(side)
            with torch.cuda.stream(side):
                metrics = self.run(state, batch, torch.Generator(device=self.device).manual_seed(_seed(seed)))
            main.wait_stream(side)
            for t in metrics.values():
                t.record_stream(main)
            return metrics

    def _capture(self, state: TrainState, batch: dict) -> _Capture:
        with span("xpt.step.capture"):
            inputs = {k: v.clone() for k, v in batch.items()}
            generator = torch.Generator(device=self.device)
            graph = torch.cuda.CUDAGraph()
            graph.register_generator_state(generator)
            wrappers = tuple(_kernels.COUNTED)
            before = [fn.launches for fn in wrappers]
            # thread-local: an async checkpoint's writer or a prefetch thread may
            # call into CUDA while this thread captures
            with torch.cuda.graph(graph, pool=self.pool, capture_error_mode="thread_local"):
                metrics = self.run(state, inputs, generator)
            if self.pool is None:
                self.pool = graph.pool()
            launches = []
            for fn, count in zip(wrappers, before):
                launches.append((fn, fn.launches - count))
                fn.launches = count  # a capture launches nothing
            return _Capture(graph, inputs, generator, metrics, tuple(launches))

    @staticmethod
    def _replay(capture: _Capture, batch: dict, seed: int) -> dict:
        with span("xpt.step.replay"):
            for key, buf in capture.inputs.items():
                buf.copy_(batch[key], non_blocking=True)
            capture.generator.manual_seed(_seed(seed))
            capture.graph.replay()
            for fn, n in capture.launches:
                fn.launches += n
            return {key: value.clone() for key, value in capture.metrics.items()}


CLIPVIP_EVAL_IO = (("video", "text_input_ids", "text_input_mask"),
                   {"vis_features": "vis_features", "text_features": "text_features"})
# LF-VILA batches and outputs (``_rename`` of ``xpretrain_tpu/cli/run_tasks_lfvila.py``)
LFVILA_EVAL_IO = (("video_frames", "text_ids", "attention_mask"),
                  {"vis_features": "video_global_feat", "text_features": "text_global_feat"})


def make_eval_step(device: torch.device | str, io: tuple = CLIPVIP_EVAL_IO
                   ) -> Callable[[nn.Module, dict], dict]:
    """Forward of one numpy batch on ``device``: ``step(model, batch)``.

    ``io`` is (the batch keys the model takes, in order; {feature name:
    model output key}). The batch goes to the device through pinned memory
    with ``non_blocking`` copies; the forward runs under ``inference_mode``;
    the features come back as fp32 numpy under the names of
    ``xpretrain_tpu_torch.train.evaluate.evaluate_retrieval``."""
    place = batch_to_device(device)
    inputs, outputs = io

    def eval_step(model: nn.Module, batch: dict) -> dict[str, np.ndarray]:
        with torch.inference_mode():
            b = place({k: batch[k] for k in inputs})
            out = model(*(b[k] for k in inputs))
            return {name: out[key].float().cpu().numpy() for name, key in outputs.items()}

    return eval_step
