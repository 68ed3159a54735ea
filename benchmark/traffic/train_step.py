"""Closed-loop training: one trainer takes call after call on the pool's
host batches, as ``train/loop.py:drive_train_loop`` drives it: at
``steps_per_call`` K = 1, ``train_step(state, place_batch(batch), seed +
step)``; at K > 1, the loop's ``stack_batches`` of K batches through the
same two calls (on a card, K replays of the step's captured CUDA graph).
The loss is read on the host at every ``log_steps`` boundary, as the
runner's log does.

Set-up builds the trainer from the seed's weights and takes its first
``check_steps`` steps on distinct batches through that same call (the first
call one step long, so that the optimizer's state shows the first gradient;
a chunk shorter than K is the loop's tail chunk); they warm every shape the
window uses and give the program's readings (each step's loss, the first
gradient from AdamW's first moment, each leaf's change). With
``params["grad_elements"]`` the first gradient is also kept whole on the
host, for the element-wise gap of ``check.py``. After the window the plain
reference follows the same steps from the same weights and batches."""

from __future__ import annotations

import time

import torch

from benchmark import check
from benchmark.reference.plain import Precision, strict_fp32
from benchmark.timing import Window
from benchmark.traffic.batches import pool as make_pool
from benchmark.weights import make_weights


def step_seed_base(seed: int) -> int:
    """The trainer's ``seed + 1`` (``drive_train_loop``): step s draws from base + s."""
    return int(seed) + 1


class Caller:
    """One call of the trainer on a list of host batches, as the loop makes it."""

    def __init__(self, cell, trainer, state):
        from xpretrain_tpu_torch.train.loop import stack_batches

        self.trainer, self.state, self.stack = trainer, state, stack_batches
        self.k = int(cell.params.get("steps_per_call", 1))
        self.base = step_seed_base(cell.seed)
        self.host_s = [0.0]  # seconds inside place_batch

    def __call__(self, batches: list[dict]) -> dict:
        t = time.perf_counter()
        placed = self.trainer.place_batch(batches[0] if self.k == 1 else self.stack(batches))
        self.host_s[0] += time.perf_counter() - t
        self.state, metrics = self.trainer.train_step(self.state, placed, self.base + self.state.step)
        return metrics


def first_steps(cell, trainer, state, batches: list[dict]) -> dict:
    """Take ``len(batches)`` steps through the window's own call; the
    program's readings of them."""
    call = Caller(cell, trainer, state)
    chunks = [batches[:1]] + ([[b] for b in batches[1:]] if call.k == 1 else [batches[1:]])
    losses, grads, whole = [], None, None
    for chunk in chunks:
        losses += [float(x) for x in call(chunk)["loss"].float().reshape(-1)]
        if grads is None:
            opt = trainer.optimizer
            grads = {n: float(torch.linalg.vector_norm(m.float()) / (1 - opt.b1)) for n, m in zip(opt.names, opt.mu)}
            if cell.params.get("grad_elements"):
                whole = {n: m.cpu().float() / (1 - opt.b1) for n, m in zip(opt.names, opt.mu)}
    init = make_weights(cell.reference.leaves(cell.cfg, cell.kind), cell.seed, cell.device)
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(p.float() - init[n])) for n, p in trainer.model.named_parameters()}
    out = {"losses": losses, "grad_norms": grads, "change_norms": change}
    return out if whole is None else {**out, "grads": whole}


def reference_readings(cell, batches: list[dict], precision: str = "fp32") -> dict:
    """The plain reference's readings of the same steps from the same weights."""
    dev = cell.device
    with strict_fp32():
        init = make_weights(cell.reference.leaves(cell.cfg, cell.kind), cell.seed, dev)
        p = {n: w.clone().requires_grad_(True) for n, w in init.items()}
        on_device = [{k: torch.from_numpy(v).to(dev) for k, v in b.items()} for b in batches]
        out = cell.reference.train(p, cell.cfg, on_device, Precision(precision), step_seed_base(cell.seed))
        with torch.no_grad():
            change = {n: float(torch.linalg.vector_norm(p[n] - init[n])) for n in p}
    readings = {"losses": [float(x) for x in out["losses"]],
                "grad_norms": {n: float(g) for n, g in out["grad_norms"].items()}, "change_norms": change}
    if cell.params.get("grad_elements"):
        readings["grads"] = {n: g.cpu() for n, g in out["grads"].items()}
    return readings


def run(cell):
    """Set up, run the window, check; returns the driver's outcome."""
    params = cell.params
    weights = make_weights(cell.reference.leaves(cell.cfg, cell.kind), cell.seed, cell.device)
    trainer, state = cell.program.build_trainer(cell.cfg, params, weights, cell.device, cell.out_dir)
    del weights
    batches = make_pool(params, cell.seed, cell.device)
    n_check, log_steps = params["check_steps"], params["log_steps"]
    prog = first_steps(cell, trainer, state, batches[:n_check])
    call = Caller(cell, trainer, state)
    k = call.k

    def one_call(i: int):
        first = n_check + i * k
        before = call.state.step
        metrics = call([batches[(first + j) % len(batches)] for j in range(k)])
        if call.state.step // log_steps > before // log_steps:
            float(metrics["loss"].reshape(-1)[0])  # the runner's log reads the loss on the host

    result = Window(cell, one_call, params["trace_steps"], call.host_s).run()
    del trainer, state, call
    cell.free_device()
    ref = reference_readings(cell, batches[:n_check])
    result.numbers = check.train_numbers(prog, ref)
    result.steps_per_unit, result.work_per_step = k, k * params["batch"]
    return result
