"""Closed-loop indexing: one worker hands the program a host (numpy) batch
of clips and their texts, waits for both features on the host, and sends
the next, cycling through the pool. A call's time runs from the host handing
over the batch to the features being back.

Set-up builds the towers from the seed's weights and warms them with
``warm_calls`` calls. After the window every call's features are held to the
plain reference's features of the same batch."""

from __future__ import annotations

import torch

from benchmark import check
from benchmark.reference.plain import Precision, strict_fp32
from benchmark.timing import Window
from benchmark.traffic.batches import pool as make_pool
from benchmark.weights import make_weights


def reference_features(cell, batches: list[dict], precision: str = "fp32") -> list:
    """The reference's (video, text) features of each batch, on the host."""
    with strict_fp32():
        p = make_weights(cell.reference.leaves(cell.cfg, cell.kind), cell.seed, cell.device)
        out = []
        for b in batches:
            on_device = {k: torch.from_numpy(v).to(cell.device) for k, v in b.items()}
            v, t = cell.reference.features(p, cell.cfg, on_device, Precision(precision))
            out.append((v.cpu().numpy(), t.cpu().numpy()))
    return out


def run(cell):
    params = cell.params
    weights = make_weights(cell.reference.leaves(cell.cfg, cell.kind), cell.seed, cell.device)
    towers = cell.program.build_towers(cell.cfg, params, weights, cell.device)
    del weights
    batches = make_pool(params, cell.seed, cell.device)
    for i in range(params["warm_calls"]):
        cell.program.serve(towers, batches[i % len(batches)])
    served: list[tuple[int, tuple]] = []

    def one_call(i: int):
        k = i % len(batches)
        served.append((k, cell.program.serve(towers, batches[k])))

    result = Window(cell, one_call, params["trace_steps"], [0.0]).run()
    del towers
    cell.free_device()
    ref = reference_features(cell, batches)
    result.numbers = check.feature_numbers([feats for _, feats in served], [ref[k] for k, _ in served])
    result.work_per_step = params["batch"]
    return result
