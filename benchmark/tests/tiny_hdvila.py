"""``hdvila_stage1.pretrain`` at a size the CPU runs in seconds: the cell's
own files with the crop, the TimeSformer, BERT and the batch cut and
the ResNet-50s whole, for the CPU tests of the benchmark and of the port."""

from __future__ import annotations

import copy

from benchmark.tests import tiny

CELL = "hdvila_stage1.pretrain"


def hdvila(cell: str = CELL) -> tuple[dict, dict]:
    """(workload, config): ResNet-50 bottlenecks over 64x128 middles and
    16x32 neighbours, one TimeSformer block of width 64 over the 1x2 grid,
    the port's tiny BERT staged (2,), batch 4, captions of 12 positions,
    fp32; 10 schedule steps, so warmup ends after the first update. (At the
    cell's 1000 the first updates, lr 1e-8 to 1e-6, are a few ulps of the
    norm scales near 1, and one element's rounding decides the change gap
    of a 64-channel FrozenBN leaf, at ~1e-4 of the median leaf's change.)"""
    wl, cfg = copy.deepcopy(tiny.load("workloads", cell)), copy.deepcopy(tiny.load("configs", "hdvila_stage1"))
    cfg["crop_size"] = [64, 128]
    cfg["timesformer"].update(depth=1, heads=4, hidden_size=64, grid=[1, 2])
    cfg["text"].update(vocab_size=49408, hidden_size=64, num_attention_heads=4, intermediate_size=128, stage_layers=2)
    cfg["preset"].update(crop_size=[64, 128], timesformer_depth=1, timesformer_heads=4, timesformer_hw=[1, 2],
                         hidden_size=64, bert="tiny", bf16=0, num_train_steps=10)
    cfg["optimizer"].update(num_train_steps=10, warmup_steps=1)
    wl["params"].update(batch=4, height=64, width=128, seq=12, trace_steps=2, scenes={"cell": 16, "drift": 6.0,
                                                                                      "noise": 20.0})
    return wl, cfg
