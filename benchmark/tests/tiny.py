"""Cells at a size the CPU runs in seconds: the cell's own files with the
widths, depths, frames and batch cut, for the benchmark's CPU tests."""

from __future__ import annotations

import copy
import json
from pathlib import Path

BENCH = Path(__file__).resolve().parents[1]


def load(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def clipvip(cell: str) -> tuple[dict, dict]:
    """(workload, config) of a CLIP-ViP cell at the preset's ``tiny`` size:
    2 layers of width 64 in each tower, 2 frames of 32 px, batch 4, fp32."""
    wl, cfg = load("workloads", cell), load("configs", "clipvip_b32")
    cfg = copy.deepcopy(cfg)
    cfg["vision"].update(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                         image_size=32, patch_size=16)
    cfg["text"].update(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4)
    cfg["projection_dim"] = 32
    cfg["temporal_size"] = 2
    cfg["preset"].update(clip_size="tiny", crop_img_size=32, bf16=0)
    cfg["preset"]["clip_vision_additional_config"]["temporal_size"] = 2
    wl = copy.deepcopy(wl)
    wl["params"].update(batch=4, frames=2, size=32, trace_steps=2)
    return wl, cfg


def lfvila(cell: str) -> tuple[dict, dict]:
    """(workload, config) of an LF-VILA cell at the port's tiny size: Swin3D
    of width 32 and depths (1, 1, 2, 1, 1, 1), a 6-layer BERT of width 256
    staged (2, 4), 8 frames at 192x320, batch 4, sentences of 12 positions,
    fp32."""
    wl, cfg = load("workloads", cell), load("configs", "lfvila_stage1")
    cfg = copy.deepcopy(cfg)
    cfg["video"].update(embed_dim=32, depths=[1, 1, 2, 1, 1, 1], num_heads=[2, 2, 4, 4, 4, 4])
    cfg["text"].update(vocab_size=49408, hidden_size=256, num_attention_heads=4, intermediate_size=512,
                       stage_bounds=[2, 4])
    cfg["sample_frame"] = 8
    for preset in cfg["preset"].values():
        preset["video_encoder"].update(embed_dim=32, depths=[1, 1, 2, 1, 1, 1], num_heads=[2, 2, 4, 4, 4, 4])
        preset.update(bert="tiny", num_local_layers=2, stage1_layers=4, sample_frame=8, bf16=0)
    wl = copy.deepcopy(wl)
    wl["params"].update(batch=4, frames=8, seq=12, pool=4, trace_steps=2, vocab_size=49408)
    return wl, cfg
