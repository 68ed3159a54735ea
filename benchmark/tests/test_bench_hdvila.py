"""The cell ``hdvila_stage1.pretrain``: its FLOP count against
``torch.utils.flop_counter`` on the plain reference at a small size, its
files against ``BENCHMARK.json``, its batch schema, and a traced CPU run
that loads every reader the cell lists."""

from __future__ import annotations

import torch
from torch.utils.flop_counter import FlopCounterMode

from benchmark import run
from benchmark.reference import hdvila_stage1 as ref
from benchmark.reference.plain import Precision
from benchmark.tests import tiny, tiny_hdvila
from benchmark.traffic import batches, hdvila_clips
from benchmark.weights import make_weights
from benchmark.work import hdvila_stage1 as work

CELL = tiny_hdvila.CELL


def test_counts_match_the_flop_counter():
    """Every convolution and GEMM, and attention within each pattern (a
    location's frames, a frame's locations, a caption's positions, each
    computed densely by the reference): the whole forward agrees."""
    wl, cfg = tiny_hdvila.hdvila()
    params = wl["params"]
    batch = {k: torch.from_numpy(v) for k, v in batches.pool(params, 5, "cpu")[0].items()}
    p = make_weights(ref.leaves(cfg), 5, "cpu")

    def forward():
        with torch.no_grad():
            video = ref.video_features(p, cfg, batch["img_middle"], batch["img_other"], Precision())
            text = ref.text_features(p, cfg["text"], batch["text_input_ids"], batch["text_input_mask"], None,
                                     Precision())
            ref.itc_loss(p, cfg, video, text, Precision())

    with FlopCounterMode(display=False) as counter:
        forward()
    parts = work.forward_flops(cfg, params["batch"], params["seq"])
    assert counter.get_total_flops() == parts["conv"] + parts["gemm"] + parts["attention"]
    assert work.model_flops(cfg, "train", params["batch"], params["seq"]) == 3 * sum(parts.values())


def test_full_size_counts():
    """At the cell's size: 640x1024 middles give the 10x16 grid, ~30 TFLOP a
    step, and no op has a bound for a roofline to read."""
    wl, cfg = tiny.load("workloads", CELL), tiny.load("configs", "hdvila_stage1")
    batch = wl["params"]["batch"]
    convs = work.convolutions(cfg, batch)
    hi = work.resnet_convs(cfg, *cfg["crop_size"], 4)
    assert (hi[-1]["hout"] // 2, hi[-1]["wout"] // 2) == tuple(cfg["timesformer"]["grid"])
    assert len(convs) == 53 + (1 + 3 * 13 + 3) + 3  # the full ResNet-50, the low one to stage 3, the grid
    assert work.op_bounds(cfg, "train", batch) == {}
    assert 25e12 < work.model_flops(cfg, "train", batch, wl["params"]["seq"]) < 35e12


def test_spec_validates_with_the_cell():
    spec = run.load_spec()
    run.validate(spec)
    e2e, per_layer = run.cell_metrics(spec, CELL)
    assert {m["name"] for m in e2e} == {"train_clips_per_s", "setup_s"}
    assert {m["name"] for m in per_layer} == {"ingest_ms.train", "device_idle.train", "mfu.train", "optimizer_ms.train",
                                              "peak_gib.train", "stack_ms.train", "place_ms.train", "dispatch_ms.train"}


def test_schema_shapes_and_neighbours_are_the_scene_shrunk_by_four():
    wl, _ = tiny_hdvila.hdvila()
    params = wl["params"]
    a, b = batches.pool(params, 1, "cpu"), batches.pool(params, 2**31 + 7, "cpu")
    B, C, T, H, W = params["batch"], params["clips"], params["frames"], params["height"], params["width"]
    f = params["low_res_factor"]
    want = {"img_middle": (B, C, 3, H, W), "img_other": (B, C, T - 1, 3, H // f, W // f),
            "text_input_ids": (B, params["seq"]), "text_input_mask": (B, params["seq"])}
    for x in a + b:
        assert {k: v.shape for k, v in x.items()} == want
        assert x["img_middle"].dtype == x["img_other"].dtype == "uint8"
        ids = x["text_input_ids"]
        assert (ids[:, 0] == params["cls_id"]).all() and ((ids == params["sep_id"]).sum(1) == 1).all()
    assert not (a[0]["img_middle"] == b[0]["img_middle"]).all()
    # the batch is frame T // 2 of each scene at full size and the others shrunk by 4
    s = batches._subseed(1, 0)
    scenes = hdvila_clips.scene_frames(params["scenes"], B * C, T, H, W, s, "cpu").reshape(B, C, T, 3, H, W)
    assert (torch.from_numpy(a[0]["img_middle"]) == scenes[:, :, T // 2]).all()
    others = torch.cat([scenes[:, :, : T // 2], scenes[:, :, T // 2 + 1:]], dim=2)
    assert (torch.from_numpy(a[0]["img_other"]) == hdvila_clips.shrink(others, f)).all()
    # a neighbour is its scene x4 smaller: next to the middle frame's own
    # shrink it is far closer than another clip's
    middle = hdvila_clips.shrink(torch.from_numpy(a[0]["img_middle"]), f).float()
    near = torch.from_numpy(a[0]["img_other"][:, :, T // 2 - 1]).float()
    assert (middle - near).abs().mean() < 0.25 * (middle - near.roll(1, 0)).abs().mean()


def test_traced_cpu_run_loads_every_reader_of_the_cell():
    spec = run.load_spec()
    _, per_layer = run.cell_metrics(spec, CELL)
    wl, cfg = tiny_hdvila.hdvila()
    line = run.execute(CELL, 2**31 + 4242, 1.0, True, device="cpu", wl=wl, cfg=cfg)
    assert line["correct"] is True
    assert set(line["metrics"]) <= {m["name"] for m in per_layer}
    for m in per_layer:
        assert run.metric_module(m["name"]).MOVES == "train_clips_per_s"


def test_the_fp8_control_is_not_correct():
    """The reference computed in float8 e4m3 in the program's place, held to
    the float32 reference by the cell's limits."""
    from benchmark import controls

    wl, cfg = tiny_hdvila.hdvila()
    numbers = controls.train_control_numbers(controls.cell_for(CELL, 2**31 + 99, "cpu", wl, cfg))
    assert any(numbers[k] > limit for k, limit in wl["limits"].items()), numbers
