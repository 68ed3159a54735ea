"""The per-layer metrics that read the program's spans: each cell's tiny
CPU form with ``--trace 1`` reports each of them, finite and positive, where
its ``workloads`` list the cell and leaves it out elsewhere; a program
without the spans reads nothing."""

from __future__ import annotations

import math

import pytest

from benchmark import run
from benchmark.tests import tiny
from benchmark.timing import Result

SPAN_METRICS = ("stack_ms.train", "place_ms.train", "dispatch_ms.train", "upload_ms.serve", "dispatch_ms.serve")
CELLS = {"clipvip_b32.train_graphed": tiny.clipvip, "lfvila_stage1.pretrain": tiny.lfvila,
         "lfvila_stage1.index": tiny.lfvila}


def test_spec_with_the_span_metrics_validates():
    spec = run.load_spec()
    run.validate(spec)
    entries = {m["name"]: m for m in spec["per_layer"]}
    assert all(entries[name]["source"] == "program_counter" for name in SPAN_METRICS)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_traced_run_reports_the_span_metrics_of_its_cell(cell):
    spec = run.load_spec()
    listed = {m["name"] for m in spec["per_layer"] if m["name"] in SPAN_METRICS and cell in m["workloads"]}
    assert listed
    wl, cfg = CELLS[cell](cell)
    mfu = "mfu." + wl["kind"]
    for seconds in (3.0, 12.0, 48.0):  # until the window outlasts its traced units on a loaded host
        line = run.execute(cell, 2**31 + 4242, seconds, True, device="cpu", wl=wl, cfg=cfg)
        if mfu in line["metrics"]:
            break
    assert line["correct"] is True and mfu in line["metrics"]
    got = {name: m["value"] for name, m in line["metrics"].items() if name in SPAN_METRICS}
    assert set(got) == listed
    assert all(math.isfinite(v) and v > 0 for v in got.values()), got


def test_a_program_without_the_spans_reads_nothing(monkeypatch):
    """The parent's program has no ``records``: each reader returns None."""
    from xpretrain_tpu_torch.utils import profiling

    from benchmark.metrics import _spans

    monkeypatch.delattr(profiling, "records")
    assert _spans.rest("xpt.step") is None
    for kind in ("train", "serve"):
        result = Result(1.0, 3, 1.0, [1.0] * 3, 0, 0, 0, rest_units=3)
        readings = run.Readings(kind, result, 1.0, {}, {})
        for name in SPAN_METRICS:
            assert run.metric_module(name).read(readings) is None
