"""What decides ``correct``: the reference agrees with the port at a small
size on the CPU; each fault a cell can have, planted under the timed path,
and the control in the program's place, come out not correct."""

from __future__ import annotations

import importlib

import pytest

from benchmark import faults, run
from benchmark.tests import tiny

CELLS = {"clipvip_b32.train_graphed": tiny.clipvip, "lfvila_stage1.pretrain": tiny.lfvila,
         "lfvila_stage1.index": tiny.lfvila}
SEED = 2**31 + 99


def _run(cell, program=None, trace=False):
    wl, cfg = CELLS[cell](cell)
    return run.execute(cell, SEED, 0.3, trace, device="cpu", wl=wl, cfg=cfg, program=program)


@pytest.mark.parametrize("cell", sorted(CELLS))
def test_reference_agrees_with_the_port_in_fp32(cell):
    """fp32 on both sides: every gap is rounding (the cells' own limits are
    for bf16 and sit orders of magnitude above)."""
    line = _run(cell)
    assert line["correct"]
    for name, c in line["compared"].items():
        assert c["value"] < 1e-4, (name, c)


@pytest.mark.parametrize("cell,fault", [(c, f) for c in sorted(CELLS)
                                        for f in faults.FAULTS[tiny.load("workloads", c)["kind"]]])
def test_a_planted_fault_is_not_correct(cell, fault):
    wl, _ = CELLS[cell](cell)
    program = importlib.import_module(f"benchmark.programs.{wl['config']}")
    line = _run(cell, faults.FAULTS[wl["kind"]][fault](program))
    assert not line["correct"], line["compared"]


@pytest.mark.parametrize("cell", ["clipvip_b32.train_graphed", "lfvila_stage1.pretrain"])
def test_the_fp8_control_is_not_correct(cell):
    """The reference computed in float8 e4m3 in the program's place, held to
    the float32 reference by the cell's limits."""
    from benchmark import controls

    wl, cfg = CELLS[cell](cell)
    numbers = controls.train_control_numbers(controls.cell_for(cell, SEED, "cpu", wl, cfg))
    limits = wl["limits"]
    assert any(numbers[k] > limits[k] for k in limits), numbers


@pytest.mark.parametrize("cell", ["lfvila_stage1.index"])
def test_the_int8_control_is_not_correct(cell, monkeypatch):
    """The program's own int8 serving path, at thresholds scaled to the
    small widths (the cell's own quantizes every layer of 256 and more)."""
    from xpretrain_tpu_torch.ops import quant

    from benchmark import controls

    wl, cfg = CELLS[cell](cell)
    program = importlib.import_module(f"benchmark.programs.{wl['config']}")
    monkeypatch.setattr(program, "lower_precision", lambda: quant.int8_serving(min_in_features=16, min_features=16))
    numbers = controls.serve_control_numbers(controls.cell_for(cell, SEED, "cpu", wl, cfg))
    assert numbers["feature_gap"] > wl["limits"]["feature_gap"], numbers
