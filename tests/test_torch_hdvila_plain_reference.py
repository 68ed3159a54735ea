"""HD-VILA stage 1 against its plain float32 reference
(``benchmark/reference/hdvila_stage1.py``), through the benchmark cell
``hdvila_stage1.pretrain`` at a small size on the CPU, and the encoder's
spans (``xpt.hdvila.*``) in an eager step and under ``make_fx``."""

from __future__ import annotations

import operator
import time

import pytest
import torch

from benchmark import faults, run
from benchmark.programs import hdvila_stage1 as program
from benchmark.reference import hdvila_stage1 as reference
from benchmark.tests import tiny_hdvila
from benchmark.traffic.batches import pool
from benchmark.weights import make_weights
from xpretrain_tpu_torch.parallel.train_step import batch_to_device
from xpretrain_tpu_torch.utils.profiling import records

SEED = 2**31 + 99
SPANS = ("xpt.hdvila.cnn", "xpt.hdvila.cnn_low", "xpt.hdvila.timesformer")


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    """Two intra-op threads: beside the other test processes, torch's
    all-cores default oversubscribes the CPU many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _run(program_module=program):
    wl, cfg = tiny_hdvila.hdvila()
    return run.execute(tiny_hdvila.CELL, SEED, 0.3, False, device="cpu", wl=wl, cfg=cfg, program=program_module)


def test_reference_agrees_with_the_port_in_fp32():
    """fp32 on both sides: every gap is rounding (the cell's limits are for
    bf16 and sit orders of magnitude above)."""
    line = _run()
    assert line["correct"]
    assert set(line["compared"]) == {"loss_gap", "grad_gap", "change_gap", "grad_gap_median"}
    for name, c in line["compared"].items():
        assert c["value"] < 1e-4, (name, c)


def test_first_gradients_agree_element_by_element_in_fp32():
    """The worst leaf's element-wise gap of the first gradient (``grad_diff``,
    which the cell does not compare: in bf16 its readings have no fault or
    control far enough above them) is rounding in fp32."""
    from benchmark import controls

    wl, cfg = tiny_hdvila.hdvila()
    wl["params"]["grad_elements"] = True
    numbers = controls.train_numbers(controls.cell_for(tiny_hdvila.CELL, SEED, "cpu", wl, cfg))
    assert numbers["grad_diff"] < 1e-4, numbers


@pytest.mark.parametrize("fault", sorted(faults.FAULTS["train"]))
def test_a_planted_fault_is_not_correct(fault):
    line = _run(faults.FAULTS["train"][fault](program))
    assert not line["correct"], line["compared"]


def _tiny_trainer(out_dir):
    wl, cfg = tiny_hdvila.hdvila()
    params = {**wl["params"], "steps_per_call": 1}
    weights = make_weights(reference.leaves(cfg), SEED, "cpu")
    trainer, state = program.build_trainer(cfg, params, weights, "cpu", str(out_dir))
    return trainer, state, pool(params, SEED, "cpu")[0]


def test_eager_step_records_each_encoder_span_once_inside_the_forward(tmp_path):
    trainer, state, batch = _tiny_trainer(tmp_path)
    t0 = time.time_ns()
    trainer.train_step(state, trainer.place_batch(batch), 7)
    since = lambda name: [r for r in records(name) if r.start_ns >= t0]  # noqa: E731
    (forward,) = since("xpt.step.forward")
    spans = [since(name) for name in SPANS]
    assert all(len(s) == 1 for s in spans), [len(s) for s in spans]
    (cnn,), (cnn_low,), (tsf,) = spans
    assert all(s.parent == "xpt.step.forward" for s in (cnn, cnn_low, tsf))
    assert forward.start_ns <= cnn.start_ns <= cnn.end_ns <= cnn_low.start_ns <= cnn_low.end_ns
    assert cnn_low.end_ns <= tsf.start_ns <= tsf.end_ns <= forward.end_ns


@pytest.mark.parametrize("given,spans", [("middle", ("xpt.hdvila.cnn", "xpt.hdvila.timesformer")),
                                         ("other", ("xpt.hdvila.cnn_low", "xpt.hdvila.timesformer"))])
def test_one_input_encoders_record_their_spans(tmp_path, given, spans):
    trainer, _, batch = _tiny_trainer(tmp_path)
    placed = batch_to_device("cpu")(batch)
    t0 = time.time_ns()
    with torch.no_grad():
        trainer.model.encoder.extract_features(placed["img_middle"] if given == "middle" else None,
                                               placed["img_other"] if given == "other" else None)
    counts = {name: len([r for r in records(name) if r.start_ns >= t0]) for name in SPANS}
    assert counts == {name: int(name in spans) for name in SPANS}


def test_encoder_under_make_fx_records_no_span_and_leaves_none_in_the_graph(tmp_path):
    from torch.fx.experimental.proxy_tensor import make_fx

    trainer, _, batch = _tiny_trainer(tmp_path)
    placed = batch_to_device("cpu")(batch)
    encoder = trainer.model.encoder
    before = [len(records(name)) for name in SPANS]
    graph = make_fx(lambda mid, other: encoder.extract_features(mid, other)[1])(placed["img_middle"],
                                                                                placed["img_other"]).graph
    assert [len(records(name)) for name in SPANS] == before
    targets = {n.target for n in graph.nodes if n.op == "call_function"}
    others = {t for t in targets if not isinstance(t, torch._ops.OpOverload) or t.namespace != "aten"}
    assert torch.ops.aten.convolution.default in targets and others <= {operator.getitem}, others
