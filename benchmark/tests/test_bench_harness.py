"""The harness finds its files by name, validates BENCHMARK.json against
them, prints the contract's result line, and refuses to run where it must."""

from __future__ import annotations

import copy
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import pytest

from benchmark import run
from benchmark.tests import tiny

ROOT = Path(run.__file__).resolve().parents[1]
LINE_KEYS = {"correct", "attempted", "failed", "metrics", "device"}


def test_benchmark_json_and_its_files_agree():
    spec = run.load_spec()
    run.validate(spec)
    for cell in spec["workloads"]:
        e2e, per_layer = run.cell_metrics(spec, cell["name"])
        assert "setup_s" in {m["name"] for m in e2e} and len(e2e) >= 2 and per_layer


@pytest.mark.parametrize("breakage", ["no_workloads_key", "cell_lacks_moved_metric", "reader_moves_other",
                                      "cell_without_per_layer", "missing_workload_file", "bad_name"])
def test_validate_rejects(breakage):
    spec = copy.deepcopy(run.load_spec())
    train = next(m for m in spec["per_layer"] if m["name"] == "mfu.train")
    if breakage == "no_workloads_key":
        del train["workloads"]
    elif breakage == "cell_lacks_moved_metric":
        train["workloads"].append("lfvila_stage1.index")
    elif breakage == "reader_moves_other":
        train["moves"] = "train_step_p95_ms"
    elif breakage == "cell_without_per_layer":
        for m in spec["per_layer"]:
            m["workloads"] = [w for w in m["workloads"] if w != "lfvila_stage1.index"]
        spec["per_layer"] = [m for m in spec["per_layer"] if m["workloads"]]
    elif breakage == "missing_workload_file":
        spec["workloads"].append({**spec["workloads"][0], "name": "clipvip_b32.nothing"})
    else:
        train["name"] = "mfu train"
    with pytest.raises((ValueError, FileNotFoundError)):
        run.validate(spec)


def test_metric_readers_found_by_name():
    for m in run.load_spec()["per_layer"]:
        reader = run.metric_module(m["name"])
        assert (reader.LAYER, reader.MOVES) == (m["layer"], m["moves"])
    with pytest.raises(FileNotFoundError):
        run.metric_module("no_such.metric")


@pytest.mark.parametrize("trace", [False, True])
@pytest.mark.parametrize("cell", ["clipvip_b32.train_graphed", "lfvila_stage1.index"])
def test_result_line_has_the_contract_keys(cell, trace):
    wl, cfg = (tiny.clipvip if cell.startswith("clipvip") else tiny.lfvila)(cell)
    line = run.execute(cell, 2**31 + 12345, 0.5, trace, device="cpu", wl=wl, cfg=cfg)
    keys = list(line)
    assert set(keys) - {"breakdown", "compared"} == LINE_KEYS
    assert keys[-1] == "compared" and ("breakdown" in keys) == trace
    assert set(line["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    assert line["correct"] is True and line["failed"] == 0 and line["attempted"] > 0
    assert all(set(c) == {"value", "limit"} for c in line["compared"].values())
    if not trace:
        spec = run.load_spec()
        want = {m["name"] for m in run.cell_metrics(spec, cell)[0]}
        assert set(line["metrics"]) == want
    json.dumps(line)


def test_run_without_a_card_prints_no_result(capsys):
    import torch

    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    assert run.main(["--workload", "clipvip_b32.train_graphed", "--seed", "1", "--seconds", "1", "--trace", "0"]) != 0
    assert capsys.readouterr().out == ""


def test_run_without_the_program_fails(tmp_path):
    shutil.copytree(ROOT / "benchmark", tmp_path / "benchmark", ignore=shutil.ignore_patterns("__pycache__"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    proc = subprocess.run([sys.executable, "-m", "benchmark.run", "--workload", "clipvip_b32.train_graphed", "--seed", "1",
                           "--seconds", "1", "--trace", "0"], cwd=tmp_path, capture_output=True, text=True,
                          env=env, timeout=120)
    assert proc.returncode != 0 and proc.stdout == ""


def test_seeds_give_the_same_sizes():
    from benchmark.traffic.batches import pool

    wl, _ = tiny.clipvip("clipvip_b32.train_graphed")
    a, b = pool(wl["params"], 1, "cpu"), pool(wl["params"], 2**31 + 7, "cpu")
    assert [{k: v.shape for k, v in x.items()} for x in a] == [{k: v.shape for k, v in x.items()} for x in b]
    assert not (a[0]["video"] == b[0]["video"]).all()
    again = pool(wl["params"], 1, "cpu")
    assert all((x[k] == y[k]).all() for x, y in zip(a, again) for k in x)
