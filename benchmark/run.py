"""Run one cell of ``BENCHMARK.json`` on this machine's card and print its
result as the last line of standard output.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. Everything the cell needs is found by name:
``workloads/<cell>.json`` (its configuration, driver, traffic parameters,
end-to-end statistics and correctness limits), ``configs/<config>.json``,
``programs/<config>.py`` (how the port is built), ``reference/<config>.py``,
``work/<config>.py``, ``traffic/<driver>.py`` and, in a traced run,
``metrics/<metric>.py`` for each per-layer metric that lists the cell.

With ``--trace 0`` the result's metrics are the cell's end-to-end metrics;
with ``--trace 1``, its per-layer metrics. Each run checks what its timed
path produced against the plain reference (``check.py``); the numbers
compared and their limits come last in the result and on standard error.
The run fails, printing no result, without the port, without as many CUDA
cards as the cell asks for, or if ``jax``, ``jaxlib``, ``flax`` or
``xpretrain_tpu`` were loaded in this process.
"""

from __future__ import annotations

import os
import time


def _process_start() -> float:
    """The host time (``time.perf_counter``'s clock) at which this process
    started, from ``/proc``; the import time of this module elsewhere."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as f:
            uptime = float(f.read().split()[0])
        return time.perf_counter() - (uptime - start_ticks / os.sysconf("SC_CLK_TCK"))
    except (OSError, ValueError, IndexError):
        return time.perf_counter()


T_START = _process_start()

import argparse  # noqa: E402
import dataclasses  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import re  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import ModuleType  # noqa: E402
from typing import Any, Optional  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
CACHE = ROOT / "build" / "benchmark"
PROGRAM = "xpretrain_tpu_torch"
FORBIDDEN = ("jax", "jaxlib", "flax", "xpretrain_tpu")
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def set_caches() -> None:
    """Every build and kernel cache at a fixed directory inside the checkout;
    keep libraries that could load JAX from doing so."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"), ("CUDA_CACHE_PATH", "nv")):
        os.environ[var] = str(CACHE / sub)
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def load_json(path: Path) -> Any:
    with open(path) as f:
        return json.load(f)


def load_spec() -> dict:
    return load_json(ROOT / "BENCHMARK.json")


def metric_module(name: str) -> ModuleType:
    """``metrics/<name>.py`` (a name may hold dots, so it is loaded by path)."""
    path = BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location(f"benchmark.metrics.{name.replace('.', '_')}", path)
    if spec is None or not path.exists():
        raise FileNotFoundError(f"no reader {path} for the per-layer metric {name!r}")
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def cell_metrics(spec: dict, cell: str) -> tuple[list[dict], list[dict]]:
    """(end-to-end, per-layer) entries of ``spec`` that ``cell`` reports."""
    e2e = [m for m in spec["end_to_end"] if cell in m.get("workloads", [cell])]
    names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"]
                 if cell in m.get("workloads", [cell] if m["moves"] in names else [])]
    return e2e, per_layer


def validate(spec: dict) -> None:
    """Raise ValueError where ``spec`` and the files it names disagree: a
    missing file, a bad name, a cell that reports no per-layer metric or
    not ``setup_s``, a metric that lists a cell that does not report what
    it moves, or a reader whose layer or ``moves`` differs."""
    cells = {w["name"]: w for w in spec["workloads"]}
    e2e_names = {m["name"] for m in spec["end_to_end"]}
    for name in [*cells, *(m["name"] for m in spec["end_to_end"] + spec["per_layer"]),
                 *(c["name"] for c in spec["configs"])]:
        if not NAME.match(name):
            raise ValueError(f"bad name {name!r}")
    if "setup_s" not in e2e_names:
        raise ValueError("every benchmark reports setup_s")
    for c in spec["configs"]:
        if not (ROOT / c["file"]).exists():
            raise ValueError(f"config {c['name']}: no file {c['file']}")
        for kind in ("programs", "reference", "work"):
            if not (BENCH / kind / f"{c['name']}.py").exists():
                raise ValueError(f"config {c['name']}: no {kind}/{c['name']}.py")
    for name, entry in cells.items():
        path = BENCH / "workloads" / f"{name}.json"
        if not path.exists():
            raise ValueError(f"cell {name}: no {path.relative_to(ROOT)}")
        wl = load_json(path)
        if (wl["config"], wl["traffic"], wl["chips"]) != (entry["config"], entry["traffic"], entry["chips"]):
            raise ValueError(f"cell {name}: its file and BENCHMARK.json disagree on config, traffic or chips")
        if not (BENCH / "traffic" / f"{wl['driver']}.py").exists():
            raise ValueError(f"cell {name}: no driver traffic/{wl['driver']}.py")
        e2e, per_layer = cell_metrics(spec, name)
        reported = {m["name"] for m in e2e}
        if reported - {"setup_s"} != set(wl["end_to_end"]):
            raise ValueError(f"cell {name}: BENCHMARK.json gives it {sorted(reported)}, its file "
                             f"{sorted(wl['end_to_end'])} besides setup_s")
        if not per_layer:
            raise ValueError(f"cell {name} reports no per-layer metric")
    for m in spec["per_layer"]:
        if "workloads" not in m:
            raise ValueError(f"per-layer metric {m['name']} lists no cells")
        for cell in m["workloads"]:
            if cell not in cells:
                raise ValueError(f"per-layer metric {m['name']} lists the unknown cell {cell!r}")
            if m["moves"] not in {e["name"] for e in cell_metrics(spec, cell)[0]}:
                raise ValueError(f"per-layer metric {m['name']} lists {cell}, which does not report {m['moves']}")
        reader = metric_module(m["name"])
        if (reader.LAYER, reader.MOVES) != (m["layer"], m["moves"]):
            raise ValueError(f"metrics/{m['name']}.py reads layer {reader.LAYER!r} moving {reader.MOVES!r}; "
                             f"BENCHMARK.json says {m['layer']!r} moving {m['moves']!r}")


@dataclasses.dataclass
class Cell:
    """What a driver needs to run one cell."""

    name: str
    kind: str  # "train" or "serve"
    cfg: dict
    params: dict
    seed: int
    seconds: float
    trace: bool
    device: str
    program: ModuleType
    reference: ModuleType
    work: ModuleType
    out_dir: str
    t_start: float

    def free_device(self) -> None:
        import gc

        import torch

        gc.collect()
        if torch.device(self.device).type == "cuda":
            torch.cuda.synchronize()
            torch.cuda.empty_cache()


@dataclasses.dataclass
class Readings:
    """What the per-layer readers read (``metrics/*.py``)."""

    kind: str
    result: Any  # timing.Result
    flops_per_unit: float
    op_bounds: dict  # op -> least seconds of each of its launches in one step
    op_kernels: dict  # op -> the frozen op classes of its kernels


def _module(kind: str, name: str) -> ModuleType:
    return importlib.import_module(f"benchmark.{kind}.{name}")


def execute(workload: str, seed: int, seconds: float, trace: bool, device: str = "cuda",
            wl: Optional[dict] = None, cfg: Optional[dict] = None, spec: Optional[dict] = None,
            program: Optional[ModuleType] = None, t_start: float = T_START) -> dict:
    """Run ``workload`` and return its result line as a dict. ``wl``,
    ``cfg``, ``spec`` and ``program`` replace what the files say (tests
    run a cell at a small size on the CPU through them)."""
    spec = spec or load_spec()
    wl = wl or load_json(BENCH / "workloads" / f"{workload}.json")
    cfg = cfg or load_json(BENCH / "configs" / f"{wl['config']}.json")
    work = _module("work", wl["config"])
    cell = Cell(workload, wl["kind"], cfg, wl["params"], int(seed), float(seconds), bool(trace), device,
                program or _module("programs", wl["config"]), _module("reference", wl["config"]), work,
                str(CACHE / "out" / workload), t_start)
    result = _module("traffic", wl["driver"]).run(cell)

    e2e, per_layer = cell_metrics(spec, workload)
    metrics: dict[str, dict] = {}
    if not trace:
        stats = {"rate": result.units * result.work_per_step / result.window_s,
                 "p95_ms": _p95([t / result.steps_per_unit for t in result.unit_ms]), "setup_s": result.setup_s}
        for m in e2e:
            stat = "setup_s" if m["name"] == "setup_s" else wl["end_to_end"][m["name"]]
            metrics[m["name"]] = {"value": stats[stat], "unit": m["unit"]}
    else:
        p = wl["params"]
        flops = work.model_flops(cfg, wl["kind"], p["batch"], p["seq"]) * result.steps_per_unit
        readings = Readings(wl["kind"], result, flops, work.op_bounds(cfg, wl["kind"], p["batch"]), work.OP_KERNELS)
        for m in per_layer:
            value = metric_module(m["name"]).read(readings)
            if value is None:
                print(f"per-layer metric {m['name']}: nothing to read in this run", file=sys.stderr)
            else:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}

    limits = wl["limits"]
    compared = {k: {"value": v, "limit": limits[k]} for k, v in result.numbers.items()}
    correct = bool(compared) and all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
                                     for c in compared.values())
    line: dict[str, Any] = {"correct": correct, "attempted": result.units * result.steps_per_unit, "failed": 0,
                            "metrics": metrics, "device": _device(device, wl["chips"], result)}
    if trace and result.trace is not None:
        line["breakdown"] = _breakdown(result.trace)
    line["compared"] = compared
    return line


def _p95(values: list[float]) -> float:
    import numpy as np

    return float(np.percentile(np.asarray(values), 95))


def _device(device: str, chips: int, result) -> dict:
    import torch

    cuda = torch.device(device).type == "cuda"
    out = {"platform": "gpu" if cuda else "cpu",
           "kind": torch.cuda.get_device_name(0) if cuda else "cpu",
           "count": chips,
           "memory_peak_bytes": max(result.setup_peak_bytes, result.window_peak_bytes)}
    if result.trace is not None:
        out["busy_s"] = result.trace.busy_s
        out["window_s"] = result.trace.window_s
    return out


def _breakdown(t) -> dict:
    """The device's largest op classes and kernels, and its longest idle
    gaps by the host event in flight, in seconds over the traced stretch."""
    classes = [[f"class: {r['class']}", r["device_ms_per_step"] * t.units / 1e3] for r in t.classes[:5]]
    kernels = [[f"kernel: {name[:96]}", s] for name, s in t.top_kernels[:5]]
    return {"device_ops": classes + kernels, "idle_gaps": [[name, s] for name, s in t.idle_gaps]}


def power_limit() -> str:
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                             capture_output=True, text=True, timeout=30)
        return out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return "unknown"


def loaded_forbidden() -> list[str]:
    """Modules of this process whose top-level name is one of :data:`FORBIDDEN`."""
    return sorted({m for m in list(sys.modules) if m.split(".", 1)[0] in FORBIDDEN})


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)
    set_caches()
    spec = load_spec()
    entry = next((w for w in spec["workloads"] if w["name"] == args.workload), None)
    if entry is None:
        print(f"no cell {args.workload!r} in BENCHMARK.json", file=sys.stderr)
        return 2
    if importlib.util.find_spec(PROGRAM) is None:
        print(f"the program {PROGRAM} is not in this checkout", file=sys.stderr)
        return 1
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < entry["chips"]:
        print(f"cell {args.workload} needs {entry['chips']} CUDA card(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 1
    line = execute(args.workload, args.seed, args.seconds, bool(args.trace), spec=spec)
    found = loaded_forbidden()
    if found:
        print(f"this process loaded {found}: the benchmark measures the port alone", file=sys.stderr)
        return 3
    print(f"card: {power_limit()}", file=sys.stderr)
    for name, c in line["compared"].items():
        print(f"compared {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
