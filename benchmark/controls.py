"""The readings each cell's limits are set from, taken on the card at the
cell's own size, in one process per cell:

- the program's numbers on ``--seeds`` seeds (the lower reading);
- on ``--control_seeds`` seeds, the control's: for training the plain
  reference computed in float8 e4m3 in the program's place, for indexing
  the program's own int8 serving path; and each fault of ``faults.py`` the
  cell can have, planted under the timed path (the upper readings).

Training readings need no window (the first steps give them); indexing
serves each batch of the pool ``--calls`` times. The benchmark's runs do not
run this.

    python3 -m benchmark.controls --workload <cell> --seeds 12 --control_seeds 3 --out <file.json>
"""

from __future__ import annotations

import argparse
import importlib
import json
import sys
import time

import torch

from benchmark import check, faults, run
from benchmark.traffic import index as index_driver
from benchmark.traffic import train_step as train_driver
from benchmark.traffic.batches import pool as make_pool
from benchmark.weights import make_weights


def cell_for(workload: str, seed: int, device: str = "cuda", wl=None, cfg=None, program=None) -> run.Cell:
    wl = wl or run.load_json(run.BENCH / "workloads" / f"{workload}.json")
    cfg = cfg or run.load_json(run.BENCH / "configs" / f"{wl['config']}.json")
    mod = lambda kind: importlib.import_module(f"benchmark.{kind}.{wl['config']}")  # noqa: E731
    return run.Cell(workload, wl["kind"], cfg, wl["params"], int(seed), 0.0, False, device,
                    program or mod("programs"), mod("reference"), mod("work"),
                    str(run.CACHE / "out" / workload), time.perf_counter())


def _program_readings(cell: run.Cell, batches: list[dict]) -> dict:
    weights = make_weights(cell.reference.leaves(cell.cfg, cell.kind), cell.seed, cell.device)
    trainer, state = cell.program.build_trainer(cell.cfg, cell.params, weights, cell.device, cell.out_dir)
    del weights
    readings = train_driver.first_steps(cell, trainer, state, batches)
    del trainer, state
    cell.free_device()
    return readings


def train_numbers(cell: run.Cell, details: bool = False) -> dict:
    """The program's numbers, as a run computes them (and what they come from)."""
    batches = make_pool(cell.params, cell.seed, cell.device)[: cell.params["check_steps"]]
    prog = _program_readings(cell, batches)
    ref = train_driver.reference_readings(cell, batches)
    out = check.train_numbers(prog, ref)
    return {**out, "details": check.train_details(prog, ref)} if details else out


def train_control_numbers(cell: run.Cell, details: bool = False) -> dict:
    """The float8 reference's numbers, held to the float32 reference."""
    batches = make_pool(cell.params, cell.seed, cell.device)[: cell.params["check_steps"]]
    low = train_driver.reference_readings(cell, batches, "fp8")
    cell.free_device()
    ref = train_driver.reference_readings(cell, batches)
    out = check.train_numbers(low, ref)
    return {**out, "details": check.train_details(low, ref)} if details else out


def _served(cell: run.Cell, calls: int) -> tuple[list, list]:
    batches = make_pool(cell.params, cell.seed, cell.device)
    weights = make_weights(cell.reference.leaves(cell.cfg, cell.kind), cell.seed, cell.device)
    towers = cell.program.build_towers(cell.cfg, cell.params, weights, cell.device)
    del weights
    served = [(k, cell.program.serve(towers, b)) for _ in range(calls) for k, b in enumerate(batches)]
    del towers
    cell.free_device()
    ref = index_driver.reference_features(cell, batches)
    return [feats for _, feats in served], [ref[k] for k, _ in served]


def serve_numbers(cell: run.Cell, calls: int = 2, details: bool = False) -> dict:
    prog, ref = _served(cell, calls)
    out = check.feature_numbers(prog, ref)
    return {**out, "details": check.feature_details(prog, ref)} if details else out


def serve_control_numbers(cell: run.Cell, calls: int = 1, details: bool = False) -> dict:
    """The program's numbers with its int8 serving path switched on."""
    with cell.program.lower_precision():
        return serve_numbers(cell, calls, details)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", type=int, default=12)
    parser.add_argument("--control_seeds", type=int, default=3)
    parser.add_argument("--first_seed", type=int, default=2**31 + 1000)
    parser.add_argument("--calls", type=int, default=2)
    parser.add_argument("--out", default="")
    args = parser.parse_args(argv)
    run.set_caches()
    if not torch.cuda.is_available():
        print("the control readings are taken on a card", file=sys.stderr)
        return 1
    out = {"workload": args.workload, "card": run.power_limit(), "program": [], "control": [], "faults": {}}
    seeds = [args.first_seed + 7 * i for i in range(args.seeds)]
    kind = cell_for(args.workload, 0).kind
    for seed in seeds:
        cell = cell_for(args.workload, seed)
        numbers = train_numbers(cell, True) if kind == "train" else serve_numbers(cell, args.calls, True)
        out["program"].append({"seed": seed, **numbers})
        print("program", seed, numbers, flush=True)
    for seed in seeds[: args.control_seeds]:
        cell = cell_for(args.workload, seed)
        numbers = train_control_numbers(cell, True) if kind == "train" else serve_control_numbers(cell, 1, True)
        out["control"].append({"seed": seed, **numbers})
        print("control", seed, numbers, flush=True)
        for name, plant in faults.FAULTS[kind].items():
            broken = cell_for(args.workload, seed, program=plant(cell.program))
            numbers = train_numbers(broken) if kind == "train" else serve_numbers(broken, 1)
            out["faults"].setdefault(name, []).append({"seed": seed, **numbers})
            print("fault", name, seed, numbers, flush=True)
    print(json.dumps(out))
    if args.out:
        with open(args.out, "w") as f:
            json.dump(out, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
