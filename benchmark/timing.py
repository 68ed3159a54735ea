"""The measured window, shared by the drivers.

``--trace 0``: after a synchronize, units (steps or calls) run back to back
until ``--seconds`` of host time have passed; the window ends on a
synchronize. A marker is recorded on the stream after every unit (a CUDA
event; the host clock on the CPU), so each unit's time is the distance
between two markers, read after the window without another synchronize.

``--trace 1``: the window opens with ``trace_steps`` units under
``torch.profiler`` inside the ``bench::window`` annotation, summarised in
memory; the rest of the window runs untraced and gives the rates that the
per-layer metrics divide by.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import torch

from benchmark.trace import WINDOW, TraceSummary, summarize


@dataclasses.dataclass
class Result:
    setup_s: float
    units: int  # steps or calls in the window
    window_s: float  # its host wall time, to the closing synchronize
    unit_ms: list[float]  # each unit's time between markers
    setup_peak_bytes: int  # allocated
    window_peak_bytes: int
    window_held_bytes: int  # reserved by the caching allocator, a captured graph's pool included
    trace: Optional[TraceSummary] = None
    rest_units: int = 0  # untraced units after the traced stretch
    rest_s: float = 0.0
    rest_host_s: float = 0.0  # host seconds the driver timed inside them
    numbers: dict = dataclasses.field(default_factory=dict)
    work_per_step: int = 0  # clips a unit
    steps_per_unit: int = 1  # train steps a unit (a call of steps_per_call steps)


class Window:
    """Runs ``one(i)`` for a cell's window. ``host_s`` is a one-element list
    the driver adds its own host-timed seconds to (``place_batch``)."""

    def __init__(self, cell, one: Callable[[int], None], trace_steps: int, host_s: list[float]):
        self.cell, self.one, self.trace_steps, self.host_s = cell, one, trace_steps, host_s
        self.cuda = torch.device(cell.device).type == "cuda"

    def _sync(self) -> None:
        if self.cuda:
            torch.cuda.synchronize()

    def _mark(self):
        if not self.cuda:
            return time.perf_counter()
        e = torch.cuda.Event(enable_timing=True)
        e.record()
        return e

    def _ms(self, a, b) -> float:
        return a.elapsed_time(b) if self.cuda else (b - a) * 1e3

    def run(self) -> Result:
        cell = self.cell
        self._sync()
        setup_peak = torch.cuda.max_memory_allocated() if self.cuda else 0
        if self.cuda:
            torch.cuda.reset_peak_memory_stats()
        setup_s = time.perf_counter() - cell.t_start
        t0 = time.perf_counter()
        n, prof = 0, None
        if cell.trace:
            prof, n = self._traced(), self.trace_steps
        self.host_s[0] = 0.0
        t_rest = time.perf_counter()
        marks = [self._mark()]
        while time.perf_counter() - t0 < cell.seconds:
            self.one(n)
            n += 1
            marks.append(self._mark())
        self._sync()
        t1 = time.perf_counter()
        window_peak = torch.cuda.max_memory_allocated() if self.cuda else 0
        held = torch.cuda.max_memory_reserved() if self.cuda else 0
        unit_ms = [self._ms(a, b) for a, b in zip(marks, marks[1:])]
        trace = None if prof is None else summarize(prof, self.trace_steps)
        return Result(setup_s, n, t1 - t0, unit_ms, setup_peak, window_peak, held, trace, len(unit_ms),
                      t1 - t_rest, self.host_s[0])

    def _traced(self) -> torch.profiler.profile:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.cuda:
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        with torch.profiler.profile(activities=acts) as prof:
            with torch.profiler.record_function(WINDOW):
                for i in range(self.trace_steps):
                    self.one(i)
                self._sync()
        return prof
