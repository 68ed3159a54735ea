"""Reading a ``torch.profiler`` trace of a bounded stretch of the window.

The stretch is the benchmark's own ``bench::window`` annotation. From the
profiler's events (kept in memory, never written out) this takes:

- busy time: the union of the device's kernels, copies and sets inside the
  stretch, and the stretch's length;
- the device time and launches by the frozen op classes (the kernels of
  each ``xpt::`` op have classes of their own, which also find them inside
  a replayed CUDA graph, where no host op frames them), and the largest
  kernels;
- the longest idle gaps of the device, each named by the innermost host
  event of the stepping thread in flight when it began.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

from benchmark.frozen.profiling import key_average_rows, op_class_table

WINDOW = "bench::window"


@dataclasses.dataclass
class TraceSummary:
    units: int  # steps or calls inside the stretch
    window_s: float
    busy_s: float
    classes: list[dict]  # op_class_table rows, per unit
    top_kernels: list[tuple[str, float]]  # (name, seconds in the stretch)
    idle_gaps: list[tuple[str, float]]  # (host event, seconds)


def _is_device(e) -> bool:
    """A kernel, copy or set on the device (an annotation's device-side
    copy spans the whole stretch and is none of them)."""
    return "CPU" not in str(e.device_type()) and e.name() != WINDOW


def _union(intervals: list[tuple[int, int]]) -> list[tuple[int, int]]:
    merged: list[list[int]] = []
    for s, e in sorted(intervals):
        if merged and s <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], e)
        else:
            merged.append([s, e])
    return [(s, e) for s, e in merged]


def summarize(prof, units: int) -> Optional[TraceSummary]:
    """The summary of the stretch ``prof`` traced, or None if it holds no
    ``bench::window`` annotation."""
    events = list(prof.profiler.kineto_results.events())
    marks = [e for e in events if e.name() == WINDOW and "CPU" in str(e.device_type())]
    if not marks:
        return None
    w0, w1 = marks[0].start_ns(), marks[0].end_ns()
    stepper = marks[0].start_thread_id()
    device = [e for e in events if _is_device(e)]
    host = [e for e in events if not _is_device(e) and e.name() != WINDOW]
    clipped = [(max(e.start_ns(), w0), min(e.end_ns(), w1)) for e in device]
    busy = _union([(s, e) for s, e in clipped if e > s])
    busy_ns = sum(e - s for s, e in busy)

    rows = [r for r in key_average_rows(prof) if r["name"] != WINDOW]
    kernels = sorted(((r["name"], r["self_device_us"] / 1e6) for r in rows if r["device_type"] == "CUDA"),
                     key=lambda kv: -kv[1])

    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    spans = sorted(((e - s, s) for s, e in zip(edges[0::2], edges[1::2]) if e > s), reverse=True)[:10]
    stepping = [h for h in host if h.start_thread_id() == stepper]
    gaps = []
    for length, s in spans:
        covering = [h for h in stepping if h.start_ns() <= s < h.end_ns()]
        name = max(covering, key=lambda h: h.start_ns()).name() if covering else "(host between ops)"
        gaps.append((name, length / 1e9))
    return TraceSummary(units, (w1 - w0) / 1e9, busy_ns / 1e9, op_class_table(rows, max(units, 1)),
                        kernels[:10], gaps)
