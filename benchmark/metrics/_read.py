"""What the readers share: shares of the card's peaks and of the device's
time, from a run's ``Readings`` (``run.py``)."""

from __future__ import annotations

from typing import Optional

from benchmark.frozen.roofline import PEAK_FLOPS


def host_ms(r, kind: str) -> Optional[float]:
    """Host ms a step that the driver timed itself, over the untraced units."""
    res = r.result
    if r.kind != kind or res.rest_units == 0:
        return None
    return 1e3 * res.rest_host_s / (res.rest_units * res.steps_per_unit)


def idle_pct(r, kind: str) -> Optional[float]:
    """The share of an untraced unit's wall time in which the device ran
    nothing: one minus the device's busy time a traced unit (the profiler
    slows the host, not the kernels) over the wall time an untraced unit."""
    t, res = r.result.trace, r.result
    if r.kind != kind or t is None or t.units == 0 or res.rest_units == 0:
        return None
    return 100.0 * (1.0 - (t.busy_s / t.units) / (res.rest_s / res.rest_units))


def mfu_pct(r, kind: str) -> Optional[float]:
    """Model FLOPs of the untraced units over their wall time, as a share
    of the bf16 dense peak."""
    res = r.result
    if r.kind != kind or res.rest_units == 0 or res.rest_s <= 0:
        return None
    return 100.0 * r.flops_per_unit * res.rest_units / (res.rest_s * PEAK_FLOPS)


def roofline_pct(r, kind: str, op: str) -> Optional[float]:
    """The least time of the op's traced launches over the device time of
    its kernels, found by their frozen op classes (``work``'s
    ``OP_KERNELS``: the first class launches once a call of the op)."""
    t = r.result.trace
    if r.kind != kind or t is None or op not in r.op_bounds:
        return None
    classes = {row["class"]: row for row in t.classes}
    names = r.op_kernels[op]
    if names[0] not in classes:
        return None
    launches = classes[names[0]]["launches_per_step"] * t.units
    device_s = sum(classes[n]["device_ms_per_step"] for n in names if n in classes) * t.units / 1e3
    per_step = r.op_bounds[op]  # the least time of each launch a step
    if device_s <= 0:
        return None
    return 100.0 * sum(per_step) * (launches / len(per_step)) / device_s


def peak_gib(r, kind: str) -> Optional[float]:
    """The most device memory the allocator held during the window: the
    allocations, and the private pool of a captured graph that replays."""
    if r.kind != kind or r.result.window_held_bytes <= 0:
        return None
    return r.result.window_held_bytes / 2**30


def class_ms(r, kind: str, op_class: str) -> Optional[float]:
    """Device ms a step of a frozen op class in the traced stretch."""
    t = r.result.trace
    if r.kind != kind or t is None:
        return None
    ms = next((row["device_ms_per_step"] for row in t.classes if row["class"] == op_class), None)
    return None if ms is None else ms / r.result.steps_per_unit
