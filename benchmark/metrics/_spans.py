"""What the readers of the program's spans share: host time inside a span
of ``xpretrain_tpu_torch/utils/profiling.py`` over the untraced units of a
run. A span's records made after its last one made under the profiler are
those of the untraced rest of the window, the units that ``Result``'s
``rest_units`` counts (the reference after the window is the benchmark's own
code, which makes no span). A program without the spans reads nothing."""

from __future__ import annotations

from typing import Optional


def rest(name: str) -> Optional[list]:
    """The records of the span ``name`` in the untraced rest of the window;
    None where the program keeps none, or its ring no longer reaches back to
    the traced stretch."""
    try:
        from xpretrain_tpu_torch.utils import profiling
    except ImportError:
        return None
    read = getattr(profiling, "records", None)
    if read is None:
        return None
    recs = read(name)
    last = max((i for i, r in enumerate(recs) if r.profiled), default=None)
    return None if last is None else recs[last + 1:]


def ms(records: list) -> float:
    return sum(r.end_ns - r.start_ns for r in records) / 1e6


def per_step(r, kind: str, name: str) -> Optional[float]:
    """Host ms inside ``name`` a train step (a call in serving) over the
    untraced units."""
    res = r.result
    if r.kind != kind or res.rest_units == 0:
        return None
    recs = rest(name)
    if not recs:
        return None
    return ms(recs) / (res.rest_units * res.steps_per_unit)


def serve_self(r) -> Optional[float]:
    """Host ms a call in the self time of the two encode spans: each minus
    the uploads it holds."""
    res = r.result
    if r.kind != "serve" or res.rest_units == 0:
        return None
    encodes = {name: rest(name) for name in ("xpt.serve.encode_video", "xpt.serve.encode_text")}
    uploads = rest("xpt.serve.upload")
    if not all(encodes.values()) or uploads is None:
        return None
    inner = [u for u in uploads if u.parent in encodes]
    return (sum(ms(recs) for recs in encodes.values()) - ms(inner)) / res.rest_units
