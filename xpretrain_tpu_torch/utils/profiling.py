"""Spans at the port's layer boundaries, and an operation count
(``xpretrain_tpu/utils/profiling.py``).

- :func:`span`: a named host interval. Every span appends one record to an
  in-memory ring of its name (:func:`records`): its start and end on the
  profiler's host clock (Unix nanoseconds, as kineto stamps host events),
  the innermost span open on its thread, and whether a ``torch.profiler``
  was active. While one is, the span is also a host event of that name in
  the profile (a host-only record function: it adds nothing to the device
  rows), so a Chrome trace shows the ``xpt.*`` ranges on the host rows, on
  the kernels' clock. Under ``torch.export``, ``torch.compile`` and
  ``make_fx`` a span does nothing.
- :func:`flops_estimate`: the operations of one call, counted by
  ``torch.utils.flop_counter`` (GEMMs, convolutions, attention; forward and,
  when the call runs one, backward).

The spans, where they sit and what reads each are listed in PERF.md; the
training loop's op-class tables are ``train/profiling.py``'s.
"""

from __future__ import annotations

import collections
import contextlib
import threading
from time import time_ns
from typing import Callable, NamedTuple, Optional

import torch
from torch._C._autograd import _profiler_enabled
from torch._C._profiler import _RecordFunctionFast

# bound once: a span runs them on every call
_is_compiling = torch.compiler.is_compiling
_dispatch_modes = torch._C._len_torch_dispatch_stack

# records a name keeps: a 25 s benchmark window makes at most ~1,300 of one
# name, a training run far more, of which the newest stay
RING = 1 << 14


class Record(NamedTuple):
    name: str
    start_ns: int  # Unix ns, the clock of the profiler's host events
    end_ns: int
    parent: Optional[str]  # the innermost span open on the thread at the start
    profiled: bool  # a torch.profiler was active


class _Open(threading.local):
    def __init__(self):
        self.names: list[str] = []


_OPEN = _Open()
_RINGS: dict[str, collections.deque] = {}


class _Span:
    __slots__ = ("name", "parent", "mark", "start_ns")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self) -> None:
        names = _OPEN.names
        self.parent = names[-1] if names else None
        names.append(self.name)
        if _profiler_enabled():
            self.mark = _RecordFunctionFast(self.name)
            self.mark.__enter__()
        else:
            self.mark = None
        self.start_ns = time_ns()

    def __exit__(self, *exc) -> None:
        end_ns = time_ns()
        mark = self.mark
        if mark is not None:
            mark.__exit__(None, None, None)
        _OPEN.names.pop()
        ring = _RINGS.get(self.name)
        if ring is None:
            ring = _RINGS.setdefault(self.name, collections.deque(maxlen=RING))
        ring.append((self.name, self.start_ns, end_ns, self.parent, mark is not None))


def span(name: str):
    """Context manager: a span named ``name`` around the body (see the
    module's docstring); a null context while a graph tool traces (the cheap
    test of ``ops/_kernels.py:tracing``: dynamo compiles, or a fake or proxy
    mode is on the dispatch stack)."""
    if _is_compiling() or _dispatch_modes():
        return contextlib.nullcontext()
    return _Span(name)


def records(name: str) -> list[Record]:
    """The records of the spans named ``name`` that the ring still holds,
    oldest first."""
    return [Record(*r) for r in list(_RINGS.get(name, ()))]


def flops_estimate(fn: Callable, *args, **kwargs) -> float:
    """Operations of one ``fn(*args, **kwargs)`` call, as
    ``torch.utils.flop_counter`` counts them (0 if the call fails, as JAX's
    returns 0 where XLA has no cost analysis)."""
    from torch.utils.flop_counter import FlopCounterMode

    try:
        with FlopCounterMode(display=False) as counter:
            fn(*args, **kwargs)
        return float(counter.get_total_flops())
    except Exception:  # noqa: BLE001 - the estimate is optional, as in JAX
        return 0.0
