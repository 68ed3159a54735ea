"""Share (%) of an untraced call's wall time in which the device ran nothing (busy time from the traced calls)."""

from benchmark.metrics import _read

LAYER = "serving towers"
MOVES = "serve_clips_per_s"


def read(r):
    return _read.idle_pct(r, "serve")
