"""Share (%) of an untraced step's wall time in which the device ran nothing (busy time from the traced steps)."""

from benchmark.metrics import _read

LAYER = "train step"
MOVES = "train_clips_per_s"


def read(r):
    return _read.idle_pct(r, "train")
