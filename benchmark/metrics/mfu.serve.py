"""Model FLOPs of the untraced calls over their wall time, as a share (%) of the bf16 dense peak."""

from benchmark.metrics import _read

LAYER = "serving towers"
MOVES = "serve_clips_per_s"


def read(r):
    return _read.mfu_pct(r, "serve")
