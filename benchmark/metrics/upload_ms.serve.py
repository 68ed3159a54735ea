"""Host ms per untraced call inside the spans ``xpt.serve.upload`` (the towers' copies of their inputs to the device)."""

from benchmark.metrics import _spans

LAYER = "serving towers"
MOVES = "serve_clips_per_s"


def read(r):
    return _spans.per_step(r, "serve", "xpt.serve.upload")
