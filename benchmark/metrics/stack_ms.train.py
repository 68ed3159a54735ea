"""Host ms per untraced step inside the span ``xpt.ingest.stack`` (``train/loop.py:stack_batches``: stacking a call's numpy batches)."""

from benchmark.metrics import _spans

LAYER = "host ingest"
MOVES = "train_clips_per_s"


def read(r):
    return _spans.per_step(r, "train", "xpt.ingest.stack")
