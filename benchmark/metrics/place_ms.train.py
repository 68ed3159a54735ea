"""Host ms per untraced step inside the span ``xpt.ingest.place`` (``batch_to_device``: pinning and the non-blocking copy of every leaf)."""

from benchmark.metrics import _spans

LAYER = "host ingest"
MOVES = "train_clips_per_s"


def read(r):
    return _spans.per_step(r, "train", "xpt.ingest.place")
