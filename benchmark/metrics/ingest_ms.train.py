"""Host ms per untraced step inside ``trainer.place_batch`` (pinning and copying the numpy batch)."""

from benchmark.metrics import _read

LAYER = "host ingest"
MOVES = "train_clips_per_s"


def read(r):
    return _read.host_ms(r, "train")
