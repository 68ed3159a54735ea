"""Host ms per untraced step inside the span ``xpt.step`` (a call of the public train step: everything the program does on the host for it)."""

from benchmark.metrics import _spans

LAYER = "train step"
MOVES = "train_clips_per_s"


def read(r):
    return _spans.per_step(r, "train", "xpt.step")
