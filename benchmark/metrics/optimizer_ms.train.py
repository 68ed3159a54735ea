"""Device ms per traced step in the frozen op class of GroupedAdamW's ``_foreach`` kernels."""

from benchmark.metrics import _read

LAYER = "optimizer"
MOVES = "train_clips_per_s"


def read(r):
    return _read.class_ms(r, "train", "AdamW and norms (_foreach)")
