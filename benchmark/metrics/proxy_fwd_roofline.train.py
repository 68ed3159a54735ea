"""Least time over device time (%) of the traced ``xpt::proxy_attention_fwd`` launches of training."""

from benchmark.metrics import _read

LAYER = "kernels"
MOVES = "train_clips_per_s"


def read(r):
    return _read.roofline_pct(r, "train", "xpt::proxy_attention_fwd")
