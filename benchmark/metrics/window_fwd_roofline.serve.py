"""Least time over device time (%) of the traced ``xpt::window_attention_fwd`` launches."""

from benchmark.metrics import _read

LAYER = "kernels"
MOVES = "serve_clips_per_s"


def read(r):
    return _read.roofline_pct(r, "serve", "xpt::window_attention_fwd")
