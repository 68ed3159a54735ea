"""The most device memory the caching allocator held during the window (GiB), a graph's pool included: the headroom a larger batch would use."""

from benchmark.metrics import _read

LAYER = "device"
MOVES = "serve_clips_per_s"


def read(r):
    return _read.peak_gib(r, "serve")
