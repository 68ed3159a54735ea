"""Host ms per untraced call in the self time of the spans ``xpt.serve.encode_video`` and ``encode_text`` (each minus its uploads)."""

from benchmark.metrics import _spans

LAYER = "serving towers"
MOVES = "serve_clips_per_s"


def read(r):
    return _spans.serve_self(r)
