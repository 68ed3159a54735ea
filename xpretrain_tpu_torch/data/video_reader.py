"""Video decoding: ctypes binding to the native libav reader, cv2 fallback
(the port's copy of ``xpretrain_tpu/data/video_reader.py``).

The decord replacement: ``native/video_reader.cpp`` demuxes and decodes with
FFmpeg's libraries, seeking to the keyframe before each requested index and
scaling to the target size with libswscale; frames land directly in a
caller-owned numpy buffer. The library is looked up at
``native/build/libxvr.so`` under the repository root (``make -C native``).

If the shared library is absent (not built), falls back to OpenCV's
VideoCapture.
"""

from __future__ import annotations

import ctypes
import dataclasses
import os
import threading

import numpy as np

_LIB_PATHS = [
    os.path.join(os.path.dirname(__file__), "..", "..", "native", "build", "libxvr.so"),
    os.path.join(os.path.dirname(__file__), "libxvr.so"),
    "libxvr.so",
]

_lib = None
_lib_lock = threading.Lock()


def _load_lib():
    global _lib
    if _lib is not None:
        return _lib
    with _lib_lock:
        if _lib is not None:
            return _lib
        for path in _LIB_PATHS:
            try:
                lib = ctypes.CDLL(os.path.abspath(path) if os.path.sep in path else path)
            except OSError:
                continue
            lib.xvr_open.restype = ctypes.c_void_p
            lib.xvr_open.argtypes = [ctypes.c_char_p]
            lib.xvr_num_frames.restype = ctypes.c_longlong
            lib.xvr_num_frames.argtypes = [ctypes.c_void_p]
            lib.xvr_fps.restype = ctypes.c_double
            lib.xvr_fps.argtypes = [ctypes.c_void_p]
            lib.xvr_width.restype = ctypes.c_int
            lib.xvr_width.argtypes = [ctypes.c_void_p]
            lib.xvr_height.restype = ctypes.c_int
            lib.xvr_height.argtypes = [ctypes.c_void_p]
            lib.xvr_read_frames.restype = ctypes.c_int
            lib.xvr_read_frames.argtypes = [
                ctypes.c_void_p,
                ctypes.POINTER(ctypes.c_longlong),
                ctypes.c_int,
                ctypes.POINTER(ctypes.c_uint8),
                ctypes.c_int,
                ctypes.c_int,
            ]
            lib.xvr_close.argtypes = [ctypes.c_void_p]
            _lib = lib
            return _lib
        _lib = False
        return _lib


@dataclasses.dataclass
class VideoInfo:
    num_frames: int
    fps: float
    width: int
    height: int


def probe(path: str) -> VideoInfo:
    lib = _load_lib()
    if lib:
        handle = lib.xvr_open(path.encode())
        if not handle:
            raise IOError(f"cannot open video {path}")
        try:
            return VideoInfo(
                int(lib.xvr_num_frames(handle)),
                float(lib.xvr_fps(handle)),
                int(lib.xvr_width(handle)),
                int(lib.xvr_height(handle)),
            )
        finally:
            lib.xvr_close(handle)
    return _probe_cv2(path)


def read_frames(
    path: str,
    frame_indices: np.ndarray,
    out_hw: tuple[int, int] | None = None,
) -> np.ndarray:
    """Decode the given frame indices -> uint8 [n, H, W, 3] RGB."""
    frame_indices = np.asarray(frame_indices, dtype=np.int64)
    lib = _load_lib()
    if lib:
        handle = lib.xvr_open(path.encode())
        if not handle:
            raise IOError(f"cannot open video {path}")
        try:
            h = int(lib.xvr_height(handle))
            w = int(lib.xvr_width(handle))
            if out_hw is not None:
                h, w = out_hw
            n = len(frame_indices)
            out = np.empty((n, h, w, 3), dtype=np.uint8)
            idx = frame_indices.astype(np.int64)
            ret = lib.xvr_read_frames(
                handle,
                idx.ctypes.data_as(ctypes.POINTER(ctypes.c_longlong)),
                n,
                out.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
                h,
                w,
            )
            if ret != 0:
                raise IOError(f"decode failed for {path} ({-ret} frames missing)")
            return out
        finally:
            lib.xvr_close(handle)
    return _read_frames_cv2(path, frame_indices, out_hw)


# ---------------------------------------------------------------------------
# cv2 fallback
# ---------------------------------------------------------------------------


def _probe_cv2(path: str) -> VideoInfo:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    info = VideoInfo(
        int(cap.get(cv2.CAP_PROP_FRAME_COUNT)),
        float(cap.get(cv2.CAP_PROP_FPS)),
        int(cap.get(cv2.CAP_PROP_FRAME_WIDTH)),
        int(cap.get(cv2.CAP_PROP_FRAME_HEIGHT)),
    )
    cap.release()
    return info


def _read_frames_cv2(path, frame_indices, out_hw=None) -> np.ndarray:
    import cv2

    cap = cv2.VideoCapture(path)
    if not cap.isOpened():
        raise IOError(f"cannot open video {path}")
    frames = {}
    try:
        for want in sorted(set(int(i) for i in frame_indices)):
            cur = int(cap.get(cv2.CAP_PROP_POS_FRAMES))
            if want != cur:
                cap.set(cv2.CAP_PROP_POS_FRAMES, want)
            ok, img = cap.read()
            if not ok:
                raise IOError(f"decode failed at frame {want} of {path}")
            img = cv2.cvtColor(img, cv2.COLOR_BGR2RGB)
            if out_hw is not None:
                img = cv2.resize(img, (out_hw[1], out_hw[0]), interpolation=cv2.INTER_LINEAR)
            frames[want] = img
    finally:
        cap.release()
    return np.stack([frames[int(i)] for i in frame_indices])


def native_available() -> bool:
    return bool(_load_lib())
