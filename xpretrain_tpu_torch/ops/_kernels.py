"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into an object, all of
them at once in parallel processes, and the objects are linked into one
shared library with a plain C interface, bound with ``ctypes``. The build runs
at first use into ``build/xpretrain_tpu_torch/`` beside the package, keyed by
a hash of the sources and flags, so a fresh checkout builds itself and an
unchanged one reuses its library. A missing ``nvcc`` or a failed build raises;
nothing falls back to another path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import Optional

import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "xpretrain_tpu_torch"
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills go to the build log
)


def _nvcc() -> str:
    nvcc = shutil.which("nvcc")
    if nvcc is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / "nvcc"
        if not candidate.exists():
            raise RuntimeError(
                "nvcc not found on PATH or under CUDA_HOME (default /usr/local/cuda): "
                "the port's CUDA kernels cannot be built"
            )
        nvcc = str(candidate)
    return nvcc


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC_DIR.glob("*.cu")):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libxpt_kernels_{digest.hexdigest()[:16]}.so"


def _build(lib_path: Path) -> None:
    """One ``nvcc -c`` per source, all started together, then one link.

    The ``-Xptxas -v`` reports and any errors go to ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    nvcc = _nvcc()
    jobs = []
    for src in sorted(CSRC_DIR.glob("*.cu")):
        obj = BUILD_DIR / f"{tag}.{src.stem}.o"
        cmd = [nvcc, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        jobs.append((obj, proc))
    log, failed = [], []
    for obj, proc in jobs:
        out, _ = proc.communicate()
        log.append(f"== {obj.name}\n{out}")
        if proc.returncode != 0:
            failed.append(f"{obj.name}: nvcc exited {proc.returncode}\n{out[-6000:]}")
    tmp = lib_path.with_name(f"{tag}.so.tmp")
    if not failed:
        link = subprocess.run(
            [nvcc, "-shared", "-o", str(tmp), *(str(obj) for obj, _ in jobs)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
        )
        log.append(f"== link\n{link.stdout}")
        if link.returncode != 0:
            failed.append(f"link: nvcc exited {link.returncode}\n{link.stdout[-6000:]}")
    for obj, _ in jobs:
        obj.unlink(missing_ok=True)
    lib_path.with_suffix(".log").write_text("\n".join(log))
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("building the CUDA kernels failed:\n" + "\n".join(failed))
    os.replace(tmp, lib_path)  # atomic: a concurrent build never sees half a file


@functools.cache
def load_library() -> ctypes.CDLL:
    """Build (if needed) and load the kernel library; cached per process."""
    lib_path = library_path()
    if not lib_path.exists():
        _build(lib_path)
    lib = ctypes.CDLL(str(lib_path))
    lib.xpt_proxy_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 5 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.xpt_proxy_attention_fwd.restype = ctypes.c_int
    lib.xpt_proxy_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 10 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.xpt_proxy_attention_bwd.restype = ctypes.c_int
    lib.xpt_window_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.xpt_window_attention_fwd.restype = ctypes.c_int
    lib.xpt_patch_embed_u8.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.xpt_patch_embed_u8.restype = ctypes.c_int
    lib.xpt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.xpt_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _check(lib: ctypes.CDLL, rc: int, name: str) -> None:
    if rc != 0:
        msg = lib.xpt_cuda_error_string(rc).decode()
        raise RuntimeError(f"{name} launch failed: CUDA error {rc} ({msg})")


def _strides(*tensors: torch.Tensor) -> ctypes.Array:
    """The (batch, head, row) element strides of [B, H, S, D] views whose
    last dim has stride 1, as the kernels' ``const long long*`` argument."""
    flat = [st for t in tensors for st in t.stride()[:3]]
    return (ctypes.c_longlong * len(flat))(*flat)


def proxy_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor,
    M: int, N: int, L: int, scale: float,
) -> None:
    """Launch ``csrc/proxy_attention_fwd.cu`` on the current stream.

    q, k, v and out are [B, H, S, D] views, each with its own strides and a
    unit stride on D (contiguous tensors, or head views of the packed
    [B, S, H*D] layout). The caller has checked device, dtype and shape."""
    lib = load_library()
    B, H, S, D = q.shape
    with torch.cuda.device(q.device):
        rc = lib.xpt_proxy_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), _strides(q, k, v, out),
            B, H, S, D, M, N, L, float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _check(lib, rc, "proxy_attention_fwd")


def proxy_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d_out: torch.Tensor,
    dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor,
    M: int, N: int, L: int, scale: float,
) -> None:
    """Launch both passes of ``csrc/proxy_attention_bwd.cu`` on the current
    stream; ``lse`` and ``delta`` are contiguous fp32 [B, H, S] scratch.

    The seven tensors are [B, H, S, D] views with their own strides and a
    unit stride on D, as for :func:`proxy_attention_fwd`. The caller has
    checked device, dtype and shape."""
    lib = load_library()
    B, H, S, D = q.shape
    with torch.cuda.device(q.device):
        rc = lib.xpt_proxy_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            _strides(q, k, v, d_out, dq, dk, dv),
            B, H, S, D, M, N, L, float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _check(lib, rc, "proxy_attention_bwd")


def window_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: torch.Tensor, mask: Optional[torch.Tensor], out: torch.Tensor,
) -> None:
    """Launch ``csrc/window_attention_fwd.cu`` on the current stream; ``mask``
    may be None (no shifted-window mask).

    The caller has checked device, dtype, shape and contiguity."""
    lib = load_library()
    Bn, H, N, D = q.shape
    nW = 1 if mask is None else mask.shape[0]
    with torch.cuda.device(q.device):
        rc = lib.xpt_window_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(),
            Bn, H, N, D, nW, float(D**-0.5), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _check(lib, rc, "window_attention_fwd")


def patch_embed_u8(
    frames: torch.Tensor, folded_w: torch.Tensor, bias: torch.Tensor, out: torch.Tensor, patch: int,
) -> None:
    """Launch ``csrc/patch_embed_u8.cu`` on the current stream: contiguous
    uint8 frames [N, H, W, 3], fp32 folded weight [P*P*3, D] and bias [D]
    into ``out`` [N, L, D] (fp32 or bf16).

    The caller has checked device, dtype, shape and contiguity; the weight
    is read as float4, so its rows start 16-byte aligned (D % 4 == 0 and a
    freshly allocated tensor)."""
    lib = load_library()
    N, H, W, _ = frames.shape
    with torch.cuda.device(frames.device):
        rc = lib.xpt_patch_embed_u8(
            frames.data_ptr(), folded_w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            N, H, W, patch, folded_w.shape[1], int(out.dtype == torch.bfloat16),
            torch.cuda.current_stream(frames.device).cuda_stream,
        )
    _check(lib, rc, "patch_embed_u8")
