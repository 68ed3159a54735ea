"""Build and bind the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled with ``nvcc`` for ``sm_90a`` into an object, all of
them at once in parallel processes, and the objects are linked into one
shared library with a plain C interface, bound with ``ctypes``. The build runs
at first use into ``build/xpretrain_tpu_torch/`` beside the package, keyed by
a hash of the sources, the headers they include (``csrc/*.cuh``) and the
flags, so a fresh checkout builds itself and an unchanged one reuses its
library. A missing ``nvcc`` or a failed build raises; nothing falls back to
another path.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import re
import shutil
import subprocess
from pathlib import Path
from typing import Callable, Optional

import numpy as np
import torch

CSRC_DIR = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "xpretrain_tpu_torch"
# the wrappers that count their kernel launches (:func:`counted`)
COUNTED: list[Callable] = []
# elements a block of the AdamW kernel updates, and leaves one launch takes
# (kChunk and kMaxLeaves in csrc/adamw_multi_tensor.cu; load_library checks)
ADAMW_CHUNK = 4096
ADAMW_MAX_LEAVES = 512
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",  # registers / shared memory / spills go to the build log
)


def counted(fn: Callable) -> Callable:
    """Register the kernel wrapper ``fn``: ``fn.launches`` counts the kernel
    launches it makes (the wrapper adds one where it launches, and nowhere
    else), and a captured CUDA graph adds the launches its capture recorded
    at each replay (``parallel/train_step.py:GraphedStep``)."""
    fn.launches = 0
    COUNTED.append(fn)
    return fn


def tracing() -> bool:
    """True while ``torch.export``, ``torch.compile`` or ``make_fx`` traces:
    a tensor made then is fake or a node of the graph being built, so a
    cache must not keep it (the next eager call would get it back)."""
    return (torch.compiler.is_compiling() or torch._guards.detect_fake_mode() is not None
            or torch._C._get_dispatch_mode(torch._C._TorchDispatchModeKey.PROXY) is not None)


def _cuda_tool(name: str) -> str:
    tool = shutil.which(name)
    if tool is None:
        cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
        candidate = Path(cuda_home) / "bin" / name
        if not candidate.exists():
            raise RuntimeError(
                f"{name} not found on PATH or under CUDA_HOME (default /usr/local/cuda): "
                "the port's CUDA kernels cannot be built or inspected"
            )
        tool = str(candidate)
    return tool


def library_path() -> Path:
    """Where the library for the current sources lives (built or not)."""
    digest = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted([*CSRC_DIR.glob("*.cu"), *CSRC_DIR.glob("*.cuh")]):
        digest.update(src.name.encode())
        digest.update(src.read_bytes())
    return BUILD_DIR / f"libxpt_kernels_{digest.hexdigest()[:16]}.so"


def _build(lib_path: Path) -> None:
    """One ``nvcc -c`` per source, all started together, then one link.

    The ``-Xptxas -v`` reports and any errors go to ``<lib>.log``."""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tag = f"{lib_path.stem}.{os.getpid()}"
    nvcc = _cuda_tool("nvcc")
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
        [ctypes.c_void_p] * 6 + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.xpt_proxy_attention_fwd.restype = ctypes.c_int
    lib.xpt_proxy_attention_bwd.argtypes = (
        [ctypes.c_void_p] * 9 + [ctypes.c_int, ctypes.c_void_p] + [ctypes.c_int] * 7
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.xpt_proxy_attention_bwd.restype = ctypes.c_int
    lib.xpt_proxy_attention_smem_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.xpt_proxy_attention_smem_bytes.restype = ctypes.c_int
    lib.xpt_window_attention_fwd.argtypes = (
        [ctypes.c_void_p] * 7 + [ctypes.c_int] * 5
        + [ctypes.c_float, ctypes.c_int, ctypes.c_void_p]
    )
    lib.xpt_window_attention_fwd.restype = ctypes.c_int
    lib.xpt_window_attention_smem_bytes.argtypes = [ctypes.c_int]
    lib.xpt_window_attention_smem_bytes.restype = ctypes.c_int
    lib.xpt_patch_embed_u8.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 6 + [ctypes.c_void_p]
    lib.xpt_patch_embed_u8.restype = ctypes.c_int
    lib.xpt_patch_embed_scratch_bytes.argtypes = [ctypes.c_int, ctypes.c_int]
    lib.xpt_patch_embed_scratch_bytes.restype = ctypes.c_longlong
    lib.xpt_patch_embed_smem_bytes.argtypes = []
    lib.xpt_patch_embed_smem_bytes.restype = ctypes.c_int
    lib.xpt_frozen_bn_act_fwd.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] + [ctypes.c_int] * 3 + [
        ctypes.c_void_p]
    lib.xpt_frozen_bn_act_fwd.restype = ctypes.c_int
    lib.xpt_frozen_bn_act_bwd.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_longlong] + [ctypes.c_int] * 2 + [
        ctypes.c_void_p]
    lib.xpt_frozen_bn_act_bwd.restype = ctypes.c_int
    lib.xpt_frozen_bn_scratch_floats.argtypes = [ctypes.c_longlong, ctypes.c_int]
    lib.xpt_frozen_bn_scratch_floats.restype = ctypes.c_longlong
    lib.xpt_adamw_multi_tensor.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_int] * 2 + [ctypes.c_void_p] * 2 + [
        ctypes.c_float] * 6 + [ctypes.c_int, ctypes.c_void_p]
    lib.xpt_adamw_multi_tensor.restype = ctypes.c_int
    lib.xpt_adamw_max_leaves.argtypes = []
    lib.xpt_adamw_max_leaves.restype = ctypes.c_int
    lib.xpt_adamw_chunk.argtypes = []
    lib.xpt_adamw_chunk.restype = ctypes.c_int
    lib.xpt_cuda_error_string.argtypes = [ctypes.c_int]
    lib.xpt_cuda_error_string.restype = ctypes.c_char_p
    if (lib.xpt_adamw_chunk(), lib.xpt_adamw_max_leaves()) != (ADAMW_CHUNK, ADAMW_MAX_LEAVES):
        raise RuntimeError("ADAMW_CHUNK and ADAMW_MAX_LEAVES differ from csrc/adamw_multi_tensor.cu's")
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


def check_cp_async(kernels: str, *views: torch.Tensor) -> None:
    """What 16-byte ``cp.async`` loads need of each bf16 [B, H, S, D] view:
    a 16-byte aligned data pointer and (batch, head, row) strides that are
    multiples of 8 elements; ``kernels`` names the caller in the error. fp32
    views are not held to it (the CUDA-core kernels load element by
    element)."""
    if views[0].dtype != torch.bfloat16:
        return
    for t in views:
        if t.data_ptr() % 16:
            raise ValueError(f"{kernels} need 16-byte aligned tensors, got address {t.data_ptr():#x}")
        if any(st % 8 for st in t.stride()[:3]):
            raise ValueError(f"{kernels} need strides that are multiples of 8, got {t.stride()}")


def proxy_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, out: torch.Tensor, lse: Optional[torch.Tensor],
    M: int, N: int, L: int, scale: float,
) -> None:
    """Launch ``csrc/proxy_attention_fwd.cu`` on the current stream: bf16 on
    the tensor cores, fp32 on the CUDA cores.

    q, k, v and out are [B, H, S, D] views, each with its own strides and a
    unit stride on D (contiguous tensors, or head views of the packed
    [B, S, H*D] layout). ``lse`` is None or a contiguous fp32 [B, H, S]
    buffer that receives each row's log-sum-exp. The caller has checked
    device, dtype, shape and, for bf16, what 16-byte ``cp.async`` needs."""
    lib = load_library()
    B, H, S, D = q.shape
    with torch.cuda.device(q.device):
        rc = lib.xpt_proxy_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
            None if lse is None else lse.data_ptr(), _strides(q, k, v, out),
            B, H, S, D, M, N, L, float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _check(lib, rc, "proxy_attention_fwd")


def proxy_attention_bwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, d_out: torch.Tensor,
    dq: torch.Tensor, dk: torch.Tensor, dv: torch.Tensor,
    lse: torch.Tensor, delta: torch.Tensor, lse_given: bool,
    M: int, N: int, L: int, scale: float,
) -> None:
    """Launch ``csrc/proxy_attention_bwd.cu`` on the current stream: its two
    passes, after an LSE pass of its own unless ``lse_given``. ``lse`` and
    ``delta`` are contiguous fp32 [B, H, S]: ``lse`` holds the forward's
    log-sum-exp when ``lse_given`` and receives it otherwise; ``delta`` is
    scratch.

    The seven tensors are [B, H, S, D] views with their own strides and a
    unit stride on D, as for :func:`proxy_attention_fwd`. The caller has
    checked device, dtype, shape and, for bf16, what ``cp.async`` needs."""
    lib = load_library()
    B, H, S, D = q.shape
    with torch.cuda.device(q.device):
        rc = lib.xpt_proxy_attention_bwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), d_out.data_ptr(),
            dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(), delta.data_ptr(),
            int(lse_given), _strides(q, k, v, d_out, dq, dk, dv),
            B, H, S, D, M, N, L, float(scale), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _check(lib, rc, "proxy_attention_bwd")


def _ptxas_and_hmma() -> tuple[dict, dict]:
    """Per entry point of the built library: registers, spills and static
    shared memory from the build's ``-Xptxas -v`` log, and the count of
    tensor-core ``HMMA`` instructions in ``cuobjdump --dump-sass``."""
    path = library_path()
    ptxas, entry = {}, None
    for line in path.with_suffix(".log").read_text().splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", line)
        if m:
            entry = m.group(1)
            ptxas[entry] = {}
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and entry:
            ptxas[entry].update(spill_stores=int(m.group(1)), spill_loads=int(m.group(2)))
        m = re.search(r"Used (\d+) registers(?:.*?(\d+) bytes smem)?", line)
        if m and entry:
            ptxas[entry].update(registers=int(m.group(1)), static_smem=int(m.group(2) or 0))
    sass = subprocess.run([_cuda_tool("cuobjdump"), "--dump-sass", str(path)],
                          capture_output=True, text=True, check=True).stdout
    hmma, entry = {}, None
    for line in sass.splitlines():
        m = re.search(r"Function : (\S+)", line)
        if m:
            entry = m.group(1)
            hmma[entry] = 0
        elif entry and "HMMA" in line:
            hmma[entry] += 1
    return ptxas, hmma


def kernel_resources(proxy_head_dim: int = 64, window_head_dim: int = 32) -> list[dict]:
    """Registers, spills and shared memory of every kernel entry point of the
    library, and its count of tensor-core ``HMMA`` instructions: the proxy
    attention at ``proxy_head_dim``, the window attention at
    ``window_head_dim`` and the patch embed, each in bf16 and fp32, and the
    optimizer's update with fp32 and with bf16 moments.
    ``tensor_cores`` says which entry points compute on the tensor cores (and
    so must hold ``HMMA``); ``dynamic_smem`` is what a launch asks for (the
    fp32 proxy kernels' depends on D only through their tiles and is not
    reported)."""
    lib = load_library()
    ptxas, hmma = _ptxas_and_hmma()
    D, d = proxy_head_dim, window_head_dim
    # (label, entry name, its template arguments in the mangled name, dtype,
    # on the tensor cores, dynamic shared memory or None); the fp32 attention
    # kernels are instantiated on D/4, the elements each lane holds
    kinds = [
        ("proxy fwd_mma_kernel", "fwd_mma_kernel", f"Li{D}ELb1E", "bfloat16", True,
         lib.xpt_proxy_attention_smem_bytes(D, 0)),
        ("proxy fwd_mma_kernel (LSE only)", "fwd_mma_kernel", f"Li{D}ELb0E", "bfloat16", True,
         lib.xpt_proxy_attention_smem_bytes(D, 1)),
        ("proxy dq_mma_kernel", "dq_mma_kernel", f"Li{D}E", "bfloat16", True,
         lib.xpt_proxy_attention_smem_bytes(D, 2)),
        ("proxy dkv_mma_kernel", "dkv_mma_kernel", f"Li{D}E", "bfloat16", True,
         lib.xpt_proxy_attention_smem_bytes(D, 3)),
        *((f"proxy {name}", name, f"Li{D // 4}E", "float32", False, None)
          for name in ("proxy_attention_fwd_kernel", "bwd_dq_kernel", "bwd_dkv_kernel")),
        ("window window_mma_kernel", "window_mma_kernel", f"Li{d}E", "bfloat16", True,
         lib.xpt_window_attention_smem_bytes(d)),
        ("window window_attention_fwd_kernel", "window_attention_fwd_kernel", f"Li{d // 4}E", "float32", False, 0),
        ("patch patch_embed_mma_kernel (cp.async rows)", "patch_embed_mma_kernel", "ILb1E", "bfloat16", True,
         lib.xpt_patch_embed_smem_bytes()),
        ("patch patch_embed_mma_kernel (byte gather)", "patch_embed_mma_kernel", "ILb0E", "bfloat16", True,
         lib.xpt_patch_embed_smem_bytes()),
        ("patch patch_weight_split_kernel", "patch_weight_split_kernel", "", "bfloat16", False, 0),
        ("patch patch_bias_shift_kernel", "patch_bias_shift_kernel", "", "float32", False, 0),
        ("patch patch_embed_fp32_kernel", "patch_embed_fp32_kernel", "", "float32", False, 0),
        ("adamw xpt_adamw_multi_tensor_apply_kernel (fp32 moments)", "xpt_adamw_multi_tensor_apply_kernel", "IfE",
         "float32", False, 0),
        ("adamw xpt_adamw_multi_tensor_apply_kernel (bf16 moments)", "xpt_adamw_multi_tensor_apply_kernel",
         "I13__nv_bfloat16E", "float32", False, 0),
    ]
    rows = []
    for label, name, args, dtype, tensor_cores, smem in kinds:
        found = [e for e in ptxas if name in e and args in e]
        if len(found) != 1:
            raise RuntimeError(f"{name} {args}: {len(found)} entries in the ptxas log")
        row = {"kernel": label, "dtype": dtype, "tensor_cores": tensor_cores, "entry": found[0],
               **ptxas[found[0]], "hmma": hmma.get(found[0], 0)}
        if smem is not None:
            row["dynamic_smem"] = smem
        rows.append(row)
    return rows


def window_attention_fwd(
    q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
    bias: torch.Tensor, mask: Optional[torch.Tensor], out: torch.Tensor,
) -> None:
    """Launch ``csrc/window_attention_fwd.cu`` on the current stream: bf16 on
    the tensor cores, fp32 on the CUDA cores; ``mask`` may be None (no
    shifted-window mask).

    q, k, v and out are [Bn, H, N, d] views, each with its own strides and a
    unit stride on d (contiguous tensors, or views of one fused qkv
    projection). The caller has checked device, dtype, shape, that bias and
    mask are contiguous fp32 and, for bf16, what 16-byte ``cp.async`` needs."""
    lib = load_library()
    Bn, H, N, D = q.shape
    nW = 1 if mask is None else mask.shape[0]
    with torch.cuda.device(q.device):
        rc = lib.xpt_window_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(),
            None if mask is None else mask.data_ptr(), out.data_ptr(), _strides(q, k, v, out),
            Bn, H, N, D, nW, float(D**-0.5), int(q.dtype == torch.bfloat16),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    _check(lib, rc, "window_attention_fwd")


def patch_embed_u8(
    frames: torch.Tensor, folded_w: torch.Tensor, bias: torch.Tensor, out: torch.Tensor, patch: int,
) -> None:
    """Launch ``csrc/patch_embed_u8.cu`` on the current stream: contiguous
    uint8 frames [N, H, W, 3], fp32 folded weight [P*P*3, D] and bias [D]
    into ``out`` [N, L, D]: bf16 on the tensor cores (after a prologue that
    splits the weight into hi and lo bf16 terms and shifts the bias for the
    centred patches, in a scratch allocated here), fp32 on the CUDA cores.

    The caller has checked device, dtype, shape and contiguity; the fp32
    kernel reads the weight as float4, so its rows start 16-byte aligned
    (D % 4 == 0 and a freshly allocated tensor)."""
    lib = load_library()
    N, H, W, _ = frames.shape
    D = folded_w.shape[1]
    scratch = None
    if out.dtype == torch.bfloat16:
        scratch = torch.empty(lib.xpt_patch_embed_scratch_bytes(patch, D), dtype=torch.uint8, device=frames.device)
    with torch.cuda.device(frames.device):
        rc = lib.xpt_patch_embed_u8(
            frames.data_ptr(), folded_w.data_ptr(), bias.data_ptr(), out.data_ptr(),
            None if scratch is None else scratch.data_ptr(),
            N, H, W, patch, D, int(out.dtype == torch.bfloat16),
            torch.cuda.current_stream(frames.device).cuda_stream,
        )
    _check(lib, rc, "patch_embed_u8")


def _ptr(t: Optional[torch.Tensor]) -> Optional[int]:
    return None if t is None else t.data_ptr()


def frozen_bn_act_fwd(
    x: torch.Tensor, identity: Optional[torch.Tensor], inv: torch.Tensor, shift: torch.Tensor, y: torch.Tensor,
    relu: bool,
) -> None:
    """Launch ``csrc/frozen_bn_act.cu``'s forward on the current stream:
    ``y = act(x * inv + shift [+ identity])`` over channels_last
    [N, C, H, W] maps (``identity`` may be None), bf16 or fp32; ``inv`` and
    ``shift`` are contiguous fp32 [C]. The caller has checked device, dtype,
    shape and the channels_last layout of every map."""
    lib = load_library()
    C = x.shape[1]
    with torch.cuda.device(x.device):
        rc = lib.xpt_frozen_bn_act_fwd(
            x.data_ptr(), _ptr(identity), inv.data_ptr(), shift.data_ptr(), y.data_ptr(), x.numel() // C, C,
            int(relu), int(x.dtype == torch.bfloat16), torch.cuda.current_stream(x.device).cuda_stream,
        )
    _check(lib, rc, "frozen_bn_act_fwd")


def frozen_bn_act_bwd(
    g: torch.Tensor, y: Optional[torch.Tensor], x: Optional[torch.Tensor], inv: torch.Tensor,
    dx: torch.Tensor, d_identity: Optional[torch.Tensor], sums: Optional[torch.Tensor],
) -> None:
    """Launch ``csrc/frozen_bn_act.cu``'s backward on the current stream:
    ``dx`` and, where given, ``d_identity`` from the output gradient ``g``;
    ``y`` (the forward's output, for the ReLU's mask) None without the
    activation; given ``x``, the parameters' fp32 sums into ``sums`` [2, C]
    (Σ g·mask·x, Σ g·mask over N·H·W), through a scratch of per-block
    partials allocated here, and a second launch that adds them up. The
    caller has checked device, dtype, shape and layout."""
    lib = load_library()
    C = g.shape[1]
    rows = g.numel() // C
    with torch.cuda.device(g.device):
        scratch = None
        if x is not None:
            scratch = torch.empty(lib.xpt_frozen_bn_scratch_floats(rows, C), dtype=torch.float32, device=g.device)
        rc = lib.xpt_frozen_bn_act_bwd(
            g.data_ptr(), _ptr(y), _ptr(x), inv.data_ptr(), dx.data_ptr(), _ptr(d_identity), _ptr(scratch),
            _ptr(sums), rows, C, int(g.dtype == torch.bfloat16), torch.cuda.current_stream(g.device).cuda_stream,
        )
    _check(lib, rc, "frozen_bn_act_bwd")


def adamw_multi_tensor(ptrs: np.ndarray, numel: np.ndarray, first_chunk: np.ndarray, scalar_index: np.ndarray,
                       wd: np.ndarray, moment_bf16: bool, scalars: torch.Tensor, gnorm: Optional[torch.Tensor],
                       h) -> None:
    """Launch ``csrc/adamw_multi_tensor.cu`` once on the current stream over
    up to ``ADAMW_MAX_LEAVES`` leaves on the card that holds ``scalars``:
    ``ptrs`` uint64 [leaves, 4], each leaf's (target, gradient, m, v)
    addresses, all contiguous, fp32 but for m and v, bf16 if
    ``moment_bf16``; ``numel`` int64 [leaves]; ``first_chunk`` int32
    [leaves + 1], the chunk table; ``scalar_index`` int32 and ``wd`` fp32
    [leaves], each leaf's group's entry of ``scalars`` (the device fp32
    [c1, c2, -lr * mul ...]) and decay; ``gnorm`` the device fp32 global
    norm, read when ``h.max_norm`` (``optim/adamw_kernel.py:Hyper``) is set,
    else None."""
    lib = load_library()
    device = scalars.device
    clip = h.max_norm is not None
    if clip and (gnorm.device != device or gnorm.dtype != torch.float32):
        raise ValueError(f"the clip reads a float32 norm on {device}, got {gnorm.dtype} on {gnorm.device}")
    with torch.cuda.device(device):
        rc = lib.xpt_adamw_multi_tensor(
            ptrs.ctypes.data, numel.ctypes.data, first_chunk.ctypes.data, scalar_index.ctypes.data, wd.ctypes.data,
            len(numel), int(moment_bf16), scalars.data_ptr(), gnorm.data_ptr() if clip else None, h.b1,
            h.one_minus_b1, h.b2, h.one_minus_b2, h.eps, h.max_norm if clip else 0.0, int(clip),
            torch.cuda.current_stream(device).cuda_stream,
        )
    _check(lib, rc, "adamw_multi_tensor")
