"""``torch.profiler`` traces of training steps, and their device time by op
class.

:func:`stop_profiler` writes, under one directory, the Chrome trace
(``trace.json``), the per-op averages (``key_averages.{txt,json}``) and
``op_classes.json``: the device kernels' time and launches per step, summed
by the classes of :data:`OP_CLASSES` (GEMMs, the attention kernels,
copies, AdamW, ...). On a host without a card the class table is empty.
"""

from __future__ import annotations

import json
import os

import torch

from xpretrain_tpu_torch.utils.logging import LOGGER

# (class, substrings of a device kernel's name); the first class that
# matches takes the kernel, so the specific names come first
OP_CLASSES = (
    # the proxy kernels: fp32 on the CUDA cores, bf16 on the tensor cores
    ("proxy attention forward kernel", ("proxy_attention_fwd_kernel", "fwd_mma_kernel")),
    ("proxy attention backward kernel, dq pass", ("bwd_dq_kernel", "dq_mma_kernel")),
    ("proxy attention backward kernel, dk/dv pass", ("bwd_dkv_kernel", "dkv_mma_kernel")),
    # the window kernel and the u8 patch embed: fp32 on the CUDA cores, bf16
    # on the tensor cores (the patch embed after its two prologue kernels)
    ("window attention forward kernel", ("window_attention_fwd_kernel", "window_mma_kernel")),
    ("patch embed kernel", ("patch_embed_fp32_kernel", "patch_embed_mma_kernel", "patch_weight_split_kernel",
                            "patch_bias_shift_kernel")),
    # cuDNN's convolutions (HD-VILA's ResNets) before the GEMMs: their
    # implicit-GEMM kernels carry "gemm" in their names too
    ("convolutions (cuDNN)", ("fprop", "dgrad", "wgrad", "implicit_convolve", "cudnn", "nchwToNhwc",
                              "nhwcToNchw")),
    ("attention (SDPA)", ("flash", "fmha")),
    ("GEMMs", ("nvjet", "gemm", "cutlass", "splitKreduce", "cublas")),
    ("AdamW and norms (_foreach)", ("multi_tensor_apply", "lpnorm_cleanup")),
    ("LayerNorm forward and backward", ("layer_norm", "GammaBeta")),
    ("copies and casts", ("copy_kernel", "Memcpy", "Memset", "CatArray")),
    ("reductions", ("reduce_kernel",)),
    ("softmax", ("softmax",)),
    ("elementwise", ("elementwise_kernel",)),
)
OTHER = "other"


def op_class(kernel_name: str) -> str:
    """The class of :data:`OP_CLASSES` a device kernel belongs to, else ``other``."""
    for name, keys in OP_CLASSES:
        if any(key in kernel_name for key in keys):
            return name
    return OTHER


def op_class_table(rows: list[dict], steps: int) -> list[dict]:
    """Device ms and launches per step by op class, largest first.

    ``rows`` are :func:`key_average_rows` entries; only device kernels (and
    device copies and sets) count, so an op's time is not counted twice
    through the host op that launched it."""
    classes: dict[str, list[float]] = {}
    for row in rows:
        if row["device_type"] != "CUDA":
            continue
        acc = classes.setdefault(op_class(row["name"]), [0.0, 0])
        acc[0] += row["self_device_us"]
        acc[1] += row["count"]
    total = device_us(rows) or 1.0
    table = [
        {"class": name, "device_ms_per_step": us / 1e3 / steps, "share": us / total,
         "launches_per_step": n / steps}
        for name, (us, n) in classes.items()
    ]
    return sorted(table, key=lambda r: -r["device_ms_per_step"])


def device_us(rows: list[dict]) -> float:
    """Device time (us) of :func:`key_average_rows` entries: their device
    kernels, copies and sets, each counted once."""
    return sum(row["self_device_us"] for row in rows if row["device_type"] == "CUDA")


def key_average_rows(prof: torch.profiler.profile) -> list[dict]:
    return [
        {
            "name": e.key,
            "device_type": str(e.device_type).rsplit(".", 1)[-1],
            "count": e.count,
            "self_cpu_us": e.self_cpu_time_total,
            "self_device_us": getattr(e, "self_device_time_total", 0.0),
        }
        for e in prof.key_averages()
    ]


def start_profiler() -> torch.profiler.profile:
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    prof = torch.profiler.profile(activities=activities)
    prof.start()
    return prof


def stop_profiler(prof: torch.profiler.profile, profile_dir: str, steps: int) -> list[dict]:
    """Stop ``prof`` (which saw ``steps`` steps), write its files under
    ``profile_dir`` and return the op-class table."""
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    prof.stop()
    os.makedirs(profile_dir, exist_ok=True)
    prof.export_chrome_trace(os.path.join(profile_dir, "trace.json"))
    sort = "self_cuda_time_total" if torch.cuda.is_available() else "self_cpu_time_total"
    with open(os.path.join(profile_dir, "key_averages.txt"), "w") as f:
        f.write(prof.key_averages().table(sort_by=sort, row_limit=80))
    rows = key_average_rows(prof)
    with open(os.path.join(profile_dir, "key_averages.json"), "w") as f:
        json.dump(rows, f)
    table = op_class_table(rows, max(1, steps))
    with open(os.path.join(profile_dir, "op_classes.json"), "w") as f:
        json.dump({"steps": steps, "classes": table}, f, indent=1)
    LOGGER.info("wrote a torch.profiler trace of %d steps to %s", steps, profile_dir)
    return table
