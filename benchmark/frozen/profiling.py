"""Device time by op class from ``torch.profiler`` key averages.

Frozen copy of ``OP_CLASSES``, ``op_class``, ``op_class_table``,
``device_us`` and ``key_average_rows`` from
``xpretrain_tpu_torch/train/profiling.py`` at commit 7fcd34c.
"""

from __future__ import annotations

import torch

# (class, substrings of a device kernel's name); the first class that
# matches takes the kernel, so the specific names come first
OP_CLASSES = (
    ("proxy attention forward kernel", ("proxy_attention_fwd_kernel", "fwd_mma_kernel")),
    ("proxy attention backward kernel, dq pass", ("bwd_dq_kernel", "dq_mma_kernel")),
    ("proxy attention backward kernel, dk/dv pass", ("bwd_dkv_kernel", "dkv_mma_kernel")),
    ("window attention forward kernel", ("window_attention_fwd_kernel", "window_mma_kernel")),
    ("patch embed kernel", ("patch_embed_fp32_kernel", "patch_embed_mma_kernel", "patch_weight_split_kernel",
                            "patch_bias_shift_kernel")),
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
