#!/usr/bin/env python3
"""Drive the PyTorch port (``xpretrain_tpu_torch``) on one NVIDIA card.

Phases, in order; any failure exits non-zero and prints no result:

1. require a CUDA card, print its name and power limit, turn TF32 off;
2. build the port's CUDA kernels from ``xpretrain_tpu_torch/csrc`` and list,
   per entry point (proxy attention, window attention, patch embed; bf16 and
   fp32), its registers, spills, shared memory and the tensor-core (``HMMA``)
   instructions in its SASS;
3. check the proxy-attention forward kernel against its plain PyTorch
   version on the card at B/32, B/16, the pretraining image branch's one-frame
   clips (b=32, N=1: S = 53) and small shapes, in fp32 and bf16, and
   the LSE it saves for the backward against ``proxy_attention_lse_plain``;
3b. the same for the backward kernel, at those shapes and the B/32 train
   shape (b=32), called alone (it computes the LSE itself) and with the
   forward's LSE (as autograd calls it), each twice (bit-identical), plus its
   gradient against autograd of the plain forward;
3c. the same for the window-attention kernel, at the LF-VILA stage shapes of
   batch 8 (stages 3-5, and the grouped stages 0-1), a tail and other head
   dims, and at stage 3 on q/k/v views of one fused qkv tensor (what the
   model passes; bit-equal to the contiguous call);
3d. the packed [B, S, H*D] proxy attention (the two proxy kernels through
   their stride arguments): forward at the phase-3 shapes, backward at the
   B/32 train shape, against the plain version (the phase 3/3b bars) and
   against the [B, H, S, D] kernels on the same data (bit-equal or not);
3e. the fused uint8 patch-embed kernel against ``fused_patch_embed``'s plain
   GEMM at the B/32 serving frames (288 of 224x224, P=32, D=768), at P=16 and
   at ragged shapes, fp32 and bf16 out;
4. run CLIP-ViP B/32 zero-shot retrieval eval (random weights from a seed,
   bf16, synthetic uint8 clips) through the CLI, counting kernel launches;
4b. run the MSR-VTT B/32 fine-tune preset through the CLI for a few steps
   (``--mode train``), counting forward and backward launches;
4c. run LF-VILA paragraph-to-video retrieval (the stage-1 preset's model at
   full width and depth, the window kernel on, bf16, synthetic data) through
   its CLI with no train step, counting window-kernel launches;
4d. the ops path: the public op entries that no model calls, at the full
   B/32 widths in bf16: ``proxy_attention_packed`` forward (b=24) and
   forward + backward through autograd (b=32), and ``fused_patch_embed``
   with ``use_kernel=True`` on the 288 frames of a b=24 batch, counting the
   packed and patch-embed launches;
4e. run LF-VILA stage-1 pretraining (``run_pretrain_lfvila --stage 1`` on the
   port's JSON copy of the stage-1 preset: full width and depth, batch 16,
   bf16, synthetic u8 clips, the window kernel off as JAX trains) for 5
   steps: finite losses and gradient norms, step times in CUDA events, peak
   memory, and the op classes of the last step's ``torch.profiler`` trace;
4f. run stage-2 pretraining (the stage-2 preset, Swin3D remat, batch 48)
   for 4 steps: finite MLM and VTM losses, every
   frozen parameter bit-identical after the steps and every other one moved;
4g. run the LF-VILA fine-tunes through ``run_tasks_lfvila``: ``qa_mc``,
   ``qa_cls`` (ActivityNet-QA) and ``video_cls`` at their default text
   lengths on the kernel config with
   no train step (six window launches per video forward, accuracy in
   [0, 1]), then 2 ``qa_mc`` train steps on the kernel-off config (the
   fusion and span-loss backward);
4h. run CLIP-ViP pretraining (``run_pretrain_clipvip`` on the port's JSON
   copy of the B/32 pretraining preset: b=32, 12 frames at 224, bf16,
   ``NCELearnableTempLoss_vsc_fc``, synthetic data with the image/caption
   branch) for 6 steps from a ``--clip_weights`` file it writes (a seeded
   B/32 under ``clipmodel.``, an 8-row temporal embedding): the loaded
   parameters against the file, finite losses and gradient norms, 24 forward
   and 24 backward proxy launches a step (12 video + 12 image layers), step
   times in CUDA events and peak memory;
4i. run LF-VILA stage-1 pretraining for 4 steps from a written 2-D Swin-B
   (``--swin_weight``, inflated to the preset's 3-D windows) and a BERT-large
   (``--bert_weight``, the 12 layers the stage-1 model holds): the BERT
   embeddings, the inflated patch embed and the tiled bias tables on the
   model before its first step, finite losses, step times in CUDA events;
5. serve a few requests through ``RetrievalTowers`` in fp32 and compare the
   card's features with the CPU's (plain path) for the same weights;
5b. take one fp32 pretraining step of B/32 at batch 2 on the card (kernels)
   and on the CPU (plain) from the same weights and batch (fp32 video, one
   image and caption a clip, ``vsc_fc``), and compare;
5c. encode one clip and its paragraph through ``LfVilaTowers`` in fp32 on the
   card and on the CPU from the same weights, and compare;
5d. take one fp32 ``LfVilaPretrain`` train step per stage on the card and on
   the CPU (full widths, one block per Swin3D stage and one BERT layer per
   BERT stage, batch 2, explicit MTC clips) and compare, as 5b;
6. time the forward kernel against the plain version, and the whole forward;
6b. time the backward kernel (with the forward's LSE, and alone) against its
   plain version, forward and backward through autograd (kernels against the
   plain forward and, in bf16, SDPA), and the B/32 bf16 train step at b=32;
6c. time the window kernel against its plain version at the batch-8 shapes,
   and the LF-VILA video and text towers at batch 8 in bf16;
6d. time the packed kernels (the backward as autograd runs it, on the
   forward's LSE, and alone) and the patch-embed kernel against their plain
   versions and one PyTorch call that computes the same function
   (``library_ms``: ``scaled_dot_product_attention`` with the proxy mask; a
   bf16 ``addmm`` of pre-gathered bf16 patches and the bf16-rounded weight,
   the model's own GEMM), and that call for the kernels of phases 6-6c at
   their shapes; the window kernel at stages 3, 5 and the grouped 0-1 against
   its plain version and the model's off-gate path (``dot_attention`` with
   bias + mask as one additive mask); each kernel's device time alone
   (``torch.profiler``) over the calls it is timed on;
7. print the kernel summary (each kernel's time in CUDA events and on the
   device, plain time, library time and the bound of its work at the card's
   peak rates) and, as the last line, the status JSON.

Each main-path run (4, 4b, 4c, 4d, 4e, 4f, each run of 4g, 4h and 4i) sets every
launch count to 0 just before it and reads the counts just after; the
summary reports each path's count and their sum. While they run, a call of a
plain version on CUDA tensors fails the phase.

Run from the repository root with no arguments: ``python3 chip_smoke.py``
(about 10 minutes on one H100, the kernels' build included).
"""

from __future__ import annotations

import contextlib
import copy
import dataclasses
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KERNELS = {  # name -> (source, the TPU kernel it replaces): one per pallas_call site
    "proxy_attention_fwd": ("xpretrain_tpu_torch/csrc/proxy_attention_fwd.cu",
                            "xpretrain_tpu/ops/proxy_attention.py:201"),  # _attention_pallas
    "proxy_attention_bwd": ("xpretrain_tpu_torch/csrc/proxy_attention_bwd.cu",
                            "xpretrain_tpu/ops/proxy_attention.py:345"),  # _attention_pallas_bwd
    "proxy_attention_packed_fwd": ("xpretrain_tpu_torch/csrc/proxy_attention_fwd.cu",
                                   "xpretrain_tpu/ops/proxy_attention.py:228"),  # _attention_pallas_packed
    "proxy_attention_packed_bwd": ("xpretrain_tpu_torch/csrc/proxy_attention_bwd.cu",
                                   "xpretrain_tpu/ops/proxy_attention.py:379"),  # _attention_pallas_bwd_packed
    "patch_embed_u8": ("xpretrain_tpu_torch/csrc/patch_embed_u8.cu",
                       "xpretrain_tpu/ops/patchify.py:84"),  # _pallas_patch_embed
    "window_attention_fwd": ("xpretrain_tpu_torch/csrc/window_attention_fwd.cu",
                             "xpretrain_tpu/ops/window_attention.py:59"),  # window_attention_pallas
}
# H100 SXM data-sheet peaks (dense): the bound of a kernel's work is the larger
# of its bytes over HBM_BYTES_PER_S and its operations over the tensor cores'
# bf16 rate, the least time the card needs for a bf16 output whatever computes
# it (the patch embed's u8 inputs widen to bf16 exactly; its hi + lo weight
# split is the kernel's cost, not the function's)
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = 989e12
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # max abs; fp32: summation order; bf16: output rounding
# patch embed, fp32 out, relative to max|out|: K = 3*P*P terms of up to 255*|w|
# summed in fp32 in another order than cuBLAS's, so the difference grows with
# the size of the sums, not with an output that happens to be small
PATCH_FP32_REL = 3e-5
# (N, H, W, P, D): the B/32 serving frames (24 clips x 12), P=16, ragged rows/K/D
PATCH_SHAPES = {
    "b32": (288, 224, 224, 32, 768),
    "p16": (288, 224, 224, 16, 768),
    "ragged_d200": (7, 64, 96, 16, 200),
    "ragged_rows": (5, 96, 160, 32, 768),
    "p14_k588": (2, 28, 42, 14, 64),
}
BF16_MAX_ULP = 1.0  # bf16 output vs the fp32 plain version of the same inputs: rounding alone
BWD_TOL_FP32 = 1e-4  # max abs: summation order over up to S terms
BWD_MAX_ULP = 2.0  # bf16 vs fp32 plain gradients: fp32 accumulation and one rounding at the store
LSE_TOL = 1e-5  # max abs, the forward's fp32 LSE: a sum of up to S exponentials in another order
B32 = dict(B=24, H=12, M=4, N=12, L=49, D=64)  # CLIP-ViP B/32 serving, batch 24
B32_TRAIN = dict(B32, B=32)  # CLIP-ViP B/32 training, batch 32
PRESET = "xpretrain_tpu_torch/configs/msrvtt_retrieval_vip_base_32.json"  # the port's copy of the MSR-VTT preset
TRAIN_STEPS, TRAIN_EVERY = 6, 3  # the fine-tune run of phase 4b: steps, validate/save cadence
B32_IMAGE = dict(B32_TRAIN, N=1)  # pretraining's image branch: b=32 one-frame clips, S = 4 + 49
CHECK_SHAPES = {
    "b32": B32,
    "b32_image": B32_IMAGE,
    "b16": dict(B=2, H=12, M=4, N=12, L=196, D=64),
    "tiny": dict(B=2, H=2, M=3, N=4, L=13, D=16),
    "l256_d128": dict(B=2, H=3, M=1, N=3, L=256, D=128),
    "d48": dict(B=2, H=3, M=4, N=5, L=7, D=48),
}
EVAL_BATCH = 24
VIDEO_LAYERS = 12
# LF-VILA: the stage-1 preset (as JSON, with the window kernel on) at batch 8,
# the JAX bench's LF-VILA batch (tools/bench_report.py:189)
LFVILA_PRESET = "xpretrain_tpu_torch/configs/lfvila_stage1_window_kernel.json"
LFVILA_BATCH = 8
WINDOW_BLOCKS = 6  # blocks of stages 3-5, whose windows hold >= 240 tokens: launches per video forward
# name -> (Bn, H, N, d, mask), the mask as the model builds it: stage shapes of
# 32 frames at 192x320, batch 8 (stage 3's shifted block, stage 3, stage 5,
# the grouped shifted blocks of stages 0 and 1), then random -100 masks
WINDOW_SHAPES = {
    "s3_shifted": (64, 16, 240, 32, ("shifted", (32, 6, 10), (16, 3, 5), (0, 1, 2))),
    "s3": (64, 16, 240, 32, None),
    "s5": (8, 32, 480, 32, None),
    "s0_grouped": (2048, 4, 120, 32, ("grouped", (32, 24, 40), (2, 3, 5), (0, 1, 2), 4)),
    "s1_grouped": (512, 8, 120, 32, ("grouped", (32, 12, 20), (4, 3, 5), (0, 1, 2), 2)),
    "tail_d16": (6, 3, 77, 16, ("random", 3)),
    "d64": (4, 2, 200, 64, ("random", 2)),
}
WINDOW_TIMED = ("s3_shifted", "s3", "s5")
# LF-VILA training: the port's JSON copies of the two pretraining presets
# (window kernel off, as JAX trains), full width and depth, synthetic data
STAGE_PRESETS = {1: "xpretrain_tpu_torch/configs/lfvila_pretrain_stage1.json",
                 2: "xpretrain_tpu_torch/configs/lfvila_pretrain_stage2.json"}
# steps of each stage's run: the first warms up and is not timed; stage 1's
# last is the profiled one (its op-class table), so it is not timed either
PRETRAIN_STEPS = {1: 5, 2: 4}  # the median is over the steps after the warm-up and before the profiled
PROFILED = {1: 1, 2: 0}  # trailing steps under torch.profiler
# the fine-tunes' eval paths on the kernel config (no train step), 256 synthetic samples each; qa_mc's
# 8 text rows (question, answer, 6 subtitles) of 50 tokens fit the 512 sentence positions, of 70 they do not
TASK_RUNS = {
    "qa_mc": ["--task", "qa_mc"],
    "qa_cls": ["--task", "qa_cls", "--qa_dataset", "actnet"],
    "video_cls": ["--task", "video_cls"],
}
QA_TRAIN = dict(steps=2, batch=4, samples=16)  # qa_mc train steps on the kernel-off config (span loss backward)
# CLIP-ViP pretraining: the port's JSON copy of the B/32 preset; the first step warms up and is not timed
PRETRAIN_PRESET = "xpretrain_tpu_torch/configs/pretrain_vip_base_32.json"
PRETRAIN_CLIPVIP_STEPS = 6
PROXY_LAYERS_PER_STEP = 2 * VIDEO_LAYERS  # the video clips' and the images' passes through the 12 layers
# LF-VILA stage 1 from 2-D ImageNet Swin-B (4x4 patches, 7x7 windows) and BERT-large weights
CASCADE = dict(batch=8, steps=4, bert_layers=12)


def fail(msg: str) -> None:
    print(f"FAIL: {msg}", file=sys.stderr, flush=True)
    sys.exit(1)


def check(cond: bool, msg: str) -> None:
    if not cond:
        fail(msg)


@contextlib.contextmanager
def phase(name: str):
    print(f"== {name}", flush=True)
    t0 = time.perf_counter()
    try:
        yield
    except Exception as e:
        print(f"FAIL in phase '{name}': {type(e).__name__}: {e}", file=sys.stderr, flush=True)
        raise
    print(f"== {name}: ok ({time.perf_counter() - t0:.1f} s)", flush=True)


def bf16_ulps(got, want):
    """Largest |got - want| in bf16 ulps of ``want`` (fp32); |want| below
    2^-8 counts as 2^-8."""
    import torch

    mag = want.abs().clamp_min(2.0**-8)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - want) / ulp).abs().max().item()


def qkv(shape: dict, dtype, seed: int = 0, n: int = 3):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    size = (shape["B"], shape["H"], shape["M"] + shape["N"] * shape["L"], shape["D"])
    return [torch.randn(size, device="cuda", generator=g).to(dtype) for _ in range(n)]


def window_inputs(shape: tuple, dtype, seed: int = 0):
    """q, k, v [Bn, H, N, d] in ``dtype``, an fp32 bias [H, N, N] and the
    fp32 mask of ``WINDOW_SHAPES``' kind (or None), on the card."""
    import numpy as np
    import torch
    from xpretrain_tpu_torch.models.lf_vila.swin3d import grouped_window_mask, shifted_window_mask

    Bn, H, N, d, kind = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    q, k, v = (torch.randn(Bn, H, N, d, device="cuda", generator=g).to(dtype) for _ in range(3))
    bias = torch.randn(H, N, N, device="cuda", generator=g)
    if kind is None:
        mask = None
    elif kind[0] == "shifted":
        mask = torch.from_numpy(np.array(shifted_window_mask(*kind[1:]))).cuda()
    elif kind[0] == "grouped":
        mask = torch.from_numpy(np.array(grouped_window_mask(*kind[1:]))).cuda()
    else:
        draw = torch.rand(kind[1], N, N, device="cuda", generator=g)
        mask = torch.where(draw < 0.3, -100.0, 0.0)
    if mask is not None:
        check(tuple(mask.shape) == (mask.shape[0], N, N) and Bn % mask.shape[0] == 0, f"mask {mask.shape}")
    return q, k, v, bias, mask


def bf16_grad_ulps(got, want):
    """Largest |got - want| in bf16 ulps of ``want`` (fp32); |want| below
    2^-8 max|want| counts at that floor."""
    import torch

    mag = want.abs().clamp_min(2.0**-8 * want.abs().max().item())
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - want) / ulp).abs().max().item()


@contextlib.contextmanager
def plain_on_cuda_guard():
    """Record every call on CUDA tensors, while inside, of the plain functions
    the main paths' kernels stand in for: both proxy-attention versions and
    their packed forms, the masked ``dot_attention`` that ``ProxyAttention``
    takes under dropout, the window-attention version and the plain patch
    embed GEMM. Yields the list of calls."""
    from xpretrain_tpu_torch.models.clip_vip import model as clip_vip_model
    from xpretrain_tpu_torch.ops import patchify as pp
    from xpretrain_tpu_torch.ops import proxy_attention as pa
    from xpretrain_tpu_torch.ops import window_attention as wa

    hooks = [(pa, "proxy_attention_plain"), (pa, "proxy_attention_bwd_plain"),
             (pa, "proxy_attention_packed_plain"), (pa, "proxy_attention_packed_bwd_plain"),
             (clip_vip_model, "dot_attention"), (wa, "window_attention_plain"), (pp, "patch_embed_plain")]
    originals = [getattr(module, name) for module, name in hooks]
    calls = []

    def guard(fn):
        def wrapped(q, *args, **kwargs):
            if q.is_cuda:
                calls.append((fn.__name__, tuple(q.shape)))
            return fn(q, *args, **kwargs)
        return wrapped

    for (module, name), fn in zip(hooks, originals):
        setattr(module, name, guard(fn))
    try:
        yield calls
    finally:
        for (module, name), fn in zip(hooks, originals):
            setattr(module, name, fn)


def counted_wrappers() -> dict:
    """Kernel name -> the wrapper whose ``launches`` counts its launches."""
    from xpretrain_tpu_torch.ops import patchify as pp
    from xpretrain_tpu_torch.ops import proxy_attention as pa
    from xpretrain_tpu_torch.ops import window_attention as wa

    return {"proxy_attention_fwd": pa.proxy_attention, "proxy_attention_bwd": pa.proxy_attention_bwd,
            "proxy_attention_packed_fwd": pa.proxy_attention_packed,
            "proxy_attention_packed_bwd": pa.proxy_attention_packed_bwd,
            "patch_embed_u8": pp.fused_patch_embed, "window_attention_fwd": wa.window_attention}


def launch_counts() -> dict[str, int]:
    return {name: fn.launches for name, fn in counted_wrappers().items()}


def reset_launches() -> None:
    for fn in counted_wrappers().values():
        fn.launches = 0


def expected(**launches: int) -> dict[str, int]:
    """Every kernel's expected launch count: 0 unless given."""
    return {name: launches.get(name, 0) for name in KERNELS}


def alternate(fns: dict, iters: int = 200) -> dict[str, list[float]]:
    """ms per call of each of ``fns`` (plain, kernel and any other), timed in
    turns there and back: plain, kernel, ..., ..., kernel, plain (CUDA
    events, ``iters`` calls each)."""
    from xpretrain_tpu_torch.tools.profile_train_step import cuda_time_ms

    order = ["plain", "kernel"] + [name for name in fns if name not in ("plain", "kernel")]
    runs = {name: [] for name in order}
    for name in order + order[::-1]:
        runs[name].append(cuda_time_ms(fns[name], iters=iters))
    return runs


def mean(xs: list[float]) -> float:
    return sum(xs) / len(xs)


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    """The least time the card could take for work of ``flops`` bf16
    operations and ``nbytes`` moved, and which of the two bounds it."""
    t_ops, t_bytes = flops / PEAK_FLOPS * 1e3, nbytes / HBM_BYTES_PER_S * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def packed(t):
    """[B, H, S, D] -> the packed [B, S, H*D] projection layout (a copy)."""
    B, H, S, D = t.shape
    return t.transpose(1, 2).reshape(B, S, H * D).contiguous()


def head_view(t, head_dim: int):
    """The [B, H, S, D] head view of a packed tensor (no copy)."""
    B, S, E = t.shape
    return t.view(B, S, E // head_dim, head_dim).transpose(1, 2)


def patch_inputs(shape: tuple, seed: int = 0):
    """uint8 frames [N, H, W, 3] and a patch kernel [P, P, 3, D] (std 0.02)
    on the card."""
    import torch

    N, H, W, P, D = shape
    g = torch.Generator(device="cuda").manual_seed(seed)
    frames = torch.randint(0, 256, (N, H, W, 3), device="cuda", generator=g, dtype=torch.uint8)
    return frames, torch.randn(P, P, 3, D, device="cuda", generator=g) * 0.02


@contextlib.contextmanager
def timed_train_steps(module=None, name: str = "make_model_train_step"):
    """CUDA-event times of every call, while inside, of the train steps that
    ``module.name`` builds (default: ``GenericTrainer``'s
    ``make_model_train_step``; ``ClipVipTrainer``'s is ``trainer.
    make_train_step``): yields a list that fills with (start, end) event
    pairs, one per step; read them after a synchronize."""
    import torch
    from xpretrain_tpu_torch.train import generic_trainer

    module = module or generic_trainer
    original = getattr(module, name)
    events = []

    def make(*args, **kwargs):
        step = original(*args, **kwargs)

        def timed(state, batch, seed):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = step(state, batch, seed)
            end.record()
            events.append((start, end))
            return out
        return timed

    setattr(module, name, make)
    try:
        yield events
    finally:
        setattr(module, name, original)


@contextlib.contextmanager
def after_call(module, name: str):
    """While inside, each call of ``module.name(.., model, ..)`` (a loader of
    pretrained weights) copies the model's parameters right after it: yields
    the list of (copy: name -> tensor on the model's device, seconds the call
    took on the host clock)."""
    import torch

    original = getattr(module, name)
    copies = []

    def call(*args, **kwargs):
        t0 = time.perf_counter()
        out = original(*args, **kwargs)
        seconds = time.perf_counter() - t0
        model = next(a for a in args if isinstance(a, torch.nn.Module))
        copies.append(({n: p.detach().clone() for n, p in model.named_parameters()}, seconds))
        return out

    setattr(module, name, call)
    try:
        yield copies
    finally:
        setattr(module, name, original)


@contextlib.contextmanager
def snapshot_params():
    """While inside, every ``GenericTrainer`` copies its model's parameters
    as it is built (before any step): yields the list of those copies."""
    from xpretrain_tpu_torch.train import generic_trainer

    original = generic_trainer.GenericTrainer.__init__
    snapshots = []

    def init(self, cfg, model, *args, **kwargs):
        snapshots.append({name: p.detach().clone() for name, p in model.named_parameters()})
        original(self, cfg, model, *args, **kwargs)

    generic_trainer.GenericTrainer.__init__ = init
    try:
        yield snapshots
    finally:
        generic_trainer.GenericTrainer.__init__ = original


def scalars(out_dir: str) -> dict[str, list[float]]:
    """The runner's logged train scalars, by tag, in step order."""
    tags: dict[str, list[float]] = {}
    with open(os.path.join(out_dir, "log", "scalars.jsonl")) as f:
        for row in map(json.loads, f):
            tags.setdefault(row["tag"], []).append(row["value"])
    return tags


def run_pretrain_stage(stage: int, batch: int, out_dir: str, extra: list[str]):
    """One ``run_pretrain_lfvila`` run of ``stage`` on its preset: (state,
    launch counts, plain calls on CUDA, per-step ms, parameter snapshot)."""
    import torch
    from xpretrain_tpu_torch.cli import run_pretrain_lfvila

    torch.cuda.reset_peak_memory_stats()
    steps = PRETRAIN_STEPS[stage]
    profile = ["--profile_steps", str(PROFILED[stage]), "--profile_start_step", str(steps - PROFILED[stage])]
    with snapshot_params() as snapshots, timed_train_steps() as events, plain_on_cuda_guard() as plain_cuda_calls:
        reset_launches()
        state = run_pretrain_lfvila.main([
            "--config", os.path.join(REPO, STAGE_PRESETS[stage]), "--stage", str(stage), "--dummy_data", "1",
            "--device_ingest", "1", "--train_batch_size", str(batch), "--num_train_steps", str(steps),
            "--log_steps", "1", "--save_steps", "1000", "--device", "cuda", "--output_dir", out_dir,
            *(profile if PROFILED[stage] else []), *extra,
        ])
        torch.cuda.synchronize()
        launches = launch_counts()
    ms = [start.elapsed_time(end) for start, end in events]
    return state, launches, list(plain_cuda_calls), ms, snapshots[0]


def report_pretrain_stage(stage: int, batch: int, out_dir: str, launches: dict, plain_cuda_calls: list,
                          ms: list[float], card: str, keys: tuple[str, ...]) -> dict:
    """Print and check one stage's run: no kernel launch and no plain call on
    CUDA (the window kernel is off for training, as in JAX), finite losses
    and gradient norms, the step times and the peak memory."""
    import torch
    from xpretrain_tpu_torch.tools.profile_train_step import median

    print(f"  launches {launches} (expected none: the window kernel is off for training, as in JAX); "
          f"plain path on CUDA: {len(plain_cuda_calls)} calls")
    check(launches == expected(), f"stage {stage}: kernel launches on a training path without kernels")
    check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
    tags = scalars(out_dir)
    steps = PRETRAIN_STEPS[stage]
    for key in ("loss", "grad_norm") + keys:
        values = tags.get(f"train/{key}", [])
        print(f"  {key} {[round(v, 5) for v in values]}")
        check(len(values) == steps and all(math.isfinite(v) for v in values), f"stage {stage}: {key} {values}")
    timed = ms[1:steps - PROFILED[stage]]
    peak = torch.cuda.max_memory_allocated() / 2**30
    print(f"  stage-{stage} train step b={batch}: median {median(timed):.4f} ms (min {min(timed):.4f}, max "
          f"{max(timed):.4f}) over steps 2-{steps - PROFILED[stage]}; every step {[round(x, 2) for x in ms]} ms "
          f"(CUDA events around each step, first = warm-up{', last = profiled' if PROFILED[stage] else ''}) [{card}]")
    print(f"  peak device memory {peak:.2f} GiB (torch.cuda.max_memory_allocated) [{card}]")
    check(all(math.isfinite(x) for x in ms), f"stage {stage}: step times")
    return {"batch": batch, "step_ms": timed, "peak_gib": peak}


def lfvila_5d_config(stage: int):
    """The stage's pretraining model for phase 5d: full widths (Swin3D embed
    128, BERT-large), depth cut to one block per Swin3D stage and one BERT
    layer per BERT stage, dropout and drop-path off (the card's and the
    CPU's generators draw different masks), fp32."""
    import torch
    from xpretrain_tpu_torch.models.bert import BertConfig
    from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaConfig
    from xpretrain_tpu_torch.models.lf_vila.swin3d import Swin3DConfig

    bert = dataclasses.replace(
        BertConfig.bert_large(stage_bounds=(1, 2), type_vocab_size=8, hidden_dropout_prob=0.0,
                              attention_probs_dropout_prob=0.0), num_hidden_layers=3)
    video = Swin3DConfig(depths=(1,) * 6, drop_path_rate=0.0, local_window=4 if stage == 1 else 8)
    return LfVilaConfig(video=video, bert=bert, stage=stage, dtype=torch.float32)


def lfvila_5d_batch(cfg, seed: int, batch: int = 2, sentence_len: int = 50):
    """A numpy batch of ``batch`` u8 clips of 32 frames at 192x320 with
    paragraphs of ``sample_clip`` sentences (and MLM labels in stage 2), and
    explicit MTC clip indices (key, value, other)."""
    import numpy as np

    rng = np.random.default_rng(seed)
    M, L = cfg.sample_clip, sentence_len
    out = {"video_frames": rng.integers(0, 256, size=(batch, cfg.sample_frame, 192, 320, 3), dtype=np.uint8),
           "text_ids": rng.integers(1, cfg.bert.vocab_size, size=(batch, M, L)),
           "attention_mask": (np.arange(L)[None, None] < rng.integers(5, L + 1, size=(batch, M, 1))).astype(np.int64)}
    if cfg.stage == 2:
        out["mlm_labels"] = np.where(rng.random((batch, M * L)) < 0.15,
                                     rng.integers(1, cfg.bert.vocab_size, size=(batch, M * L)), -100)
    perms = np.stack([rng.permutation(M) for _ in range(3 * batch)])
    indices = (perms[:batch, :cfg.num_key], perms[batch:2 * batch, :cfg.num_value], perms[2 * batch:, 0])
    return out, indices


def lfvila_stage1_phase(card: str) -> tuple[dict, dict]:
    """Phase 4e: ``run_pretrain_lfvila --stage 1`` on the stage-1 preset at its
    batch (16, no remat: about 40 GiB), 5 steps; returns (launch counts, step
    times, peak memory and the op-class table of the profiled step)."""
    import torch

    with tempfile.TemporaryDirectory() as out_dir:
        with open(os.path.join(REPO, STAGE_PRESETS[1])) as f:
            batch = json.load(f)["train_batch_size"]
        state, stage1_launches, plain_calls, ms, _ = run_pretrain_stage(1, batch, out_dir, [])
        print(f"  preset {STAGE_PRESETS[1]}, batch {batch}, no remat")
        stage1 = report_pretrain_stage(1, batch, out_dir, stage1_launches, plain_calls, ms, card,
                                       ("ct_global_loss", "ct_time_loss"))
        with open(os.path.join(out_dir, "profile", "op_classes.json")) as f:
            classes = json.load(f)["classes"]
        stage1["op_classes"] = classes
        print(f"  op classes of the profiled step (torch.profiler device time; train/profiling.py) [{card}]:")
        for row in classes:
            print(f"    {row['class']:48s} {row['device_ms_per_step']:10.3f} ms {100 * row['share']:5.1f}% "
                  f"{row['launches_per_step']:8.0f} launches")
        print(f"    device total {sum(r['device_ms_per_step'] for r in classes):.3f} ms of the profiled step")
    return stage1_launches, stage1


def lfvila_stage2_phase(card: str) -> tuple[dict, dict]:
    """Phase 4f: ``run_pretrain_lfvila --stage 2`` on the stage-2 preset with
    Swin3D remat at the preset's batch (48: about 50 GiB), 4 steps; checks
    that the frozen parameters did not move and the others did. Returns
    (launch counts, step times and peak memory)."""
    import torch
    from xpretrain_tpu_torch.models.lf_vila.convert import flax_param_paths

    with tempfile.TemporaryDirectory() as out_dir:
        with open(os.path.join(REPO, STAGE_PRESETS[2])) as f:
            stage2_preset = json.load(f)
        batch = stage2_preset["train_batch_size"]
        state, stage2_launches, plain_calls, ms, start = run_pretrain_stage(
            2, batch, out_dir, ["--gradient_checkpointing", "1"])
        print(f"  preset {STAGE_PRESETS[2]}, batch {batch}, --gradient_checkpointing 1")
        stage2 = report_pretrain_stage(2, batch, out_dir, stage2_launches, plain_calls, ms, card,
                                       ("mlm_loss", "vtm_loss", "mlm_acc", "vtm_acc"))
        # the frozen stage-1 modules did not move, bit for bit; the rest did
        frozen = [pattern.lower() for pattern in stage2_preset["frozen_patterns"]]
        paths = flax_param_paths(state.model)
        moved = {True: [], False: []}
        for name, p in state.model.named_parameters():
            is_frozen = any(pattern in paths[name].lower() for pattern in frozen)
            moved[is_frozen].append((name, not torch.equal(p, start[name])))
        n_frozen = sum(start[n].numel() for n, _ in moved[True])
        n_free = sum(start[n].numel() for n, _ in moved[False])
        print(f"  frozen: {len(moved[True])} tensors ({n_frozen / 1e6:.1f} M values), moved "
              f"{sum(m for _, m in moved[True])}; trained: {len(moved[False])} tensors ({n_free / 1e6:.1f} M), "
              f"moved {sum(m for _, m in moved[False])}")
        check(moved[True] and not any(m for _, m in moved[True]), "a frozen parameter moved")
        check(moved[False] and all(m for _, m in moved[False]),
              f"trained parameters that did not move: {[n for n, m in moved[False] if not m][:5]}")
    return stage2_launches, stage2


def lfvila_finetune_phase(card: str) -> dict:
    """Phase 4g: ``run_tasks_lfvila`` qa_mc, qa_cls (ActivityNet-QA) and
    video_cls on the kernel config with no train step (the eval paths, six
    window launches a video forward), then 2 qa_mc train steps on the
    kernel-off config; returns each run's launch counts."""
    import torch
    from xpretrain_tpu_torch.cli import run_tasks_lfvila

    task_launches = {}
    n_batches = math.ceil(run_tasks_lfvila.DUMMY_SIZE / LFVILA_BATCH)
    for task, args in TASK_RUNS.items():
        with tempfile.TemporaryDirectory() as out_dir:
            t0 = time.perf_counter()
            with plain_on_cuda_guard() as plain_cuda_calls:
                reset_launches()
                report = run_tasks_lfvila.main([
                    "--config", os.path.join(REPO, LFVILA_PRESET), *args, "--dummy_data", "1",
                    "--num_train_steps", "0", "--val_batch_size", str(LFVILA_BATCH), "--device", "cuda",
                    "--output_dir", out_dir,
                ])
                torch.cuda.synchronize()
                task_launches[task] = launch_counts()
            wall = time.perf_counter() - t0
            with open(os.path.join(out_dir, "final_report.json")) as f:
                check(json.load(f)["accuracy"] == report["accuracy"], f"{task}: final_report.json")
        want = expected(window_attention_fwd=WINDOW_BLOCKS * n_batches)
        print(f"  {task}: launches {task_launches[task]} (expected {WINDOW_BLOCKS} window blocks x {n_batches} "
              f"batches, one video forward each); plain path on CUDA: {len(plain_cuda_calls)} calls")
        check(task_launches[task] == want, f"{task} kernel launch counts")
        check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
        print(f"  {task}: accuracy {report['accuracy']:.4f} over {report['n']} samples; eval "
              f"{report['perf']['wall_s']:.2f} s, {report['perf']['clips_per_s']:.2f} clips/s; run wall "
              f"{wall:.1f} s (host clock; model build, synthetic decode and upload included) [{card}]")
        check(report["n"] == run_tasks_lfvila.DUMMY_SIZE and math.isfinite(report["accuracy"])
              and 0.0 <= report["accuracy"] <= 1.0, f"{task}: accuracy {report['accuracy']}")
    # qa_mc's training: fusion, span loss and their backward on the card,
    # the kernel off (its forward has no backward), a smaller synthetic set
    with tempfile.TemporaryDirectory() as out_dir:
        dummy_size, run_tasks_lfvila.DUMMY_SIZE = run_tasks_lfvila.DUMMY_SIZE, QA_TRAIN["samples"]
        try:
            with timed_train_steps() as events, plain_on_cuda_guard() as plain_cuda_calls:
                reset_launches()
                report = run_tasks_lfvila.main([
                    "--config", os.path.join(REPO, STAGE_PRESETS[1]), *TASK_RUNS["qa_mc"], "--dummy_data", "1",
                    "--num_train_steps", str(QA_TRAIN["steps"]), "--train_batch_size", str(QA_TRAIN["batch"]),
                    "--val_batch_size", str(QA_TRAIN["batch"]), "--log_steps", "1", "--save_steps", "1000",
                    "--device", "cuda", "--output_dir", out_dir,
                ])
                torch.cuda.synchronize()
                task_launches["qa_mc_train"] = launch_counts()
        finally:
            run_tasks_lfvila.DUMMY_SIZE = dummy_size
        tags = scalars(out_dir)
    print(f"  qa_mc training, kernel off, b={QA_TRAIN['batch']}: launches {task_launches['qa_mc_train']} "
          f"(expected none); plain path on CUDA: {len(plain_cuda_calls)} calls; steps "
          f"{[round(a.elapsed_time(b), 2) for a, b in events]} ms (CUDA events) [{card}]")
    for key in ("loss", "span_loss", "acc", "span_acc", "grad_norm"):
        values = tags.get(f"train/{key}", [])
        print(f"  qa_mc train {key} {[round(v, 5) for v in values]}")
        check(len(values) == QA_TRAIN["steps"] and all(math.isfinite(v) for v in values), f"qa_mc train {key}")
    check(task_launches["qa_mc_train"] == expected() and not plain_cuda_calls, "qa_mc training launches")
    check(all(tags["train/loss"][i] > tags["train/span_loss"][i] > 0 for i in range(QA_TRAIN["steps"])),
          "qa_mc: the total holds the span loss")
    check(math.isfinite(report["accuracy"]) and 0.0 <= report["accuracy"] <= 1.0, "qa_mc train accuracy")
    return task_launches


def lfvila_card_vs_cpu_phase() -> None:
    """Phase 5d: one fp32 ``LfVilaPretrain`` train step per stage on the card
    and on the CPU from the same weights and batch (explicit MTC clips), held
    to phase 5b's bars."""
    import torch
    from xpretrain_tpu_torch.models.lf_vila.convert import flax_param_paths
    from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaPretrain
    from xpretrain_tpu_torch.optim.optimizer import NO_DECAY_LFVILA, build_optimizer
    from xpretrain_tpu_torch.optim.schedules import get_schedule
    from xpretrain_tpu_torch.parallel.train_step import TrainState, batch_to_device, make_model_train_step

    lr = 1e-5
    for stage in (1, 2):
        cfg = lfvila_5d_config(stage)
        model_cpu = LfVilaPretrain(cfg).init_weights(torch.Generator().manual_seed(stage))
        model_gpu = copy.deepcopy(model_cpu).cuda()
        batch, indices = lfvila_5d_batch(cfg, seed=10 + stage)
        metrics = {}
        for device, model in (("cuda", model_gpu), ("cpu", model_cpu)):
            optimizer, _ = build_optimizer(dict(model.named_parameters()), get_schedule("constant", lr, 10),
                                           weight_decay=0.05, no_decay_patterns=NO_DECAY_LFVILA,
                                           paths=flax_param_paths(model))
            step = make_model_train_step(
                lambda m, b, g: m(b["video_frames"], b["text_ids"], b["attention_mask"],
                                  mlm_labels=b.get("mlm_labels"), generator=g, mtc_indices=indices),
                device, metric_keys=("ct_global_loss", "ct_time_loss", "mlm_loss", "vtm_loss"))
            t0 = time.perf_counter()
            _, m = step(TrainState(step=0, model=model, optimizer=optimizer), batch_to_device(device)(batch), 0)
            metrics[device] = {k: v.item() for k, v in m.items()}
            print(f"  stage {stage} on {device}: {metrics[device]} ({time.perf_counter() - t0:.1f} s)")
        loss_err = abs(metrics["cuda"]["loss"] - metrics["cpu"]["loss"])
        norm_err = abs(metrics["cuda"]["grad_norm"] / metrics["cpu"]["grad_norm"] - 1)
        cpu_state = model_cpu.state_dict()
        diffs = torch.cat([(v.cpu() - cpu_state[k]).abs().flatten() for k, v in model_gpu.state_dict().items()])
        print(f"  stage {stage}: loss diff {loss_err:.3e} (tol 1e-4), grad_norm rel diff {norm_err:.3e} "
              f"(tol 1e-3); params after the step: max diff {diffs.max().item():.3e} (tol 2 lr = {2 * lr:.0e})")
        check(all(math.isfinite(v) for v in metrics["cuda"].values()), f"stage {stage}: card metrics not finite")
        check(loss_err <= 1e-4, f"stage {stage}: train loss card vs cpu {loss_err}")
        check(norm_err <= 1e-3, f"stage {stage}: grad_norm card vs cpu rel {norm_err}")
        check(diffs.max().item() <= 2 * lr, f"stage {stage}: params after one step differ by more than 2 lr")
        del model_cpu, model_gpu, cpu_state, diffs


def clip_weights_file(path: str, seed: int = 0) -> dict:
    """Write a released-style CLIP-ViP B/32 checkpoint of a seeded port model
    to ``path``: HF keys under ``clipmodel.``, the patch weight as a Conv2d
    weight [768, 3, 32, 32], an 8-row temporal embedding (the model holds 12).
    Returns the state dict as written, without the prefix."""
    import torch
    from xpretrain_tpu_torch.models.clip_vip.convert import torch_clip_state_dict
    from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel

    model = CLIPViPModel(CLIPVipConfig.base_patch32())
    model.init_weights(torch.Generator().manual_seed(seed))
    sd = torch_clip_state_dict(model)
    g = torch.Generator().manual_seed(seed + 1)
    width = model.config.vision.hidden_size
    sd["vision_model.embeddings.temporal_embedding"] = 0.02 * torch.randn(1, 8, width, generator=g)
    torch.save({"clipmodel." + k: v for k, v in sd.items()}, path)
    return sd


def clipvip_pretrain_phase(card: str) -> tuple[dict, dict]:
    """Phase 4h: ``run_pretrain_clipvip`` on the B/32 pretraining preset for
    ``PRETRAIN_CLIPVIP_STEPS`` steps from a written ``--clip_weights`` file;
    returns (launch counts, step times and peak memory)."""
    import numpy as np
    import torch
    from xpretrain_tpu_torch.cli import run_pretrain_clipvip
    from xpretrain_tpu_torch.models.clip_vip.convert import _interp_temporal
    from xpretrain_tpu_torch.train import trainer as trainer_module
    from xpretrain_tpu_torch.tools.profile_train_step import median

    steps = PRETRAIN_CLIPVIP_STEPS
    with tempfile.TemporaryDirectory() as out_dir:
        path = os.path.join(out_dir, "clipvip_b32.pt")
        t0 = time.perf_counter()
        written = clip_weights_file(path)
        print(f"  wrote {path.split('/')[-1]}: {len(written)} tensors, "
              f"{sum(v.numel() for v in written.values()) / 1e6:.1f} M values ({time.perf_counter() - t0:.1f} s)")
        with open(os.path.join(REPO, PRETRAIN_PRESET)) as f:
            preset = json.load(f)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with after_call(run_pretrain_clipvip, "load_pretrained") as loaded, \
                timed_train_steps(trainer_module, "make_train_step") as events, \
                plain_on_cuda_guard() as plain_cuda_calls:
            reset_launches()
            state = run_pretrain_clipvip.main([
                "--config", os.path.join(REPO, PRETRAIN_PRESET), "--dummy_data", "1",
                "--clip_weights", path, "--num_train_steps", str(steps), "--log_steps", "1",
                "--save_steps", "1000", "--valid_steps", "1000", "--device", "cuda", "--output_dir", out_dir,
            ])
            torch.cuda.synchronize()
            launches = launch_counts()
        wall = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        tags = scalars(out_dir)
    check(state.step == steps and len(loaded) == 1, f"pretraining ran {state.step} steps, loaded {len(loaded)} times")
    # the loaded model against the file: copies, the patch weight in the
    # port's layout, the temporal embedding interpolated 8 -> 12 rows
    got = {k: v.cpu() for k, v in loaded[0][0].items()}
    print(f"  load_pretrained (read, merge into the model on the card): {loaded[0][1]:.2f} s [{card}]")
    temporal = _interp_temporal(written["vision_model.embeddings.temporal_embedding"].numpy(),
                                preset["clip_vision_additional_config"]["temporal_size"])
    pairs = {
        "text_model.embeddings.token_embedding.weight": written["text_model.embeddings.token_embedding.weight"],
        "vision_model.encoder.layers.11.self_attn.q_proj.weight":
            written["vision_model.encoder.layers.11.self_attn.q_proj.weight"],
        "logit_scale": written["logit_scale"],
        "vision_model.embeddings.patch_embedding.weight":
            written["vision_model.embeddings.patch_embedding.weight"].permute(2, 3, 1, 0),
        "vision_model.embeddings.temporal_embedding": torch.from_numpy(temporal.astype(np.float32)),
    }
    for key, want in pairs.items():
        same = torch.equal(got[key], want)
        print(f"  loaded {key} {tuple(got[key].shape)}: equal to the file's: {same}")
        check(same, f"{key} is not the file's")
    check(all(torch.equal(got[k], written[k]) for k in written if k not in pairs), "a loaded parameter is not the file's")
    want = expected(proxy_attention_fwd=PROXY_LAYERS_PER_STEP * steps, proxy_attention_bwd=PROXY_LAYERS_PER_STEP * steps)
    print(f"  launches {launches} (expected {want}: {PROXY_LAYERS_PER_STEP} layers a step, {VIDEO_LAYERS} for the "
          f"video clips and {VIDEO_LAYERS} for the images, forward and backward); plain path on CUDA: "
          f"{len(plain_cuda_calls)} calls")
    check(launches == want, "pretraining kernel launch counts")
    check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
    for key in ("loss", "grad_norm"):
        values = tags.get(f"train/{key}", [])
        print(f"  {key} {[round(v, 5) for v in values]}")
        check(len(values) == steps and all(math.isfinite(v) for v in values), f"pretraining {key} {values}")
    ms = [start.elapsed_time(end) for start, end in events]
    timed = ms[1:]
    sps = tags.get("train/steps_per_s", [])
    print(f"  preset {PRETRAIN_PRESET}: b={preset['train_batch_size']}, {preset['num_frm']} frames at "
          f"{preset['crop_img_size']}, bf16, {preset['loss_name']}")
    print(f"  B/32 pretraining step b={preset['train_batch_size']}: median {median(timed):.4f} ms (min "
          f"{min(timed):.4f}, max {max(timed):.4f}) over steps 2-{steps}; every step {[round(x, 2) for x in ms]} ms "
          f"(CUDA events around each step, the first a warm-up) [{card}]")
    print(f"  steps/s on the host clock, synthetic data and its host transform included: "
          f"{[round(x, 3) for x in sps]}; run wall {wall:.1f} s [{card}]")
    print(f"  peak device memory {peak:.2f} GiB (torch.cuda.max_memory_allocated) [{card}]")
    check(all(math.isfinite(x) for x in ms), "pretraining step times")
    del state, loaded, got, written
    return launches, {"step_ms": timed, "peak_gib": peak}


def swin2d_state_dict(g, embed_dim=128, depths=(2, 2, 18, 2), heads=(4, 8, 16, 32), window=7, patch=4):
    """An ImageNet Swin-B state dict (torch keys, 4 stages, 4x4 patches, 7x7
    windows), random from ``g``: what ``--swin_weight`` takes with
    ``--pretrained_2d 1``."""
    import torch

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    top = embed_dim * 2 ** (len(depths) - 1)
    sd = {"patch_embed.proj.weight": t(embed_dim, 3, patch, patch), "patch_embed.proj.bias": t(embed_dim),
          "patch_embed.norm.weight": 1 + t(embed_dim), "patch_embed.norm.bias": t(embed_dim),
          "norm.weight": 1 + t(top), "norm.bias": t(top)}
    side = 2 * window - 1
    for i, (depth, h) in enumerate(zip(depths, heads)):
        c = embed_dim * 2**i
        for b in range(depth):
            p = f"layers.{i}.blocks.{b}."
            for name, shape in (("norm1.weight", (c,)), ("norm1.bias", (c,)), ("attn.qkv.weight", (3 * c, c)),
                                ("attn.qkv.bias", (3 * c,)), ("attn.proj.weight", (c, c)), ("attn.proj.bias", (c,)),
                                ("attn.relative_position_bias_table", (side * side, h)), ("norm2.weight", (c,)),
                                ("norm2.bias", (c,)), ("mlp.fc1.weight", (4 * c, c)), ("mlp.fc1.bias", (4 * c,)),
                                ("mlp.fc2.weight", (c, 4 * c)), ("mlp.fc2.bias", (c,))):
                sd[p + name] = t(*shape) + (1 if name.startswith("norm") and name.endswith("weight") else 0)
        if i < len(depths) - 1:  # 2-D Swin downsamples after stages 0..2
            sd[f"layers.{i}.downsample.reduction.weight"] = t(2 * c, 4 * c)
            sd[f"layers.{i}.downsample.norm.weight"] = 1 + t(4 * c)
            sd[f"layers.{i}.downsample.norm.bias"] = t(4 * c)
    return sd


def bert_state_dict(g, layers: int, hidden=1024, intermediate=4096, vocab=30522, positions=512, types=2):
    """An HF BERT-large state dict (``bert.`` keys, ``layers`` encoder layers
    and the pooler), random from ``g``: what ``--bert_weight`` takes."""
    import torch

    def t(*shape):
        return torch.randn(*shape, generator=g) * 0.02

    sd = {"bert.embeddings.word_embeddings.weight": t(vocab, hidden),
          "bert.embeddings.position_embeddings.weight": t(positions, hidden),
          "bert.embeddings.token_type_embeddings.weight": t(types, hidden),
          "bert.embeddings.LayerNorm.weight": 1 + t(hidden), "bert.embeddings.LayerNorm.bias": t(hidden),
          "bert.pooler.dense.weight": t(hidden, hidden), "bert.pooler.dense.bias": t(hidden)}
    for i in range(layers):
        p = f"bert.encoder.layer.{i}."
        for name in ("attention.self.query", "attention.self.key", "attention.self.value", "attention.output.dense"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = t(hidden, hidden), t(hidden)
        sd[p + "intermediate.dense.weight"], sd[p + "intermediate.dense.bias"] = t(intermediate, hidden), t(intermediate)
        sd[p + "output.dense.weight"], sd[p + "output.dense.bias"] = t(hidden, intermediate), t(hidden)
        for name in ("attention.output.LayerNorm", "output.LayerNorm"):
            sd[p + name + ".weight"], sd[p + name + ".bias"] = 1 + t(hidden), t(hidden)
    return sd


def lfvila_cascade_phase(card: str) -> dict:
    """Phase 4i: ``run_pretrain_lfvila --stage 1`` on the stage-1 preset from
    a written 2-D Swin-B (``--swin_weight``, ``--pretrained_2d 1``) and
    BERT-large (``--bert_weight``), ``CASCADE["steps"]`` steps; returns the
    launch counts."""
    import torch
    from xpretrain_tpu_torch.cli import run_pretrain_lfvila

    with tempfile.TemporaryDirectory() as out_dir:
        t0 = time.perf_counter()
        g = torch.Generator().manual_seed(21)
        swin, bert = swin2d_state_dict(g), bert_state_dict(g, CASCADE["bert_layers"])
        swin_path, bert_path = os.path.join(out_dir, "swin_base_2d.pth"), os.path.join(out_dir, "bert_large.bin")
        torch.save({"model": swin}, swin_path)
        torch.save(bert, bert_path)
        print(f"  wrote a 2-D Swin-B ({sum(v.numel() for v in swin.values()) / 1e6:.1f} M values) and BERT-large's "
              f"first {CASCADE['bert_layers']} layers ({sum(v.numel() for v in bert.values()) / 1e6:.1f} M values) "
              f"({time.perf_counter() - t0:.1f} s)")
        t0 = time.perf_counter()
        with after_call(run_pretrain_lfvila, "load_lfvila_cascade") as loaded, \
                timed_train_steps() as events, plain_on_cuda_guard() as plain_cuda_calls:
            reset_launches()
            state = run_pretrain_lfvila.main([
                "--config", os.path.join(REPO, STAGE_PRESETS[1]), "--stage", "1", "--dummy_data", "1",
                "--device_ingest", "1", "--train_batch_size", str(CASCADE["batch"]),
                "--num_train_steps", str(CASCADE["steps"]), "--log_steps", "1", "--save_steps", "1000",
                "--swin_weight", swin_path, "--bert_weight", bert_path, "--pretrained_2d", "1",
                "--device", "cuda", "--output_dir", out_dir,
            ])
            torch.cuda.synchronize()
            launches = launch_counts()
        wall = time.perf_counter() - t0
        tags = scalars(out_dir)
    check(state.step == CASCADE["steps"] and len(loaded) == 1, "stage 1 from the cascade: steps or loads")
    got = {k: v.cpu() for k, v in loaded[0][0].items()}
    # BERT: copied; the 2-D patch kernel 4x4 tiled to 8x8 (and kd=1), / 4
    inflated = swin["patch_embed.proj.weight"][:, :, None].repeat(1, 1, 1, 2, 2) / 4
    table = got["video_encoder.layers_2_blocks_0.attn.relative_position_bias_table"]
    spatial = 5 * 9  # stage 2's (8, 3, 5) window: (2*3-1) x (2*5-1) offsets, tiled 2*8-1 times over time
    checks = {
        "text_encoder.embeddings.word_embeddings.weight = the file's":
            torch.equal(got["text_encoder.embeddings.word_embeddings.weight"],
                        bert["bert.embeddings.word_embeddings.weight"]),
        "text_encoder.encoder.layer_11.output_dense.weight = the file's, transposed twice":
            torch.equal(got["text_encoder.encoder.layer_11.output_dense.weight"],
                        bert["bert.encoder.layer.11.output.dense.weight"]),
        "video_encoder.patch_embed.proj.weight = the 2-D kernel inflated":
            torch.allclose(got["video_encoder.patch_embed.proj.weight"], inflated, atol=1e-7, rtol=0),
        "video_encoder.layers_0_blocks_0.attn.qkv.weight = the 2-D block's":
            torch.equal(got["video_encoder.layers_0_blocks_0.attn.qkv.weight"], swin["layers.0.blocks.0.attn.qkv.weight"]),
        f"stage-2 bias table {tuple(table.shape)} tiled over time":
            table.shape[0] == 15 * spatial and all(torch.equal(table[:spatial], table[i * spatial:(i + 1) * spatial])
                                                   for i in range(15)),
    }
    for what, ok in checks.items():
        print(f"  loaded {what}: {ok}")
        check(ok, f"4i: {what}")
    print(f"  launches {launches} (expected none: the window kernel is off for training, as in JAX); plain path "
          f"on CUDA: {len(plain_cuda_calls)} calls")
    check(launches == expected() and not plain_cuda_calls, "stage 1 from the cascade: launches")
    for key in ("loss", "grad_norm", "ct_global_loss", "ct_time_loss"):
        values = tags.get(f"train/{key}", [])
        print(f"  {key} {[round(v, 5) for v in values]}")
        check(len(values) == CASCADE["steps"] and all(math.isfinite(v) for v in values), f"4i {key} {values}")
    ms = [start.elapsed_time(end) for start, end in events]
    print(f"  load_lfvila_cascade (read, inflate, convert, merge into the model on the card): {loaded[0][1]:.2f} s; "
          f"steps {[round(x, 2) for x in ms]} ms (CUDA events, the first a warm-up); run wall {wall:.1f} s at "
          f"b={CASCADE['batch']} (host clock; model build and synthetic data included) [{card}]")
    check(len(ms) == CASCADE["steps"] and all(math.isfinite(x) for x in ms), "4i step times")
    del state, loaded, got, swin, bert
    return launches


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device: this smoke test runs on an NVIDIA card only")
    sys.path.insert(0, REPO)
    try:
        from xpretrain_tpu_torch.cli import run_retrieval_clipvip, run_tasks_lfvila
        from xpretrain_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD, normalize
        from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel
        from xpretrain_tpu_torch.models.common import dot_attention
        from xpretrain_tpu_torch.ops import _kernels
        from xpretrain_tpu_torch.models.lf_vila.tasks import LfVilaRetrieval
        from xpretrain_tpu_torch.ops import patchify as pp
        from xpretrain_tpu_torch.ops import proxy_attention as pa
        from xpretrain_tpu_torch.ops import window_attention as wa
        from xpretrain_tpu_torch.parallel.train_step import batch_to_device
        from xpretrain_tpu_torch.serving.towers import LfVilaTowers, RetrievalTowers
        from xpretrain_tpu_torch.tools.profile_train_step import (
            captions, device_ms, median, spread, synthetic_batch, time_train_step, train_step_parts, window_ms,
        )
    except ImportError as e:
        fail(f"the port is not beside this script ({e})")
    import numpy as np

    with phase("1 card"):
        card = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, check=True, timeout=60,
        ).stdout.strip().splitlines()[0]
        print(card)
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
              f"matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32} "
              f"cudnn.allow_tf32={torch.backends.cudnn.allow_tf32}")

    with phase("2 build"):
        t0 = time.perf_counter()
        _kernels.load_library()
        lib = _kernels.library_path()
        sources = ", ".join(sorted({src for src, _ in KERNELS.values()}))
        print(f"built {lib.relative_to(REPO)} from {sources} "
              f"({' '.join(_kernels.NVCC_FLAGS[:2])}) in {time.perf_counter() - t0:.1f} s")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")
        # bf16 runs on the tensor cores, fp32 on the CUDA cores; the attention
        # kernels at the main paths' head dims
        resources = _kernels.kernel_resources(B32["D"], WINDOW_SHAPES["s3"][3])
        for row in resources:
            dynamic = f"{row['dynamic_smem']} B dynamic" if "dynamic_smem" in row else "dynamic by tile"
            print(f"  {row['kernel']:44s} {row['dtype']:8s}: {row['registers']} registers, "
                  f"spills {row.get('spill_stores', 0)}/{row.get('spill_loads', 0)} B (stores/loads), "
                  f"shared memory {row['static_smem']} B static + {dynamic}, {row['hmma']} HMMA in its SASS")
        check(all(row["hmma"] > 0 for row in resources if row["tensor_cores"]),
              "a bf16 tensor-core kernel has no tensor-core instruction")

    with phase("3 kernel vs plain"):
        errors = {}
        for name, s in CHECK_SHAPES.items():
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = qkv(s, dtype)
                before = pa.proxy_attention.launches
                got = pa.proxy_attention(q, k, v, s["M"], s["N"], s["L"], s["D"] ** -0.5)
                torch.cuda.synchronize()
                check(pa.proxy_attention.launches == before + 1, f"{name}: launch not counted")
                want = pa.proxy_attention_plain(q, k, v, s["M"], s["L"], s["D"] ** -0.5)
                dt = str(dtype).split(".")[-1]
                err = (got.float() - want.float()).abs().max().item()
                errors[(name, dt)] = err
                line = f"  {name:10s} {dt:8s} {s} max_abs {err:.3e} tol {TOL[dt]:.0e}"
                check(got.dtype == dtype and got.shape == q.shape, f"{name} {dt}: output dtype/shape")
                check(math.isfinite(err) and err <= TOL[dt], f"{name} {dt}: max_abs {err} > {TOL[dt]}")
                if dtype == torch.bfloat16:
                    # The bf16 plain version rounds P to bf16 before PV, so its
                    # error floor hides a kernel that accumulates in bf16; the
                    # fp32 plain version of the same inputs leaves only the
                    # kernel's output rounding, at most half an ulp.
                    exact = pa.proxy_attention_plain(q.float(), k.float(), v.float(), s["M"], s["L"],
                                                     s["D"] ** -0.5)
                    ulps = bf16_ulps(got, exact)
                    line += (f"; vs fp32 plain max_abs {(got.float() - exact).abs().max().item():.3e}, "
                             f"{ulps:.3f} ulp (tol {BF16_MAX_ULP:.0f})")
                    check(ulps <= BF16_MAX_ULP, f"{name} bf16: {ulps} ulp from the fp32 plain version")
                # the LSE the forward saves for the backward (when a gradient follows)
                with_lse, lse = pa._launch_fwd(q, k, v, s["M"], s["N"], s["L"], s["D"] ** -0.5, with_lse=True)
                lse_err = (lse - pa.proxy_attention_lse_plain(q.float(), k.float(), s["M"], s["L"],
                                                              s["D"] ** -0.5)).abs().max().item()
                line += f"; LSE max_abs {lse_err:.3e} (tol {LSE_TOL:.0e})"
                check(torch.equal(with_lse, got), f"{name} {dt}: the output changes when the LSE is saved")
                check(lse.dtype == torch.float32 and lse.shape == q.shape[:3], f"{name} {dt}: LSE dtype/shape")
                check(math.isfinite(lse_err) and lse_err <= LSE_TOL, f"{name} {dt}: LSE max_abs {lse_err}")
                print(line)

    with phase("3b backward kernel vs plain"):
        bwd_errors = {}
        for name, s in {**CHECK_SHAPES, "b32_train": B32_TRAIN}.items():
            scale = s["D"] ** -0.5
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, d_out = qkv(s, dtype, seed=1, n=4)
                before = pa.proxy_attention_bwd.launches
                alone = pa.proxy_attention_bwd(q, k, v, d_out, s["M"], s["N"], s["L"], scale)
                torch.cuda.synchronize()
                check(pa.proxy_attention_bwd.launches == before + 1, f"{name}: backward launch not counted")
                # as autograd calls it: on the LSE the forward saved
                _, lse = pa._launch_fwd(q, k, v, s["M"], s["N"], s["L"], scale, with_lse=True)
                runs = {"alone": (alone, pa.proxy_attention_bwd(q, k, v, d_out, s["M"], s["N"], s["L"], scale)),
                        "forward's LSE": tuple(pa._launch_bwd(q, k, v, d_out, s["M"], s["N"], s["L"], scale, lse=lse)
                                               for _ in range(2))}
                torch.cuda.synchronize()
                # the fp32 plain gradients of the same inputs: for bf16 that
                # leaves the kernel's one rounding at the store
                want = pa.proxy_attention_bwd_plain(*(t.float() for t in (q, k, v, d_out)),
                                                    s["M"], s["L"], scale)
                dt = str(dtype).split(".")[-1]
                line = f"  {name:10s} {dt:8s}"
                for mode, (got, again) in runs.items():
                    for g, w, gname in zip(got, want, ("dq", "dk", "dv")):
                        check(g.dtype == dtype and g.shape == q.shape, f"{name} {dt} {gname}: dtype/shape")
                    check(all(torch.equal(a, b) for a, b in zip(got, again)),
                          f"{name} {dt} {mode}: two calls differ (the backward is not deterministic)")
                    err = max((g.float() - w).abs().max().item() for g, w in zip(got, want))
                    bwd_errors[(name, dt, mode)] = err
                    line += f" {mode}: max_abs {err:.3e}"
                    check(math.isfinite(err), f"{name} {dt} {mode}: backward not finite")
                    if dtype == torch.float32:
                        line += f" (tol {BWD_TOL_FP32:.0e})"
                        check(err <= BWD_TOL_FP32, f"{name} fp32 backward {mode}: max_abs {err} > {BWD_TOL_FP32}")
                    else:
                        ulps = max(bf16_grad_ulps(g, w) for g, w in zip(got, want))
                        line += f", {ulps:.3f} ulp of the fp32 plain gradients (tol {BWD_MAX_ULP:.0f})"
                        check(ulps <= BWD_MAX_ULP, f"{name} bf16 backward {mode}: {ulps} ulp")
                    line += ";"
                same = all(torch.equal(a, b) for a, b in zip(*(got for got, _ in runs.values())))
                print(f"{line} two calls bit-identical; alone bit-equal to with the forward's LSE: {same}")
                del q, k, v, d_out, alone, runs, want
        # gradcheck-style: the kernels' gradient through proxy_attention is
        # autograd's through the plain forward (fp32, the tiny shape)
        s = CHECK_SHAPES["tiny"]
        q, k, v, d_out = qkv(s, torch.float32, seed=2, n=4)
        leaves = [t.clone().requires_grad_() for t in (q, k, v)]
        before = pa.proxy_attention_bwd.launches
        pa.proxy_attention(*leaves, s["M"], s["N"], s["L"], s["D"] ** -0.5).backward(d_out)
        torch.cuda.synchronize()
        check(pa.proxy_attention_bwd.launches == before + 1, "autograd did not launch the backward kernel")
        ref = [t.clone().requires_grad_() for t in (q, k, v)]
        pa.proxy_attention_plain(*ref, s["M"], s["L"], s["D"] ** -0.5).backward(d_out)
        err = max((a.grad - b.grad).abs().max().item() for a, b in zip(leaves, ref))
        print(f"  autograd through the kernels vs through the plain forward (tiny, fp32): "
              f"max_abs {err:.3e} (tol {BWD_TOL_FP32:.0e})")
        check(err <= BWD_TOL_FP32, f"kernel autograd vs plain autograd: {err}")

    with phase("3c window kernel vs plain"):
        win_errors = {}
        for name, shape in WINDOW_SHAPES.items():
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v, bias, mask = window_inputs(shape, dtype)
                before = wa.window_attention.launches
                got = wa.window_attention(q, k, v, bias, mask)
                torch.cuda.synchronize()
                check(wa.window_attention.launches == before + 1, f"{name}: launch not counted")
                want = wa.window_attention_plain(q, k, v, bias, mask)
                dt = str(dtype).split(".")[-1]
                err = (got.float() - want.float()).abs().max().item()
                win_errors[(name, dt)] = err
                line = (f"  {name:10s} {dt:8s} [Bn,H,N,d]={list(shape[:4])} mask "
                        f"{None if mask is None else list(mask.shape)} max_abs {err:.3e} tol {TOL[dt]:.0e}")
                check(got.dtype == dtype and got.shape == q.shape, f"{name} {dt}: output dtype/shape")
                check(math.isfinite(err) and err <= TOL[dt], f"{name} {dt}: max_abs {err} > {TOL[dt]}")
                if dtype == torch.bfloat16:
                    # as in phase 3: against the fp32 plain version of the same
                    # inputs only the kernel's output rounding is left
                    exact = wa.window_attention_plain(q.float(), k.float(), v.float(), bias, mask)
                    ulps = bf16_ulps(got, exact)
                    line += f"; vs fp32 plain {ulps:.3f} ulp (tol {BF16_MAX_ULP:.0f})"
                    check(ulps <= BF16_MAX_ULP, f"{name} bf16: {ulps} ulp from the fp32 plain version")
                print(line)
                del q, k, v, bias, mask, got, want
        # the model's q/k/v: views of one fused [Bn, N, 3, H, d] projection,
        # read in place through their strides
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, bias, mask = window_inputs(WINDOW_SHAPES["s3_shifted"], dtype, seed=1)
            views = torch.stack([q, k, v]).permute(1, 3, 0, 2, 4).contiguous().permute(2, 0, 3, 1, 4)
            check(not views[0].is_contiguous(), "the qkv views are contiguous")
            before = wa.window_attention.launches
            got = wa.window_attention(views[0], views[1], views[2], bias, mask)
            torch.cuda.synchronize()
            check(wa.window_attention.launches == before + 1, "strided: launch not counted")
            same = torch.equal(got, wa.window_attention(q, k, v, bias, mask))
            exact = wa.window_attention_plain(q.float(), k.float(), v.float(), bias, mask)
            dt = str(dtype).split(".")[-1]
            err = (got.float() - exact).abs().max().item()
            win_errors[("s3_shifted_views", dt)] = err
            line = (f"  s3_shifted on qkv views (strides {views[0].stride()}) {dt:8s} vs fp32 plain max_abs "
                    f"{err:.3e}; bit-equal to the contiguous call: {same}")
            check(same, f"strided {dt}: the views give another result than the contiguous tensors")
            if dtype == torch.float32:
                check(err <= TOL[dt], f"strided fp32: max_abs {err} > {TOL[dt]}")
            else:
                ulps = bf16_ulps(got, exact)
                line += f", {ulps:.3f} ulp (tol {BF16_MAX_ULP:.0f})"
                check(ulps <= BF16_MAX_ULP, f"strided bf16: {ulps} ulp from the fp32 plain version")
            print(line)
            del q, k, v, bias, mask, views, got, exact

    with phase("3d packed proxy attention (strided kernels) vs plain and vs the [B,H,S,D] kernels"):
        packed_errors = {}
        for name, s in CHECK_SHAPES.items():
            D, scale = s["D"], s["D"] ** -0.5
            for dtype in (torch.float32, torch.bfloat16):
                q, k, v = qkv(s, dtype)
                pq, pk, pv = (packed(t) for t in (q, k, v))
                before = pa.proxy_attention_packed.launches
                got = pa.proxy_attention_packed(pq, pk, pv, s["M"], s["N"], s["L"], scale, D)
                torch.cuda.synchronize()
                check(pa.proxy_attention_packed.launches == before + 1, f"{name}: packed launch not counted")
                check(got.dtype == dtype and got.shape == pq.shape, f"{name}: packed output dtype/shape")
                same = torch.equal(got, packed(pa.proxy_attention(q, k, v, s["M"], s["N"], s["L"], scale)))
                want = pa.proxy_attention_packed_plain(pq, pk, pv, s["M"], s["L"], scale, D)
                dt = str(dtype).split(".")[-1]
                err = (got.float() - want.float()).abs().max().item()
                packed_errors[(name, dt)] = err
                line = (f"  forward {name:10s} {dt:8s} max_abs {err:.3e} tol {TOL[dt]:.0e}; "
                        f"bit-equal to the [B,H,S,D] kernel: {same}")
                check(math.isfinite(err) and err <= TOL[dt], f"{name} {dt} packed: max_abs {err} > {TOL[dt]}")
                if dtype == torch.bfloat16:
                    exact = pa.proxy_attention_packed_plain(pq.float(), pk.float(), pv.float(), s["M"], s["L"],
                                                            scale, D)
                    ulps = bf16_ulps(got, exact)
                    line += f"; vs fp32 plain {ulps:.3f} ulp (tol {BF16_MAX_ULP:.0f})"
                    check(ulps <= BF16_MAX_ULP, f"{name} bf16 packed: {ulps} ulp from the fp32 plain version")
                print(line)
        s = B32_TRAIN
        D, scale = s["D"], s["D"] ** -0.5
        for dtype in (torch.float32, torch.bfloat16):
            q, k, v, d_out = qkv(s, dtype, seed=1, n=4)
            pq, pk, pv, pd = (packed(t) for t in (q, k, v, d_out))
            before = pa.proxy_attention_packed_bwd.launches
            got = pa.proxy_attention_packed_bwd(pq, pk, pv, pd, s["M"], s["N"], s["L"], scale, D)
            torch.cuda.synchronize()
            check(pa.proxy_attention_packed_bwd.launches == before + 1, "packed backward launch not counted")
            same = all(torch.equal(g, packed(w)) for g, w in
                       zip(got, pa.proxy_attention_bwd(q, k, v, d_out, s["M"], s["N"], s["L"], scale)))
            want = pa.proxy_attention_packed_bwd_plain(*(t.float() for t in (pq, pk, pv, pd)), s["M"], s["L"],
                                                       scale, D)
            dt = str(dtype).split(".")[-1]
            for g, gname in zip(got, ("dq", "dk", "dv")):
                check(g.dtype == dtype and g.shape == pq.shape, f"packed {dt} {gname}: dtype/shape")
            err = max((g.float() - w).abs().max().item() for g, w in zip(got, want))
            packed_errors[("b32_train_bwd", dt)] = err
            line = f"  backward b32_train  {dt:8s} max_abs {err:.3e}"
            check(math.isfinite(err), f"packed {dt}: backward not finite")
            if dtype == torch.float32:
                line += f" (tol {BWD_TOL_FP32:.0e})"
                check(err <= BWD_TOL_FP32, f"packed fp32 backward: max_abs {err} > {BWD_TOL_FP32}")
            else:
                ulps = max(bf16_grad_ulps(g, w) for g, w in zip(got, want))
                line += f", {ulps:.3f} ulp of the fp32 plain gradients (tol {BWD_MAX_ULP:.0f})"
                check(ulps <= BWD_MAX_ULP, f"packed bf16 backward: {ulps} ulp")
            print(line + f"; bit-equal to the [B,H,S,D] kernel: {same}")
            del q, k, v, d_out, pq, pk, pv, pd, got, want
        # autograd through the packed entry on the card against autograd of
        # the plain path (fp32, the tiny shape): a strided output gradient
        s = CHECK_SHAPES["tiny"]
        leaves = [packed(t).requires_grad_() for t in qkv(s, torch.float32, seed=2)]
        ref = [t.detach().clone().requires_grad_() for t in leaves]
        weight = packed(qkv(s, torch.float32, seed=3, n=1)[0])
        before = pa.proxy_attention_packed_bwd.launches
        (pa.proxy_attention_packed(*leaves, s["M"], s["N"], s["L"], s["D"] ** -0.5, s["D"]).transpose(0, 1)
         * weight.transpose(0, 1)).sum().backward()
        torch.cuda.synchronize()
        check(pa.proxy_attention_packed_bwd.launches == before + 1, "autograd did not launch the packed backward")
        (pa.proxy_attention_packed_plain(*ref, s["M"], s["L"], s["D"] ** -0.5, s["D"]) * weight).sum().backward()
        err = max((a.grad - b.grad).abs().max().item() for a, b in zip(leaves, ref))
        print(f"  autograd through the packed kernels vs through the plain path (tiny, fp32): "
              f"max_abs {err:.3e} (tol {BWD_TOL_FP32:.0e})")
        check(err <= BWD_TOL_FP32, f"packed kernel autograd vs plain autograd: {err}")

    with phase("3e patch-embed kernel vs plain"):
        patch_errors = {}
        for name, shape in PATCH_SHAPES.items():
            frames, kernel = patch_inputs(shape)
            want = pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD)  # the plain fp32 GEMM
            top = want.abs().max().item()
            for dtype in (torch.float32, torch.bfloat16):
                before = pp.fused_patch_embed.launches
                got = pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD, dtype, use_kernel=True)
                torch.cuda.synchronize()
                check(pp.fused_patch_embed.launches == before + 1, f"{name}: patch-embed launch not counted")
                check(got.dtype == dtype and got.shape == want.shape, f"{name}: patch-embed output dtype/shape")
                dt = str(dtype).split(".")[-1]
                err = (got.float() - want).abs().max().item()
                patch_errors[(name, dt)] = err
                line = f"  {name:12s} [N,H,W,P,D]={list(shape)} {dt:8s} max_abs {err:.3e} (max|out| {top:.3f})"
                check(math.isfinite(err), f"{name} {dt}: patch embed not finite")
                if dtype == torch.float32:
                    line += f", {err / top:.2e} of max|out| (tol {PATCH_FP32_REL:.0e})"
                    check(err <= PATCH_FP32_REL * top, f"{name} fp32 patch embed: {err} > {PATCH_FP32_REL} max|out|")
                else:
                    ulps = bf16_grad_ulps(got, want)
                    line += f", {ulps:.3f} ulp of the fp32 plain GEMM (tol {BF16_MAX_ULP:.0f})"
                    check(ulps <= BF16_MAX_ULP, f"{name} bf16 patch embed: {ulps} ulp")
                print(line)
            del frames, kernel, want, got

    with phase("4 B/32 retrieval eval (main path)"), tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.reset_peak_memory_stats()
        with plain_on_cuda_guard() as plain_cuda_calls:
            reset_launches()
            report = run_retrieval_clipvip.main([
                "--dummy_data", "1", "--mode", "eval", "--clip_size", "base_32",
                "--device_ingest", "1", "--num_frm", "12", "--crop_img_size", "224",
                "--val_batch_size", str(EVAL_BATCH), "--device", "cuda",
                "--output_dir", out_dir, "--save_feats", f"{out_dir}/feats.npz",
            ])
            torch.cuda.synchronize()
            eval_launches = launch_counts()
        n_batches = math.ceil(run_retrieval_clipvip.DUMMY_VAL_SIZE / EVAL_BATCH)
        print(f"  launches {eval_launches} (expected {VIDEO_LAYERS} layers x {n_batches} batches forward, "
              f"none backward); plain path on CUDA: {len(plain_cuda_calls)} calls")
        check(eval_launches == expected(proxy_attention_fwd=VIDEO_LAYERS * n_batches), "eval kernel launch counts")
        check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
        for direction in ("t2v", "v2t"):
            row = {k: report[direction][k] for k in ("R1", "R5", "R10", "MedR")}
            print(f"  {direction} {row}")
            check(all(math.isfinite(x) for x in row.values()), f"{direction} R@K not finite")
        feats = np.load(f"{out_dir}/feats.npz")
        for key in ("vis_features", "text_features"):
            f = feats[key]
            norms = np.linalg.norm(f, axis=-1)
            print(f"  {key} {f.shape} finite={np.isfinite(f).all()} "
                  f"L2 norm in [{norms.min():.4f}, {norms.max():.4f}]")
            check(f.shape == (run_retrieval_clipvip.DUMMY_VAL_SIZE, 512), f"{key} shape")
            check(bool(np.isfinite(f).all()) and np.abs(norms - 1).max() < 1e-2, f"{key} not unit rows")
        print(f"  eval wall {report['perf']['wall_s']:.2f} s, {report['perf']['clips_per_s']:.1f} clips/s "
              f"(host clock, synthetic decode + upload included) [{card}]")
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")

    with phase("4b B/32 fine-tune (main path)"), tempfile.TemporaryDirectory() as out_dir:
        with open(os.path.join(REPO, PRESET)) as f:
            preset = json.load(f)
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with plain_on_cuda_guard() as plain_cuda_calls:
            reset_launches()
            report = run_retrieval_clipvip.main([
                "--config", os.path.join(REPO, PRESET), "--dummy_data", "1", "--device_ingest", "1",
                "--mode", "train", "--num_train_steps", str(TRAIN_STEPS),
                "--valid_steps", str(TRAIN_EVERY), "--save_steps", str(TRAIN_EVERY), "--log_steps", "1",
                "--device", "cuda", "--output_dir", out_dir,
            ])
            torch.cuda.synchronize()
            train_launches = launch_counts()
        wall = time.perf_counter() - t0
        # validation at start, at every TRAIN_EVERY steps, and the final report's
        n_val = math.ceil(run_retrieval_clipvip.DUMMY_VAL_SIZE / preset["val_batch_size"])
        validations = 1 + TRAIN_STEPS // TRAIN_EVERY + 1
        want = expected(proxy_attention_fwd=VIDEO_LAYERS * (TRAIN_STEPS + validations * n_val),
                        proxy_attention_bwd=VIDEO_LAYERS * TRAIN_STEPS)
        print(f"  launches {train_launches} (expected {want}: {VIDEO_LAYERS} layers x ({TRAIN_STEPS} steps "
              f"+ {validations} validations x {n_val} batches) forward, x {TRAIN_STEPS} steps backward); "
              f"plain path on CUDA: {len(plain_cuda_calls)} calls")
        check(train_launches == want, "fine-tune kernel launch counts")
        check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
        with open(os.path.join(out_dir, "log", "scalars.jsonl")) as f:
            rows = [json.loads(line) for line in f]
        losses = [r["value"] for r in rows if r["tag"] == "train/loss"]
        norms = [r["value"] for r in rows if r["tag"] == "train/grad_norm"]
        print(f"  batch {preset['train_batch_size']}, losses {[round(x, 4) for x in losses]}, "
              f"grad norms {[round(x, 4) for x in norms]}")
        check(len(losses) == TRAIN_STEPS and all(math.isfinite(x) for x in losses + norms),
              "fine-tune losses not finite")
        for direction in ("t2v", "v2t"):
            row = {k: report[direction][k] for k in ("R1", "R5", "R10", "MedR")}
            print(f"  final {direction} {row}")
            check(all(math.isfinite(x) for x in row.values()), f"{direction} R@K not finite")
        ckpts = sorted(os.listdir(os.path.join(out_dir, "ckpt")))
        check(ckpts == [f"{TRAIN_EVERY}.pt", f"{TRAIN_STEPS}.pt"], f"checkpoints {ckpts}")
        print(f"  checkpoints {ckpts}; run wall {wall:.1f} s (host clock, synthetic data and "
              f"{validations} validations included) [{card}]")
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")

    with open(os.path.join(REPO, LFVILA_PRESET)) as f:
        lfvila_preset = json.load(f)

    with phase("4c LF-VILA retrieval, window kernel on (main path)"), tempfile.TemporaryDirectory() as out_dir:
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        with plain_on_cuda_guard() as plain_cuda_calls:
            reset_launches()
            report = run_tasks_lfvila.main([
                "--config", os.path.join(REPO, LFVILA_PRESET), "--task", "retrieval", "--dummy_data", "1",
                "--num_train_steps", "0", "--val_batch_size", str(LFVILA_BATCH), "--device", "cuda",
                "--output_dir", out_dir,
            ])
            torch.cuda.synchronize()
            lfvila_launches = launch_counts()
        wall = time.perf_counter() - t0
        n_batches = math.ceil(run_tasks_lfvila.DUMMY_SIZE / LFVILA_BATCH)
        want = expected(window_attention_fwd=WINDOW_BLOCKS * n_batches)
        print(f"  launches {lfvila_launches} (expected {WINDOW_BLOCKS} window blocks x {n_batches} batches); "
              f"plain path on CUDA: {len(plain_cuda_calls)} calls")
        check(lfvila_launches == want, "LF-VILA retrieval kernel launch counts")
        check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
        with open(os.path.join(out_dir, "final_report.json")) as f:
            check(json.load(f)["t2v"] == report["t2v"], "final_report.json")
        for direction in ("t2v", "v2t"):
            row = {k: report[direction][k] for k in ("R1", "R5", "R10", "MedR")}
            print(f"  {direction} {row}")
            check(all(math.isfinite(x) for x in row.values()), f"{direction} R@K not finite")
        print(f"  eval {report['perf']['wall_s']:.2f} s, {report['perf']['clips_per_s']:.2f} clips/s; run wall "
              f"{wall:.1f} s (host clock; model build, synthetic data and upload included) [{card}]")
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")

    with phase("4d ops: the packed proxy attention and the fused patch embed (main path)"):
        s, st = B32, B32_TRAIN
        D, scale = s["D"], s["D"] ** -0.5
        serve = [packed(t) for t in qkv(s, torch.bfloat16, seed=4)]
        train = [packed(t) for t in qkv(st, torch.bfloat16, seed=5, n=4)]
        leaves = [t.clone().requires_grad_() for t in train[:3]]
        g = torch.Generator(device="cuda").manual_seed(6)
        # the 24 x 12 frames of a B/32 serving batch, and a patch kernel of the model's shape
        frames = torch.randint(0, 256, (EVAL_BATCH * 12, 224, 224, 3), device="cuda", generator=g,
                               dtype=torch.uint8)
        kernel = torch.randn(32, 32, 3, 768, device="cuda", generator=g) * 0.02
        with plain_on_cuda_guard() as plain_cuda_calls:
            reset_launches()
            out = pa.proxy_attention_packed(*serve, s["M"], s["N"], s["L"], scale, D)
            pa.proxy_attention_packed(*leaves, st["M"], st["N"], st["L"], scale, D).backward(train[3])
            emb = pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD, torch.bfloat16, use_kernel=True)
            torch.cuda.synchronize()
            ops_launches = launch_counts()
        want = expected(proxy_attention_packed_fwd=2, proxy_attention_packed_bwd=1, patch_embed_u8=1)
        print(f"  launches {ops_launches} (expected {want}); plain path on CUDA: {len(plain_cuda_calls)} calls")
        check(ops_launches == want, "ops path kernel launch counts")
        check(not plain_cuda_calls, f"the plain version ran on CUDA tensors: {plain_cuda_calls[:4]}")
        # what came out, against the plain versions of the same inputs in fp32
        ulps = bf16_ulps(out, pa.proxy_attention_packed_plain(*(t.float() for t in serve), s["M"], s["L"], scale, D))
        grads = pa.proxy_attention_packed_bwd_plain(*(t.float() for t in train), st["M"], st["L"], scale, D)
        grad_ulps = max(bf16_grad_ulps(t.grad, w) for t, w in zip(leaves, grads))
        emb_ulps = bf16_grad_ulps(emb, pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD))
        print(f"  packed forward {tuple(out.shape)} {ulps:.3f} ulp, gradients {grad_ulps:.3f} ulp, "
              f"patch embeddings {tuple(emb.shape)} {emb_ulps:.3f} ulp of the fp32 plain versions")
        check(out.shape == serve[0].shape and all(t.grad.shape == train[0].shape for t in leaves)
              and emb.shape == (EVAL_BATCH * 12, 49, 768), "ops path output shapes")
        check(ulps <= BF16_MAX_ULP and grad_ulps <= BWD_MAX_ULP and emb_ulps <= BF16_MAX_ULP,
              "ops path outputs against their plain versions")
        del serve, train, leaves, frames, kernel, out, emb, grads

    with phase("4e LF-VILA stage-1 pretraining (main path)"):
        stage1_launches, _ = lfvila_stage1_phase(card)

    with phase("4f LF-VILA stage-2 pretraining, frozen stage-1 modules (main path)"):
        stage2_launches, _ = lfvila_stage2_phase(card)

    with phase("4g LF-VILA fine-tunes: QA and video classification (main path)"):
        task_launches = lfvila_finetune_phase(card)

    with phase("4h CLIP-ViP B/32 pretraining from a CLIP-ViP checkpoint, image/caption branch (main path)"):
        pretrain_launches, _ = clipvip_pretrain_phase(card)

    with phase("4i LF-VILA stage-1 pretraining from 2-D Swin and BERT checkpoints (main path)"):
        cascade_launches = lfvila_cascade_phase(card)

    with phase("5 serve: card vs CPU, fp32"):
        model_cpu = CLIPViPModel(CLIPVipConfig.base_patch32(dtype=torch.float32))
        model_cpu.init_weights(torch.Generator().manual_seed(0))
        gpu = RetrievalTowers(copy.deepcopy(model_cpu), "cuda")
        cpu = RetrievalTowers(model_cpu, "cpu")
        rng = np.random.default_rng(0)
        video = rng.integers(0, 256, size=(2, 12, 224, 224, 3), dtype=np.uint8)
        ids, mask = captions(rng, 2)
        before = pa.proxy_attention.launches
        feats = {
            "video": (gpu.encode_video(video), cpu.encode_video(video)),
            "text": (gpu.encode_text(ids, mask), cpu.encode_text(ids, mask)),
        }
        torch.cuda.synchronize()
        check(pa.proxy_attention.launches == before + VIDEO_LAYERS, "serving did not use the kernel")
        for name, (on_card, on_cpu) in feats.items():
            a, b = on_card.cpu(), on_cpu
            err = (a - b).abs().max().item()
            cos = torch.nn.functional.cosine_similarity(a, b, dim=-1).min().item()
            print(f"  {name} {tuple(a.shape)} card vs cpu max_abs {err:.3e} (tol 1e-4) min_cos {cos:.7f}")
            check(err <= 1e-4, f"{name}: card vs cpu {err}")
        sims = gpu.similarity(feats["text"][0], feats["video"][0], scaled=True)
        print(f"  scaled text->video scores {sims.cpu().numpy().round(3).tolist()}")
        check(bool(torch.isfinite(sims).all()), "similarity not finite")
        del gpu, cpu, model_cpu

    with phase("5b pretraining step with the image branch: card vs CPU, fp32"):
        lr = 1e-5
        model_cpu = CLIPViPModel(CLIPVipConfig.base_patch32(dtype=torch.float32))
        model_cpu.init_weights(torch.Generator().manual_seed(0))
        with torch.no_grad():  # a temporal embedding that is not zero, so both branches' lerps count
            model_cpu.vision_model.embeddings.temporal_embedding.normal_(0.0, 0.02, generator=torch.Generator()
                                                                          .manual_seed(1))
        model_gpu = copy.deepcopy(model_cpu).cuda()
        rng = np.random.default_rng(2)
        ids, mask = captions(rng, 2)
        cap_ids, cap_mask = captions(rng, 2)
        frames = rng.integers(0, 256, size=(2, 13, 224, 224, 3), dtype=np.uint8)
        # as PretrainCollator ships them: fp32 normalized video and one image a clip, one caption a clip
        batch = {"video": np.stack([normalize(f[:12]) for f in frames]), "text_input_ids": ids,
                 "text_input_mask": mask, "image": np.stack([normalize(f[12:]) for f in frames]),
                 "caption_ids": cap_ids[:, None], "caption_masks": cap_mask[:, None]}
        metrics = {}
        for device, model in (("cuda", model_gpu), ("cpu", model_cpu)):
            step, state = train_step_parts(model, lr, "NCELearnableTempLoss_vsc_fc")
            before = (pa.proxy_attention.launches, pa.proxy_attention_bwd.launches)
            _, m = step(state, batch_to_device(device)(batch), 0)
            metrics[device] = {k: v.item() for k, v in m.items()}
            if device == "cuda":
                launched = (pa.proxy_attention.launches - before[0], pa.proxy_attention_bwd.launches - before[1])
                check(launched == (PROXY_LAYERS_PER_STEP,) * 2, f"card train step launches {launched}")
        print(f"  card {metrics['cuda']}\n  cpu  {metrics['cpu']}")
        loss_err = abs(metrics["cuda"]["loss"] - metrics["cpu"]["loss"])
        norm_err = abs(metrics["cuda"]["grad_norm"] / metrics["cpu"]["grad_norm"] - 1)
        # fp32 sums in other orders through 24 layers: 1e-4 on the loss,
        # 1e-3 relative on the gradients' global norm
        check(loss_err <= 1e-4, f"train loss card vs cpu {loss_err}")
        check(norm_err <= 1e-3, f"grad_norm card vs cpu rel {norm_err}")
        cpu_state = model_cpu.state_dict()
        diffs = torch.cat([(v.cpu() - cpu_state[k]).abs().flatten() for k, v in model_gpu.state_dict().items()])
        # AdamW's first step is lr * g / (|g| + eps) (+ decay): where |g| is
        # near eps the last digits of g move it, by up to 2 lr
        print(f"  loss diff {loss_err:.3e} (tol 1e-4), grad_norm rel diff {norm_err:.3e} (tol 1e-3); "
              f"params after the step: max diff {diffs.max().item():.3e} (tol 2 lr = {2 * lr:.0e}), "
              f"{(diffs > 1e-7).double().mean().item():.2e} of them above 1e-7")
        check(diffs.max().item() <= 2 * lr, "params after one step differ by more than 2 lr")
        del model_cpu, model_gpu

    with phase("5c LF-VILA towers: card vs CPU, fp32"):
        model_cpu = LfVilaRetrieval(run_tasks_lfvila.lfvila_config_from({**lfvila_preset, "bf16": 0}))
        model_cpu.init_weights(torch.Generator().manual_seed(0))
        gpu = LfVilaTowers(copy.deepcopy(model_cpu), "cuda")
        cpu = LfVilaTowers(model_cpu, "cpu")
        rng = np.random.default_rng(3)
        frames = rng.normal(size=(1, 3, 32, 192, 320)).astype(np.float32)
        ids = rng.integers(1, 30522, size=(1, 4, 70))
        mask = (np.arange(70)[None, None] < rng.integers(5, 70, size=(1, 4, 1))).astype(np.int64)
        before = wa.window_attention.launches
        feats = {
            "video": (gpu.encode_video(frames), cpu.encode_video(frames)),
            "text": (gpu.encode_text(ids, mask), cpu.encode_text(ids, mask)),
        }
        torch.cuda.synchronize()
        check(wa.window_attention.launches == before + WINDOW_BLOCKS, "the video tower did not use the kernel")
        for name, (on_card, on_cpu) in feats.items():
            a, b = on_card.cpu(), on_cpu
            err = (a - b).abs().max().item()
            print(f"  {name} {tuple(a.shape)} card vs cpu max_abs {err:.3e} (tol 1e-4)")
            check(math.isfinite(err) and err <= 1e-4, f"{name}: card vs cpu {err}")
        sims = gpu.similarity(feats["text"][0], feats["video"][0], scaled=True)
        print(f"  scaled text->video score {sims.cpu().numpy().round(3).tolist()}")
        check(bool(torch.isfinite(sims).all()), "similarity not finite")
        del gpu, cpu, model_cpu

    with phase("5d LF-VILA pretraining step: card vs CPU, fp32"):
        lfvila_card_vs_cpu_phase()

    with phase("6 timing"):
        s = B32
        args = (s["M"], s["N"], s["L"], s["D"] ** -0.5)
        timings = {}
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = qkv(s, dtype)
            runs = alternate({
                "kernel": lambda: pa.proxy_attention(q, k, v, *args),
                "plain": lambda: pa.proxy_attention_plain(q, k, v, s["M"], s["L"], args[-1]),
            })
            dt = str(dtype).split(".")[-1]
            timings[dt] = {name: sum(r) / len(r) for name, r in runs.items()}
            timings[dt]["device"] = device_ms(lambda: pa.proxy_attention(q, k, v, *args), iters=200)
            print(f"  proxy attention B/32 b=24 {dt}: kernel {runs['kernel']} ms, "
                  f"plain {runs['plain']} ms (CUDA events, 200 calls each); kernel device time "
                  f"{timings[dt]['device']:.4f} ms (torch.profiler, 200 calls) [{card}]")
            del q, k, v

        model = CLIPViPModel(CLIPVipConfig.base_patch32(dtype=torch.bfloat16), device="cuda")
        model.init_weights(torch.Generator(device="cuda").manual_seed(0)).eval()
        batch = synthetic_batch(EVAL_BATCH, "cuda", seed=1)
        video, ids, mask = batch["video"], batch["text_input_ids"], batch["text_input_mask"]
        # Windows of about 2 s each, so host-launch noise shows as spread.
        with torch.inference_mode():
            fwd = window_ms(lambda: model(video, ids, mask), iters=100)
            vid = window_ms(lambda: model.forward_video(video), iters=100)
            txt = window_ms(lambda: model.forward_text(ids, mask), iters=300)
        print(f"  B/32 bf16 video+text forward b={EVAL_BATCH}: {spread(fwd)} = "
              f"{EVAL_BATCH / median(fwd) * 1e3:.1f} clips/s at the median; windows {fwd} "
              f"(CUDA events, 100 calls per window, inputs on the card) [{card}]")
        print(f"  B/32 bf16 video tower b={EVAL_BATCH}: {spread(vid)}; windows {vid} [{card}]")
        print(f"  B/32 bf16 text tower b={EVAL_BATCH}: {spread(txt)}; windows {txt} "
              f"(300 calls per window) [{card}]")

    with phase("6b timing: backward kernel and train step"):
        s = B32_TRAIN
        args = (s["M"], s["N"], s["L"], s["D"] ** -0.5)
        bwd_timings = {}
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v, d_out = qkv(s, dtype, n=4)
            dt = str(dtype).split(".")[-1]
            # like for like: the backward kernel against its plain version;
            # "kernel" is what autograd runs (on the forward's LSE), "alone"
            # the public entry, which computes the LSE first
            _, lse = pa._launch_fwd(q, k, v, *args, with_lse=True)
            runs = alternate({
                "kernel": lambda: pa._launch_bwd(q, k, v, d_out, *args, lse=lse),
                "plain": lambda: pa.proxy_attention_bwd_plain(q, k, v, d_out, s["M"], s["L"], args[-1]),
                "alone": lambda: pa.proxy_attention_bwd(q, k, v, d_out, *args),
            })
            bwd_timings[dt] = {name: sum(r) / len(r) for name, r in runs.items()}
            bwd_timings[dt]["device"] = device_ms(lambda: pa._launch_bwd(q, k, v, d_out, *args, lse=lse), iters=200)
            print(f"  proxy attention backward B/32 b=32 {dt}: kernel on the forward's LSE {runs['kernel']} ms, "
                  f"alone {runs['alone']} ms, plain (proxy_attention_bwd_plain) {runs['plain']} ms (CUDA events, "
                  f"200 calls each); kernel on the forward's LSE, device time {bwd_timings[dt]['device']:.4f} ms "
                  f"(torch.profiler, 200 calls) [{card}]")

            # what a layer pays in training: forward and backward through
            # autograd, the two kernels against the plain forward
            def through(forward):
                def run():
                    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
                    forward(*leaves).backward(d_out)
                return run

            fns = {
                "kernel": through(lambda *t: pa.proxy_attention(*t, *args)),
                "plain": through(lambda *t: pa.proxy_attention_plain(*t, s["M"], s["L"], args[-1])),
            }
            if dtype == torch.bfloat16:  # the library's forward + backward, on the tensor cores too
                mask = pa.proxy_bias(q.shape[2], s["M"], s["L"], "cuda").to(dtype)
                fns["sdpa"] = through(lambda *t: torch.nn.functional.scaled_dot_product_attention(
                    *t, attn_mask=mask, scale=args[-1]))
            both = alternate(fns)
            print(f"  proxy attention forward+backward (autograd) B/32 b=32 {dt}: kernels {both['kernel']} ms, "
                  f"plain forward + autograd {both['plain']} ms"
                  + (f", SDPA forward + autograd {both['sdpa']} ms" if "sdpa" in both else "")
                  + f" (CUDA events, 200 calls each) [{card}]")
            del q, k, v, d_out, lse

        b = B32_TRAIN["B"]
        _, steps_ms, iters, peak_gib = time_train_step(b)
        print(f"  B/32 bf16 train step b={b}: {spread(steps_ms)} = {b / median(steps_ms) * 1e3:.1f} clips/s at "
              f"the median; windows {steps_ms} (CUDA events, {iters} steps per window, inputs on the card) "
              f"[{card}]")
        print(f"  train step peak device memory {peak_gib:.2f} GiB [{card}]")
        check(all(math.isfinite(x) for x in steps_ms), "train step timing")

    with phase("6c timing: window kernel and LF-VILA towers"):
        win_timings = {}
        for name in WINDOW_TIMED:
            for dtype in (torch.bfloat16, torch.float32):
                q, k, v, bias, mask = window_inputs(WINDOW_SHAPES[name], dtype)
                runs = alternate({
                    "kernel": lambda: wa.window_attention(q, k, v, bias, mask),
                    "plain": lambda: wa.window_attention_plain(q, k, v, bias, mask),
                })
                dt = str(dtype).split(".")[-1]
                win_timings[(name, dt)] = {n: sum(r) / len(r) for n, r in runs.items()}
                win_timings[(name, dt)]["device"] = device_ms(lambda: wa.window_attention(q, k, v, bias, mask),
                                                              iters=200)
                print(f"  window attention {name} {list(WINDOW_SHAPES[name][:4])} {dt}: kernel {runs['kernel']} ms, "
                      f"plain {runs['plain']} ms (CUDA events, 200 calls each); kernel device time "
                      f"{win_timings[(name, dt)]['device']:.4f} ms (torch.profiler, 200 calls) [{card}]")
                del q, k, v, bias, mask

        model = LfVilaRetrieval(run_tasks_lfvila.lfvila_config_from(lfvila_preset), device="cuda")
        model.init_weights(torch.Generator(device="cuda").manual_seed(0)).eval()
        g = torch.Generator(device="cuda").manual_seed(1)
        b = LFVILA_BATCH
        frames = torch.randn(b, 3, 32, 192, 320, device="cuda", generator=g)
        ids = torch.randint(1, 30522, (b, 4, 70), device="cuda", generator=g)
        mask = (torch.arange(70, device="cuda")[None, None] < torch.randint(5, 70, (b, 4, 1), device="cuda",
                                                                             generator=g)).long()
        torch.cuda.reset_peak_memory_stats()
        with torch.inference_mode():
            before = wa.window_attention.launches
            vid = window_ms(lambda: model.forward_video(frames), iters=10)
            txt = window_ms(lambda: model.forward_text(ids, mask), iters=50)
            # window_ms: 3 warm-up calls, then 5 windows of 10
            check(wa.window_attention.launches - before == WINDOW_BLOCKS * (3 + 5 * 10), "video tower launches")
            vid_device = device_ms(lambda: model.forward_video(frames), iters=5)
        print(f"  LF-VILA bf16 video tower b={b} (32x192x320 fp32 frames on the card): {spread(vid)} = "
              f"{b / median(vid) * 1e3:.2f} clips/s at the median; windows {vid} (CUDA events, 10 calls "
              f"per window); device time {vid_device:.4f} ms a call (torch.profiler, 5 calls) [{card}]")
        print(f"  LF-VILA bf16 text tower b={b} (4 x 70 tokens): {spread(txt)}; windows {txt} (50 calls per "
              f"window) [{card}]")
        print(f"  towers peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{card}]")
        check(all(math.isfinite(x) for x in vid + txt), "tower timing")
        del model, frames

    with phase("6d timing: packed and patch-embed kernels, and one library call for each kernel"):
        import torch.nn.functional as F

        lib = {}  # kernel name -> ms of one PyTorch call computing the same function
        sdpa_checks = []

        def sdpa(q, k, v, mask, scale):
            return F.scaled_dot_product_attention(q, k, v, attn_mask=mask, scale=scale)

        def sdpa_fwd_bwd(tensors, d_out, view, mask, scale):
            def run():
                leaves = [t.detach().requires_grad_() for t in tensors]
                sdpa(*(view(t) for t in leaves), mask, scale).backward(view(d_out))
            return run

        # #1 and #3: B/32 serving, b=24, bf16; the proxy mask built outside the window
        s = B32
        D, scale, S = s["D"], s["D"] ** -0.5, s["M"] + s["N"] * s["L"]
        mask = pa.proxy_bias(S, s["M"], s["L"], "cuda").to(torch.bfloat16)
        q, k, v = qkv(s, torch.bfloat16)
        pq, pk, pv = (packed(t) for t in (q, k, v))
        hq, hk, hv = (head_view(t, D) for t in (pq, pk, pv))
        runs = alternate({
            "kernel": lambda: pa.proxy_attention_packed(pq, pk, pv, s["M"], s["N"], s["L"], scale, D),
            "plain": lambda: pa.proxy_attention_packed_plain(pq, pk, pv, s["M"], s["L"], scale, D),
            "library": lambda: sdpa(hq, hk, hv, mask, scale),
            "library_bhsd": lambda: sdpa(q, k, v, mask, scale),
        })
        packed_fwd_timing = {k_: mean(r) for k_, r in runs.items()}
        packed_fwd_timing["device"] = device_ms(
            lambda: pa.proxy_attention_packed(pq, pk, pv, s["M"], s["N"], s["L"], scale, D), iters=200)
        lib["proxy_attention_packed_fwd"] = packed_fwd_timing["library"]
        lib["proxy_attention_fwd"] = packed_fwd_timing["library_bhsd"]
        sdpa_checks.append(("proxy fwd", sdpa(q, k, v, mask, scale), pa.proxy_attention(q, k, v, s["M"], s["N"],
                                                                                        s["L"], scale)))
        print(f"  packed proxy attention B/32 b=24 bf16: kernel {runs['kernel']} ms, plain {runs['plain']} ms, "
              f"SDPA on the head views {runs['library']} ms; [B,H,S,D] SDPA {runs['library_bhsd']} ms "
              f"(CUDA events, 200 calls each); kernel device time {packed_fwd_timing['device']:.4f} ms "
              f"(torch.profiler, 200 calls) [{card}]")
        del q, k, v, pq, pk, pv, hq, hk, hv

        # #2 and #4: B/32 train, b=32, bf16; the library's backward is its
        # forward + backward through autograd minus its forward alone
        s = B32_TRAIN
        q, k, v, d_out = qkv(s, torch.bfloat16, seed=1, n=4)
        pq, pk, pv, pd = (packed(t) for t in (q, k, v, d_out))
        hv_ = lambda t: head_view(t, D)  # noqa: E731
        same = lambda t: t  # noqa: E731
        # "kernel" as autograd runs it, on the forward's LSE; "alone" the public entry
        _, plse = pa._launch_fwd(pq, pk, pv, s["M"], s["N"], s["L"], scale, D, with_lse=True)
        runs = alternate({
            "kernel": lambda: pa._launch_bwd(pq, pk, pv, pd, s["M"], s["N"], s["L"], scale, D, lse=plse),
            "plain": lambda: pa.proxy_attention_packed_bwd_plain(pq, pk, pv, pd, s["M"], s["L"], scale, D),
            "alone": lambda: pa.proxy_attention_packed_bwd(pq, pk, pv, pd, s["M"], s["N"], s["L"], scale, D),
            "library_fwd_bwd": sdpa_fwd_bwd((pq, pk, pv), pd, hv_, mask, scale),
            "library_fwd": lambda: sdpa(hv_(pq), hv_(pk), hv_(pv), mask, scale),
            "bhsd_fwd_bwd": sdpa_fwd_bwd((q, k, v), d_out, same, mask, scale),
            "bhsd_fwd": lambda: sdpa(q, k, v, mask, scale),
        })
        packed_bwd_timing = {k_: mean(r) for k_, r in runs.items()}
        packed_bwd_timing["device"] = device_ms(
            lambda: pa._launch_bwd(pq, pk, pv, pd, s["M"], s["N"], s["L"], scale, D, lse=plse), iters=200)
        lib["proxy_attention_packed_bwd"] = packed_bwd_timing["library_fwd_bwd"] - packed_bwd_timing["library_fwd"]
        lib["proxy_attention_bwd"] = packed_bwd_timing["bhsd_fwd_bwd"] - packed_bwd_timing["bhsd_fwd"]
        print(f"  packed proxy attention backward B/32 b=32 bf16: kernel on the forward's LSE {runs['kernel']} ms, "
              f"alone {runs['alone']} ms, plain {runs['plain']} ms, SDPA forward+backward on the head views "
              f"{runs['library_fwd_bwd']} ms, its "
              f"forward {runs['library_fwd']} ms; [B,H,S,D] SDPA forward+backward {runs['bhsd_fwd_bwd']} ms, "
              f"forward {runs['bhsd_fwd']} ms (CUDA events, 200 calls each); kernel on the forward's LSE, device "
              f"time {packed_bwd_timing['device']:.4f} ms (torch.profiler, 200 calls) [{card}]")
        del q, k, v, d_out, pq, pk, pv, pd, plse

        # #5: the B/32 serving frames, bf16 out; the library call is one bf16
        # addmm of patches gathered (and cast) outside the window with the
        # bf16-rounded weight: the model's own patch_embed_u8 GEMM, rounded as
        # SDPA is for the proxy rows. The fp32 addmm (TF32 off) and the gather
        # are timed apart.
        N_, H_, W_, P_, D_ = PATCH_SHAPES["b32"]
        frames, kernel = patch_inputs(PATCH_SHAPES["b32"])
        folded_w, bias = pp.fold_normalization(kernel, CLIP_MEAN, CLIP_STD)
        gather = lambda: pp.extract_patches_u8(frames, P_).reshape(-1, 3 * P_ * P_).float()  # noqa: E731
        patches = gather()
        patches_bf16, folded_bf16, bias_bf16 = patches.bfloat16(), folded_w.bfloat16(), bias.bfloat16()
        runs = alternate({
            "kernel": lambda: pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD, torch.bfloat16,
                                                   use_kernel=True),
            "plain": lambda: pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD, torch.bfloat16),
            "library": lambda: torch.addmm(bias_bf16, patches_bf16, folded_bf16),
            "library_fp32": lambda: torch.addmm(bias, patches, folded_w),
            "gather": gather,
            "kernel_fp32": lambda: pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD, use_kernel=True),
        }, iters=50)
        patch_timing = {k_: mean(r) for k_, r in runs.items()}
        patch_timing["device"] = device_ms(lambda: pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD,
                                                                        torch.bfloat16, use_kernel=True), iters=50)
        launch_device = device_ms(lambda: pp._launch(frames, folded_w, bias, P_, torch.bfloat16), iters=50)
        lib["patch_embed_u8"] = patch_timing["library"]
        sdpa_checks.append(("patch embed", torch.addmm(bias_bf16, patches_bf16, folded_bf16),
                            pp.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD, use_kernel=True).flatten(0, 1)))
        print(f"  patch embed [N,H,W,P,D]={list(PATCH_SHAPES['b32'])} bf16 out: kernel {runs['kernel']} ms "
              f"(fp32 out {runs['kernel_fp32']} ms), plain {runs['plain']} ms, bf16 addmm of gathered patches "
              f"{runs['library']} ms, the gather {runs['gather']} ms (CUDA events, 50 calls each); device time "
              f"{patch_timing['device']:.4f} ms, of which the kernel's launch (weight split and GEMM) "
              f"{launch_device:.4f} ms and the rest the weight fold (torch.profiler, 50 calls) [{card}]")
        del frames, kernel, folded_w, bias, patches, patches_bf16, folded_bf16, bias_bf16

        # #6: stage 3's shifted block at b=8, bf16; bias + mask as one
        # [nW, H, N, N] mask, broadcast over the batch of windows
        shape = WINDOW_SHAPES["s3_shifted"]
        q, k, v, bias, wmask = window_inputs(shape, torch.bfloat16)
        Bn, Hw, Nw, dw = shape[:4]
        nW = wmask.shape[0]
        joint = (bias[None] + wmask[:, None]).to(torch.bfloat16)
        wview = lambda t: t.view(Bn // nW, nW, Hw, Nw, dw)  # noqa: E731
        runs = alternate({
            "kernel": lambda: wa.window_attention(q, k, v, bias, wmask),
            "plain": lambda: wa.window_attention_plain(q, k, v, bias, wmask),
            "library": lambda: sdpa(wview(q), wview(k), wview(v), joint, dw ** -0.5),
        })
        lib["window_attention_fwd"] = mean(runs["library"])
        sdpa_checks.append(("window", sdpa(wview(q), wview(k), wview(v), joint, dw ** -0.5).reshape(q.shape),
                            wa.window_attention(q, k, v, bias, wmask)))
        print(f"  window attention s3_shifted {list(shape[:4])} bf16: kernel {runs['kernel']} ms, plain "
              f"{runs['plain']} ms, SDPA with the joint mask {runs['library']} ms (CUDA events, 200 calls each) "
              f"[{card}]")
        del q, k, v, bias, wmask, joint

        # #6 at stages 3 and 5 and the grouped stages 0-1 (N=120, below the
        # model's gate pallas_min_window 240), against the plain version and
        # the model's off-gate path: WindowAttention3D._attend's
        # common.dot_attention with bias + mask as one [nW, h, N, N] mask
        def off_gate(q, k, v, bias, wmask):
            nW = 1 if wmask is None else wmask.shape[0]
            add = bias[None] if wmask is None else bias[None] + wmask[:, None]
            split = lambda t: t.unflatten(0, (-1, nW))  # noqa: E731
            return dot_attention(split(q), split(k), split(v), q.shape[-1] ** -0.5, add).flatten(0, 1)

        for name in ("s3", "s5", "s0_grouped", "s1_grouped"):
            q, k, v, bias, wmask = window_inputs(WINDOW_SHAPES[name], torch.bfloat16)
            runs = alternate({
                "kernel": lambda: wa.window_attention(q, k, v, bias, wmask),
                "plain": lambda: wa.window_attention_plain(q, k, v, bias, wmask),
                "dot_attention": lambda: off_gate(q, k, v, bias, wmask),
            })
            sdpa_checks.append((f"window {name} off the gate", off_gate(q, k, v, bias, wmask),
                                wa.window_attention(q, k, v, bias, wmask)))
            print(f"  window attention {name} {list(WINDOW_SHAPES[name][:4])} bf16: kernel {runs['kernel']} ms, plain "
                  f"{runs['plain']} ms, the model's off-gate path (dot_attention, bias + mask as one mask) "
                  f"{runs['dot_attention']} ms (CUDA events, 200 calls each) [{card}]")
            del q, k, v, bias, wmask
        # the yardsticks compute the kernels' functions (bf16 rounding apart)
        for name, a, b in sdpa_checks:
            err = (a.float() - b.float()).abs().max().item()
            print(f"  library call vs kernel, {name}: max_abs {err:.3e}")
            check(math.isfinite(err) and err <= 5e-2 * max(1.0, b.float().abs().max().item()),
                  f"library call for {name} computes another function: {err}")

        # the least time the card could take for each kernel's work on this run's inputs
        bounds = {}
        for name, s, backward in (("proxy_attention_fwd", B32, False), ("proxy_attention_bwd", B32_TRAIN, True)):
            flops, nbytes, _ = pa.proxy_attention_cost(s["B"], s["H"], s["M"] + s["N"] * s["L"], s["D"], s["M"],
                                                       s["L"], 2, backward)
            bounds[name] = bounds[name.replace("attention_", "attention_packed_")] = bound_ms(flops, nbytes)
        rows, K = N_ * (H_ // P_) * (W_ // P_), 3 * P_ * P_
        bounds["patch_embed_u8"] = bound_ms(2 * rows * K * D_, N_ * H_ * W_ * 3 + (K + 1) * D_ * 4 + rows * D_ * 2)
        bounds["window_attention_fwd"] = bound_ms(4 * Bn * Hw * Nw * Nw * dw,
                                                  4 * Bn * Hw * Nw * dw * 2 + (Hw + nW) * Nw * Nw * 4)
        for name, (t, by) in bounds.items():
            print(f"  bound {name}: {t:.4f} ms ({by}; {HBM_BYTES_PER_S / 1e12:.2f} TB/s, "
                  f"{PEAK_FLOPS / 1e12:.0f} TFLOP/s bf16)")

    paths = {"eval": eval_launches, "train": train_launches, "lfvila_retrieval": lfvila_launches,
             "ops": ops_launches, "lfvila_stage1": stage1_launches, "lfvila_stage2": stage2_launches,
             **{f"lfvila_{task}": counts for task, counts in task_launches.items()},
             "clipvip_pretrain": pretrain_launches, "lfvila_stage1_from_2d_swin_bert": cascade_launches}
    window_timing = {dt: win_timings[("s3_shifted", dt)] for dt in ("bfloat16", "float32")}
    summary = {"kernels": [
        {
            "name": name,
            "route": "cuda",
            "source": KERNELS[name][0],
            "replaces": KERNELS[name][1],
            # each main path's count, read just after its own run
            "launches": sum(counts[name] for counts in paths.values()),
            "launches_by_path": {path: counts[name] for path, counts in paths.items()},
            "max_abs_err": err,
            "ms": timing["kernel"],
            "device_ms": timing["device"],
            "plain_ms": timing["plain"],
            "bound_ms": bounds[name][0],
            "bound_by": bounds[name][1],
            "library_ms": lib[name],
        }
        for name, err, timing in (
            ("proxy_attention_fwd", errors[("b32", "bfloat16")], timings["bfloat16"]),
            ("proxy_attention_bwd", bwd_errors[("b32_train", "bfloat16", "forward's LSE")], bwd_timings["bfloat16"]),
            ("proxy_attention_packed_fwd", packed_errors[("b32", "bfloat16")], packed_fwd_timing),
            ("proxy_attention_packed_bwd", packed_errors[("b32_train_bwd", "bfloat16")], packed_bwd_timing),
            ("patch_embed_u8", patch_errors[("b32", "bfloat16")], patch_timing),
            ("window_attention_fwd", win_errors[("s3_shifted", "bfloat16")], window_timing["bfloat16"]),
        )
    ]}
    check(all(k_["launches"] > 0 for k_ in summary["kernels"]), "a kernel was launched no time on the main paths")
    print(f"patch_embed_u8 beside its fp32 yardstick: kernel {patch_timing['kernel']:.4f} ms, fp32 addmm of the "
          f"gathered patches (TF32 off) {patch_timing['library_fp32']:.4f} ms (CUDA events) [{card}]")
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
