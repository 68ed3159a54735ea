#!/usr/bin/env python3
"""Drive the PyTorch port (``xpretrain_tpu_torch``) on one NVIDIA card.

Phases, in order; any failure exits non-zero and prints no result:

1. require a CUDA card, print its name and power limit, turn TF32 off;
2. build the port's CUDA kernels from ``xpretrain_tpu_torch/csrc``;
3. check the proxy-attention kernel against its plain PyTorch version on the
   card at B/32, B/16 and small shapes, in fp32 and bf16;
4. run CLIP-ViP B/32 zero-shot retrieval eval (random weights from a seed,
   bf16, synthetic uint8 clips) through the CLI, counting kernel launches;
5. serve a few requests through ``RetrievalTowers`` in fp32 and compare the
   card's features with the CPU's (plain path) for the same weights;
6. time the kernel against the plain version, and the whole forward;
7. print the kernel summary and, as the last line, the status JSON.

Run from the repository root with no arguments: ``python3 chip_smoke.py``.
"""

from __future__ import annotations

import contextlib
import copy
import json
import math
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.abspath(__file__))
KERNEL_SOURCE = "xpretrain_tpu_torch/csrc/proxy_attention_fwd.cu"
REPLACES = "xpretrain_tpu/ops/proxy_attention.py:201"  # _attention_pallas
TOL = {"float32": 2e-5, "bfloat16": 2e-2}  # max abs; fp32: summation order; bf16: output rounding
BF16_MAX_ULP = 1.0  # bf16 output vs the fp32 plain version of the same inputs: rounding alone
B32 = dict(B=24, H=12, M=4, N=12, L=49, D=64)  # CLIP-ViP B/32 serving, batch 24
CHECK_SHAPES = {
    "b32": B32,
    "b16": dict(B=2, H=12, M=4, N=12, L=196, D=64),
    "tiny": dict(B=2, H=2, M=3, N=4, L=13, D=16),
    "l256_d128": dict(B=2, H=3, M=1, N=3, L=256, D=128),
    "d48": dict(B=2, H=3, M=4, N=5, L=7, D=48),
}
EVAL_BATCH = 24
VIDEO_LAYERS = 12


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


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def window_ms(fn, iters: int, windows: int = 5) -> list[float]:
    """Per-call ms of ``fn`` in ``windows`` back-to-back windows of ``iters`` calls."""
    return [cuda_time_ms(fn, iters, warmup=3 if i == 0 else 0) for i in range(windows)]


def spread(ms: list[float]) -> str:
    ms = sorted(ms)
    return f"median {ms[len(ms) // 2]:.4f} ms (min {ms[0]:.4f}, max {ms[-1]:.4f}, {len(ms)} windows)"


def bf16_ulps(got, want):
    """Largest |got - want| in bf16 ulps of ``want`` (fp32); |want| below
    2^-8 counts as 2^-8."""
    import torch

    mag = want.abs().clamp_min(2.0**-8)
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - want) / ulp).abs().max().item()


def captions(rng, batch: int, seq: int = 70):
    """CLIP-style token ids: BOS, random ids, EOT (the highest id, where the
    text tower pools); mask = ids > 0."""
    import numpy as np

    ids = np.zeros((batch, seq), np.int64)
    ids[:, 0] = 49406
    for i, n in enumerate(rng.integers(3, seq - 1, size=batch)):
        ids[i, 1:n] = rng.integers(10, 49406, size=n - 1)
        ids[i, n] = 49407
    return ids, (ids > 0).astype(np.int64)


def qkv(shape: dict, dtype, seed: int = 0):
    import torch

    g = torch.Generator(device="cuda").manual_seed(seed)
    size = (shape["B"], shape["H"], shape["M"] + shape["N"] * shape["L"], shape["D"])
    return [torch.randn(size, device="cuda", generator=g).to(dtype) for _ in range(3)]


def main() -> None:
    try:
        import torch
    except ImportError:
        fail("torch is not installed")
    if not torch.cuda.is_available():
        fail("torch sees no CUDA device: this smoke test runs on an NVIDIA card only")
    sys.path.insert(0, REPO)
    try:
        from xpretrain_tpu_torch.cli import run_retrieval_clipvip
        from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel
        from xpretrain_tpu_torch.ops import _kernels
        from xpretrain_tpu_torch.ops import proxy_attention as pa
        from xpretrain_tpu_torch.serving.towers import RetrievalTowers
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
        print(f"built {lib.relative_to(REPO)} from {KERNEL_SOURCE} "
              f"({' '.join(_kernels.NVCC_FLAGS[:2])}) in {time.perf_counter() - t0:.1f} s")
        for line in lib.with_suffix(".log").read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  ptxas: {line.strip()}")

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
                print(line)

    with phase("4 B/32 retrieval eval (main path)"), tempfile.TemporaryDirectory() as out_dir:
        plain_cuda_calls = []
        plain = pa.proxy_attention_plain

        def guarded_plain(q, *args):
            if q.is_cuda:
                plain_cuda_calls.append(tuple(q.shape))
            return plain(q, *args)

        pa.proxy_attention_plain = guarded_plain
        torch.cuda.reset_peak_memory_stats()
        pa.proxy_attention.launches = 0
        report = run_retrieval_clipvip.main([
            "--dummy_data", "1", "--mode", "eval", "--clip_size", "base_32",
            "--device_ingest", "1", "--num_frm", "12", "--crop_img_size", "224",
            "--val_batch_size", str(EVAL_BATCH), "--device", "cuda",
            "--output_dir", out_dir, "--save_feats", f"{out_dir}/feats.npz",
        ])
        torch.cuda.synchronize()
        launches = pa.proxy_attention.launches
        pa.proxy_attention_plain = plain
        n_batches = math.ceil(run_retrieval_clipvip.DUMMY_VAL_SIZE / EVAL_BATCH)
        print(f"  kernel launches {launches} (expected {VIDEO_LAYERS} layers x {n_batches} batches); "
              f"plain path on CUDA: {len(plain_cuda_calls)} calls")
        check(launches == VIDEO_LAYERS * n_batches, "kernel launch count")
        check(not plain_cuda_calls, "the plain version ran on CUDA tensors")
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

    with phase("6 timing"):
        s = B32
        args = (s["M"], s["N"], s["L"], s["D"] ** -0.5)
        timings = {}
        for dtype in (torch.bfloat16, torch.float32):
            q, k, v = qkv(s, dtype)
            kernel = lambda: pa.proxy_attention(q, k, v, *args)  # noqa: E731
            plain_fn = lambda: pa.proxy_attention_plain(q, k, v, s["M"], s["L"], args[-1])  # noqa: E731
            runs = {"plain": [], "kernel": []}
            for name in ("plain", "kernel", "kernel", "plain"):
                runs[name].append(cuda_time_ms(kernel if name == "kernel" else plain_fn, iters=200))
            dt = str(dtype).split(".")[-1]
            timings[dt] = {name: sum(r) / len(r) for name, r in runs.items()}
            print(f"  proxy attention B/32 b=24 {dt}: kernel {runs['kernel']} ms, "
                  f"plain {runs['plain']} ms (CUDA events, 200 calls each) [{card}]")
            del q, k, v

        model = CLIPViPModel(CLIPVipConfig.base_patch32(dtype=torch.bfloat16), device="cuda")
        model.init_weights(torch.Generator(device="cuda").manual_seed(0)).eval()
        g = torch.Generator(device="cuda").manual_seed(1)
        video = torch.randint(0, 256, (EVAL_BATCH, 12, 224, 224, 3), device="cuda",
                              dtype=torch.uint8, generator=g)
        ids, mask = captions(np.random.default_rng(1), EVAL_BATCH)
        ids, mask = torch.from_numpy(ids).cuda(), torch.from_numpy(mask).cuda()
        # Windows of about 2 s each, so host-launch noise shows as spread.
        with torch.inference_mode():
            fwd = window_ms(lambda: model(video, ids, mask), iters=100)
            vid = window_ms(lambda: model.forward_video(video), iters=100)
            txt = window_ms(lambda: model.forward_text(ids, mask), iters=300)
        fwd_median = sorted(fwd)[len(fwd) // 2]
        print(f"  B/32 bf16 video+text forward b={EVAL_BATCH}: {spread(fwd)} = "
              f"{EVAL_BATCH / fwd_median * 1e3:.1f} clips/s at the median; windows {fwd} "
              f"(CUDA events, 100 calls per window, inputs on the card) [{card}]")
        print(f"  B/32 bf16 video tower b={EVAL_BATCH}: {spread(vid)}; windows {vid} [{card}]")
        print(f"  B/32 bf16 text tower b={EVAL_BATCH}: {spread(txt)}; windows {txt} "
              f"(300 calls per window) [{card}]")

    summary = {"kernels": [{
        "name": "proxy_attention_fwd",
        "route": "cuda",
        "source": KERNEL_SOURCE,
        "replaces": REPLACES,
        "launches": launches,
        "max_abs_err": errors[("b32", "bfloat16")],
        "ms": timings["bfloat16"]["kernel"],
        "plain_ms": timings["bfloat16"]["plain"],
    }]}
    print(json.dumps(summary))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count(),
    }}), flush=True)


if __name__ == "__main__":
    main()
