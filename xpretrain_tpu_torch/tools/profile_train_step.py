"""Time and profile the CLIP-ViP B/32 train step (or, with ``--serving``,
its serving forward) on one card.

Builds CLIP-ViP B/32 (bf16 compute, fp32 parameters, random weights from
a seed) with the MSR-VTT fine-tune preset's loss and optimizer (NCE with
a learnable temperature; grouped AdamW, betas (0.9, 0.98), wd 0.2, clip 2.0)
at a constant lr, takes steps on a synthetic batch of 32 clips that lives on the
card, and prints:

- the step's time in CUDA events: 5 windows of about 2 s each,
  median, min and max, and clips/s at the median;
- a ``torch.profiler`` trace of 3 further steps: device
  busy ms per step, the idle share against the median step, and the device
  time by op class (``train/profiling.py``), written with the trace under
  ``--output_dir``.

``--serving`` does the same for the bf16 video + text forward at b=24 under
``inference_mode`` (windows of 100 calls, 3 profiled calls).

Usage, from the repository root on a machine with a card:
    python -m xpretrain_tpu_torch.tools.profile_train_step --output_dir output/profile [--serving]
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from xpretrain_tpu_torch.train.profiling import device_us, key_average_rows

BATCH = 32  # the JAX package's train batch (bench.py)
SERVE_BATCH = 24  # the JAX package's serving batch (bench.py)
PROFILE_STEPS = 3


def captions(rng: np.random.Generator, batch: int, seq: int = 70) -> tuple[np.ndarray, np.ndarray]:
    """CLIP-style token ids: BOS, random ids, EOT (the highest id, where the
    text tower pools); mask = ids > 0."""
    ids = np.zeros((batch, seq), np.int64)
    ids[:, 0] = 49406
    for i, n in enumerate(rng.integers(3, seq - 1, size=batch)):
        ids[i, 1:n] = rng.integers(10, 49406, size=n - 1)
        ids[i, n] = 49407
    return ids, (ids > 0).astype(np.int64)


def synthetic_batch(batch: int, device: str, seed: int) -> dict:
    """uint8 clips [batch, 12, 224, 224, 3] drawn on ``device`` and 70-token
    captions: a batch of the B/32 model's device-ingest inputs."""
    g = torch.Generator(device=device).manual_seed(seed)
    ids, mask = captions(np.random.default_rng(seed), batch)
    return {
        "video": torch.randint(0, 256, (batch, 12, 224, 224, 3), device=device,
                               dtype=torch.uint8, generator=g),
        "text_input_ids": torch.from_numpy(ids).to(device),
        "text_input_mask": torch.from_numpy(mask).to(device),
    }


def train_step_parts(model, lr: float):
    """(step, state) of the port's train step for ``model``: NCE loss,
    grouped AdamW at a constant ``lr``, clip 2.0, as the fine-tune preset."""
    from xpretrain_tpu_torch.models.clip_vip.convert import flax_param_paths
    from xpretrain_tpu_torch.ops.losses import build_loss_fn
    from xpretrain_tpu_torch.optim.optimizer import build_optimizer
    from xpretrain_tpu_torch.optim.schedules import get_schedule
    from xpretrain_tpu_torch.parallel.train_step import TrainState, make_train_step

    optimizer, _ = build_optimizer(dict(model.named_parameters()), get_schedule("constant", lr, 10),
                                   paths=flax_param_paths(model.config))
    device = next(model.parameters()).device
    step = make_train_step(
        lambda m, b, g: m(b["video"], b["text_input_ids"], b["text_input_mask"], generator=g),
        build_loss_fn("NCELearnableTempLoss"), device,
    )
    return step, TrainState(step=0, model=model, optimizer=optimizer)


def cuda_time_ms(fn, iters: int, warmup: int = 3) -> float:
    """Mean ms per call of ``fn`` over ``iters`` calls, in CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def device_ms(fn, iters: int, warmup: int = 3) -> float:
    """Device time per call of ``fn`` (ms): every device kernel, copy and set
    that ``iters`` calls launch, from a ``torch.profiler`` trace, summed and
    divided by ``iters``. The host's time between launches is not in it."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    return device_us(key_average_rows(prof)) / 1e3 / iters


def window_ms(fn, iters: int, windows: int = 5) -> list[float]:
    """Per-call ms of ``fn`` in ``windows`` back-to-back windows of ``iters`` calls."""
    return [cuda_time_ms(fn, iters, warmup=3 if i == 0 else 0) for i in range(windows)]


def median(ms: list[float]) -> float:
    return sorted(ms)[len(ms) // 2]


def spread(ms: list[float]) -> str:
    ms = sorted(ms)
    return f"median {median(ms):.4f} ms (min {ms[0]:.4f}, max {ms[-1]:.4f}, {len(ms)} windows)"


def time_train_step(batch: int):
    """Build the B/32 bf16 model and its train step on the card, time the step
    on a synthetic batch; returns (train, per-step ms of each window, steps
    per window, peak device GiB), where ``train()`` takes one more step."""
    from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel

    model = CLIPViPModel(CLIPVipConfig.base_patch32(dtype=torch.bfloat16), device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    step, state = train_step_parts(model, 1e-6)
    inputs = synthetic_batch(batch, "cuda", 3)
    train = lambda: step(state, inputs, 0)  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    iters = max(1, round(2000 / cuda_time_ms(train, iters=3)))  # windows of about 2 s
    steps_ms = window_ms(train, iters=iters)
    return train, steps_ms, iters, torch.cuda.max_memory_allocated() / 2**30


def time_serving(batch: int):
    """Build the B/32 bf16 model in eval mode and time its video + text
    forward on a synthetic batch on the card, under ``inference_mode``;
    returns (serve, per-call ms of each window, calls per window, peak GiB)."""
    from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel

    model = CLIPViPModel(CLIPVipConfig.base_patch32(dtype=torch.bfloat16), device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0)).eval()
    inputs = synthetic_batch(batch, "cuda", 1)

    def serve():
        with torch.inference_mode():
            model(inputs["video"], inputs["text_input_ids"], inputs["text_input_mask"])

    torch.cuda.reset_peak_memory_stats()
    iters = 100
    return serve, window_ms(serve, iters=iters), iters, torch.cuda.max_memory_allocated() / 2**30


def main(argv=None) -> dict:
    from xpretrain_tpu_torch.train.profiling import start_profiler, stop_profiler

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--output_dir", type=str, default="output/profile_train_step")
    parser.add_argument("--serving", action="store_true",
                        help=f"profile the video + text forward at b={SERVE_BATCH} instead of the train step")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("profile_train_step times the step on a card; torch sees no CUDA device")

    if args.serving:
        batch, what, unit = SERVE_BATCH, "video+text forward", "call"
        run, steps_ms, iters, peak_gib = time_serving(batch)
    else:
        batch, what, unit = BATCH, "train step", "step"
        run, steps_ms, iters, peak_gib = time_train_step(batch)
    print(f"B/32 bf16 {what} b={batch}: {spread(steps_ms)} = "
          f"{batch / median(steps_ms) * 1e3:.1f} clips/s at the median; windows {steps_ms} "
          f"(CUDA events, {iters} {unit}s per window); peak device memory {peak_gib:.2f} GiB", flush=True)

    prof = start_profiler()
    for _ in range(PROFILE_STEPS):
        run()
    table = stop_profiler(prof, args.output_dir, PROFILE_STEPS)
    busy = sum(r["device_ms_per_step"] for r in table)
    print(f"profile of {PROFILE_STEPS} {unit}s: device busy {busy:.3f} ms per {unit}, idle share "
          f"{1 - busy / median(steps_ms):.3f} of the median {unit}; files in {args.output_dir}")
    print(f"| op class | device ms / {unit} | share | launches / {unit} |\n| --- | --- | --- | --- |")
    for r in table:
        print(f"| {r['class']} | {r['device_ms_per_step']:.3f} | {100 * r['share']:.1f}% "
              f"| {r['launches_per_step']:.0f} |")
    result = {"batch": batch, "what": what, "step_ms": steps_ms, "peak_gib": peak_gib, "busy_ms": busy,
              "classes": table}
    print(json.dumps(result))
    return result


if __name__ == "__main__":
    main()
