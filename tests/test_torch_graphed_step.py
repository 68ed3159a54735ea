"""The K-step train step on a card (``parallel/train_step.py:GraphedStep``):
a tiny CLIP-ViP's steps as replays of one captured CUDA graph against the
same steps run eagerly, and the proxy kernels' launch counters after the
replays. Those need an NVIDIA card; on it, run
``python -m pytest tests/test_torch_graphed_step.py -m cuda --noconftest``.
Two CPU tests hold what a capture relies on: the registry of counted kernel
wrappers and constants made once per device. The CPU path of the same
steps is ``tests/test_torch_train_step.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.models.clip_vip.convert import flax_param_paths  # noqa: E402
from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel, VipConfig  # noqa: E402
from xpretrain_tpu_torch.ops import proxy_attention as pa  # noqa: E402
from xpretrain_tpu_torch.ops.losses import build_loss_fn  # noqa: E402
from xpretrain_tpu_torch.optim.optimizer import build_optimizer  # noqa: E402
from xpretrain_tpu_torch.optim.schedules import get_schedule  # noqa: E402
from xpretrain_tpu_torch.parallel.train_step import TrainState, make_train_step  # noqa: E402
from xpretrain_tpu_torch.train.trainer import ClipVipTrainer  # noqa: E402

IMAGE, SEQ, TEMPORAL, BATCH, STEPS = 32, 16, 3, 4, 4


def _state(accum: int) -> TrainState:
    cfg = CLIPVipConfig.tiny_debug(image_size=IMAGE, vip=VipConfig(temporal_size=TEMPORAL), dtype=torch.bfloat16)
    model = CLIPViPModel(cfg, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    opt, _ = build_optimizer(dict(model.named_parameters()), get_schedule("cosine", 1e-3, 10, warmup_ratio=0.2),
                             grad_accum_steps=accum, paths=flax_param_paths(cfg))
    return TrainState(step=0, model=model, optimizer=opt)


def _batches() -> dict:
    rng = np.random.default_rng(0)
    ids = np.zeros((STEPS, BATCH, SEQ), np.int64)
    ids[..., 0] = 49406
    ids[..., 1:8] = rng.integers(10, 400, size=(STEPS, BATCH, 7))
    ids[..., 8] = 49407
    video = rng.integers(0, 256, size=(STEPS, BATCH, TEMPORAL, IMAGE, IMAGE, 3), dtype=np.uint8)
    return {"video": torch.from_numpy(video).cuda(), "text_input_ids": torch.from_numpy(ids).cuda(),
            "text_input_mask": torch.from_numpy((ids > 0).astype(np.int64)).cuda()}


@pytest.mark.cuda
@pytest.mark.parametrize("accum", [1, 2], ids=["plain", "accum_2"])
def test_graphed_steps_equal_eager_steps(accum):
    """4 steps at K = 4 (a warm-up per micro-step index, a capture, then
    replays) against 4 eager steps on the same batches and seeds: parameters
    and moments bit-identical, per-step losses equal, and 2 + 2 proxy
    launches a step counted at replay (the tiny model's 2 video layers)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    loss_fn = build_loss_fn("NCELearnableTempLoss")
    batches = _batches()
    eager_state, graphed_state = _state(accum), _state(accum)
    eager = make_train_step(ClipVipTrainer._apply_train, loss_fn, "cuda")
    losses = []
    for i in range(STEPS):
        _, m = eager(eager_state, {k: v[i] for k, v in batches.items()}, 7 + i)
        losses.append(m["loss"])
    graphed = make_train_step(ClipVipTrainer._apply_train, loss_fn, "cuda", steps_per_call=STEPS)
    before = (pa.proxy_attention.launches, pa.proxy_attention_bwd.launches)
    _, metrics = graphed(graphed_state, batches, 7)
    torch.cuda.synchronize()
    launched = (pa.proxy_attention.launches - before[0], pa.proxy_attention_bwd.launches - before[1])
    assert launched == (2 * STEPS, 2 * STEPS)
    assert len(graphed.graphed.captures) == accum and all(c is not None for c in graphed.graphed.captures.values())
    assert metrics["loss"].shape == (STEPS,) and torch.equal(metrics["loss"], torch.stack(losses))
    assert graphed_state.step == eager_state.step == STEPS
    assert graphed_state.optimizer.count == eager_state.optimizer.count == STEPS // accum
    for (name, p), q in zip(eager_state.model.named_parameters(), graphed_state.model.parameters()):
        assert torch.equal(p, q), name
    for moment in ("mu", "nu"):
        for a, b in zip(getattr(eager_state.optimizer, moment), getattr(graphed_state.optimizer, moment)):
            assert torch.equal(a, b)


def test_every_kernel_wrapper_is_in_the_counted_registry():
    """The graphed step adds each capture's recorded launches, at replay, to
    the wrappers of ``ops._kernels.COUNTED``: the eight wrappers that launch a
    kernel (the optimizer's among them) are there, each with its
    ``launches`` count, and only they."""
    from xpretrain_tpu_torch.ops import _kernels, frozen_bn, patchify, window_attention
    from xpretrain_tpu_torch.optim import adamw_kernel

    want = {pa.proxy_attention, pa.proxy_attention_bwd, pa.proxy_attention_packed, pa.proxy_attention_packed_bwd,
            window_attention.window_attention, patchify.fused_patch_embed, frozen_bn.frozen_bn_act,
            adamw_kernel.adamw_multi_tensor}
    assert set(_kernels.COUNTED) == want and len(_kernels.COUNTED) == len(want)
    assert all(isinstance(fn.launches, int) and fn.launches >= 0 for fn in _kernels.COUNTED)


def test_a_forwards_constants_are_made_once_per_device():
    """A captured graph holds no host-to-device copy, so a constant a forward
    needs is made once per device and shared (``common.device_constant``):
    HD-VILA's 0-255 ImageNet normalization gives the formula's values from
    one cached tensor, and BERT's block-local mask is one tensor too."""
    from xpretrain_tpu_torch.models import bert
    from xpretrain_tpu_torch.models.common import device_constant
    from xpretrain_tpu_torch.models.hd_vila import e2e

    images = torch.from_numpy(np.random.default_rng(0).integers(0, 256, size=(2, 3, 4, 5), dtype=np.uint8))
    mean = torch.tensor(e2e.IMAGENET_MEAN_255).reshape(1, 3, 1, 1)
    std = torch.tensor(e2e.IMAGENET_STD_255).reshape(1, 3, 1, 1)
    assert torch.equal(e2e.HdVilaEncoder.normalize(images), (images.float() - mean) / std)
    cpu = torch.device("cpu")
    assert device_constant(e2e._imagenet_255, (), cpu) is device_constant(e2e._imagenet_255, (), cpu)
    assert bert._block_local_mask(12, 4, cpu) is bert._block_local_mask(12, 4, cpu)
