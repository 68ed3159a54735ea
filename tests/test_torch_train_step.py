"""Port parity, the training slice as a whole: the JAX ``make_train_step`` on
a one-device CPU mesh against the port's ``make_train_step``, for a tiny
CLIP-ViP in fp32 loaded from the same params, on the same numpy batches.

Tolerances, each with its reason:
- gradients: 2e-5 relative to each tensor's largest entry, plus 5e-7: fp32
  sums in another order than XLA's, through two 2-layer towers and the loss.
  The 5e-7 is for the key-projection biases, whose gradient is 0 in exact
  arithmetic (softmax ignores a constant added to every score of a row), so
  that both sides hold rounding noise of up to ~1e-7 there;
- loss 1e-5 and grad_norm 1e-5 relative: the same sums, reduced;
- params after 3 AdamW steps at lr 1e-3: all but 1e-4 of the elements within
  1e-6, and every element within 2 * 3 * lr. Adam's step is
  lr * m_hat / (sqrt(v_hat) + eps), ~lr * sign(g) after few steps, so an
  element whose |g| sits near eps = 1e-6 can turn with the last digits of its
  gradient, by up to 2 lr a step; elsewhere the steps agree to fp32 rounding.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.models.clip_vip.convert import flax_param_paths, load_jax_params  # noqa: E402
from xpretrain_tpu_torch.models.clip_vip.model import (  # noqa: E402
    CLIPVipConfig,
    CLIPViPModel,
    VipConfig,
)
from xpretrain_tpu_torch.ops.losses import build_loss_fn  # noqa: E402
from xpretrain_tpu_torch.optim.optimizer import build_optimizer  # noqa: E402
from xpretrain_tpu_torch.optim.schedules import get_schedule  # noqa: E402
from xpretrain_tpu_torch.parallel.train_step import TrainState, make_train_step  # noqa: E402
from xpretrain_tpu_torch.train.trainer import ClipVipTrainer  # noqa: E402

IMAGE, SEQ, TEMPORAL, BATCH, STEPS, LR = 32, 16, 3, 4, 3, 1e-3
OPT = dict(weight_decay=0.2, betas=(0.9, 0.98), max_grad_norm=2.0)


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = np.zeros((BATCH, SEQ), np.int64)
    ids[:, 0] = 49406
    for i, n in enumerate(rng.integers(3, SEQ - 1, size=BATCH)):
        ids[i, 1:n] = rng.integers(10, 400, size=n - 1)
        ids[i, n] = 49407
    video = rng.integers(0, 256, size=(BATCH, TEMPORAL, IMAGE, IMAGE, 3), dtype=np.uint8)
    return {"video": video, "text_input_ids": ids, "text_input_mask": (ids > 0).astype(np.int64)}


def _port_model(params, **overrides):
    model = CLIPViPModel(CLIPVipConfig.tiny_debug(
        image_size=IMAGE, vip=VipConfig(temporal_size=TEMPORAL), **overrides))
    return load_jax_params(model, {"params": params})


def _apply(model, batch, generator):
    return model(batch["video"], batch["text_input_ids"], batch["text_input_mask"], generator=generator)


def _torch_batch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def jax_run():
    """JAX: initial params, one step's gradients, and a 3-step trajectory
    (metrics per step, params after the last). The step compiles once."""
    import jax
    import jax.numpy as jnp

    from xpretrain_tpu.models.clip_vip import CLIPVipConfig as JaxConfig
    from xpretrain_tpu.models.clip_vip import CLIPViPModel as JaxModel
    from xpretrain_tpu.models.clip_vip import VipConfig as JaxVip
    from xpretrain_tpu.ops.losses import build_loss_fn as jax_loss
    from xpretrain_tpu.optim import build_optimizer as jax_opt
    from xpretrain_tpu.optim import get_schedule as jax_sched
    from xpretrain_tpu.optim.optimizer import clamp_logit_scale
    from xpretrain_tpu.parallel.mesh import create_mesh, shard_host_batch
    from xpretrain_tpu.parallel.train_step import TrainState as JaxState
    from xpretrain_tpu.parallel.train_step import contrastive_loss_from_outputs
    from xpretrain_tpu.parallel.train_step import make_train_step as jax_step

    model = JaxModel(JaxConfig.tiny_debug(image_size=IMAGE, vip=JaxVip(temporal_size=TEMPORAL)))
    b0 = _batch(0)
    params = model.init(jax.random.PRNGKey(0), *(jnp.asarray(b0[k]) for k in b0))["params"]
    rng = np.random.default_rng(7)  # every leaf random, zero-init ones included
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * rng.normal(size=np.shape(x)).astype(np.float32), params
    )
    loss_fn = jax_loss("NCELearnableTempLoss")

    def apply_fn(p, batch, rng):
        return model.apply({"params": p}, batch["video"], batch["text_input_ids"],
                           batch["text_input_mask"], deterministic=False, rngs={"dropout": rng})

    def loss_of(p, batch):
        return contrastive_loss_from_outputs(apply_fn(p, batch, jax.random.PRNGKey(1)), loss_fn)

    grads = jax.jit(jax.grad(loss_of))(clamp_logit_scale(params), {k: jnp.asarray(v) for k, v in b0.items()})

    mesh = create_mesh(devices=jax.devices()[:1])
    tx, _ = jax_opt(params, jax_sched("constant", LR, 10), **OPT)
    step = jax_step(apply_fn, tx, mesh, loss_fn, donate=False)
    state = JaxState.create(params, tx)
    metrics = []
    for i in range(STEPS):
        state, m = step(state, shard_host_batch(_batch(i), mesh), jax.random.PRNGKey(i))
        metrics.append({k: float(v) for k, v in m.items()})
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(params), to_np(grads), metrics, to_np(state.params)


def _assert_state_close(got: dict, want: dict, atol=0.0, rel=0.0, what=""):
    for key, w in want.items():
        g = got[key].detach().numpy()
        tol = atol + rel * float(np.abs(w).max())
        np.testing.assert_allclose(g, w.numpy(), rtol=0, atol=tol, err_msg=f"{what} {key}")


def _assert_adam_close(got: dict, want: dict):
    diffs = np.concatenate([np.abs(got[k].detach().numpy() - w.numpy()).ravel() for k, w in want.items()])
    assert diffs.max() <= 2 * STEPS * LR, diffs.max()
    assert np.mean(diffs > 1e-6) <= 1e-4, np.mean(diffs > 1e-6)


def test_one_step_gradients_match_jax(jax_run):
    params, grads, _, _ = jax_run
    model = _port_model(params).train()
    with torch.no_grad():
        model.logit_scale.clamp_(0.0, 5.2983)  # the step clamps before its forward
    out = _apply(model, _torch_batch(_batch(0)), None)
    build_loss_fn("NCELearnableTempLoss")(out["vis_features"], out["text_features"], out["logit_scale"]).backward()
    want = _port_model(grads).state_dict()  # the JAX grads tree, mapped like params
    got = {name: p.grad for name, p in model.named_parameters()}
    _assert_state_close(got, want, atol=5e-7, rel=2e-5, what="grad")


def test_three_step_trajectory_matches_jax(jax_run):
    params, _, metrics, final = jax_run
    model = _port_model(params)
    named = dict(model.named_parameters())
    optimizer, _ = build_optimizer(named, get_schedule("constant", LR, 10),
                                   paths=flax_param_paths(model.config), **OPT)
    step = make_train_step(_apply, build_loss_fn("NCELearnableTempLoss"), "cpu")
    state = TrainState(step=0, model=model, optimizer=optimizer)
    for i in range(STEPS):
        state, m = step(state, _torch_batch(_batch(i)), i)
        for key in ("loss", "grad_norm", "logit_scale"):
            np.testing.assert_allclose(m[key].item(), metrics[i][key], rtol=1e-5, err_msg=f"step {i} {key}")
    assert state.step == STEPS and optimizer.count == STEPS
    _assert_adam_close(model.state_dict(), _port_model(final).state_dict())


def test_remat_gives_the_same_gradients(jax_run):
    """remat recomputes each layer in the backward; with attention dropout on,
    the recompute replays the forward's keep masks from the generator."""
    params = jax_run[0]
    batch = _torch_batch(_batch(1))
    grads = []
    for remat in (False, True):
        model = _port_model(params, remat=remat).train()
        for mod in model.modules():
            if hasattr(mod, "dropout_rate"):
                mod.dropout_rate = 0.1
        out = _apply(model, batch, torch.Generator().manual_seed(3))
        build_loss_fn("NCELearnableTempLoss")(out["vis_features"], out["text_features"], out["logit_scale"]).backward()
        grads.append({n: p.grad.clone() for n, p in model.named_parameters()})
    for name, g in grads[0].items():
        torch.testing.assert_close(grads[1][name], g, rtol=0, atol=1e-7, msg=name)


def test_image_branch_raises(jax_run):
    """The image branch needs its captions (the branch itself:
    ``tests/test_torch_clipvip_pretrain.py``)."""
    model = _port_model(jax_run[0])
    b = _torch_batch(_batch(0))
    with pytest.raises(ValueError, match="caption_ids"):
        model(b["video"], b["text_input_ids"], b["text_input_mask"], image=b["video"][:, :1])


@pytest.mark.parametrize(
    "flag,error",
    [
        ({"steps_per_call": 2}, "steps_per_call"),
        ({"param_dtype": "bf16"}, "param_dtype"),
        ({"async_checkpoint": 1}, "async"),
        ({"tp": 2}, "tp"),
        ({"zero3": 1}, "zero3"),
    ],
)
def test_trainer_raises_on_what_is_not_ported(tmp_path, flag, error):
    from xpretrain_tpu.config import ConfigDict

    cfg = ConfigDict(clip_size="tiny", crop_img_size=IMAGE, bf16=0, output_dir=str(tmp_path), **flag)
    with pytest.raises(NotImplementedError, match=error):
        ClipVipTrainer(cfg, train_loader=iter(()), device="cpu")


def test_trainer_takes_jax_params(jax_run, tmp_path):
    from xpretrain_tpu.config import ConfigDict

    params = jax_run[0]
    cfg = ConfigDict(clip_size="tiny", crop_img_size=IMAGE, bf16=0, output_dir=str(tmp_path),
                     clip_vision_additional_config={"temporal_size": TEMPORAL})
    trainer = ClipVipTrainer(cfg, train_loader=iter(()), init_params={"params": params}, device="cpu")
    want = _port_model(params).state_dict()
    for key, value in trainer.model.state_dict().items():
        torch.testing.assert_close(value, want[key], rtol=0, atol=0, msg=key)


def test_checkpoint_manager_rotates_and_restores_latest(tmp_path):
    from xpretrain_tpu_torch.train.checkpoints import CheckpointManager

    mgr = CheckpointManager(str(tmp_path / "ckpt"), max_to_keep=2)
    assert mgr.restore() is None
    for step in (2, 4, 6):
        mgr.save(step, {"step": step, "w": torch.full((3,), float(step))})
    assert mgr.steps() == [4, 6] and sorted(p.name for p in (tmp_path / "ckpt").iterdir()) == ["4.pt", "6.pt"]
    state = mgr.restore()
    assert state["step"] == 6 and torch.equal(state["w"], torch.full((3,), 6.0))
    assert mgr.restore(4)["step"] == 4
