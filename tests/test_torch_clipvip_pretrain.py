"""Port parity, CLIP-ViP pretraining: the image/caption branch of
``CLIPViPModel``, its ``vsc_fc`` loss and gradients, one trainer step, the
pretraining host layer (``PretrainCollator``, ``MetaLoader``) and the
``run_pretrain_clipvip`` runner, each against the JAX package on the CPU in
fp32 from the same params and numpy inputs.

Tolerances, each with its reason:
- features 2e-5 (PARITY.md's CLIP-ViP bar): fp32 sums in another order;
- gradients 2e-5 of each tensor's max|g|, plus 5e-7 for the key biases whose
  gradient is rounding noise around 0 (as ``test_torch_train_step.py``);
- the trainer step's loss and grad norm 1e-5 relative (as there); the two
  runners' logged losses 1e-4 relative after two AdamW steps;
- the host layer's batches and task draws: bit-equal.
"""

import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.cli import run_pretrain_clipvip  # noqa: E402
from xpretrain_tpu_torch.config import parse_with_config  # noqa: E402
from xpretrain_tpu_torch.data import datasets, loader, tokenization, transforms  # noqa: E402
from xpretrain_tpu_torch.models.clip_vip.convert import (  # noqa: E402
    clip_key_rules,
    load_jax_params,
    torch_clip_state_dict,
)
from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel, VipConfig  # noqa: E402
from xpretrain_tpu_torch.ops.losses import build_loss_fn  # noqa: E402
from xpretrain_tpu_torch.ops.proxy_attention import proxy_attention  # noqa: E402
from xpretrain_tpu_torch.parallel.train_step import TrainState, contrastive_loss_from_outputs  # noqa: E402
from xpretrain_tpu_torch.train.trainer import ClipVipTrainer  # noqa: E402

IMAGE, SEQ, FRAMES, TEMPORAL, BATCH = 32, 16, 2, 12, 4
LOSS = "NCELearnableTempLoss_vsc_fc"
ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: beside the other test processes, torch's
    all-cores default oversubscribes the CPU many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _tokens(rng, shape):
    ids = np.zeros((*shape, SEQ), np.int64)
    ids[..., 0] = 49406
    for idx in np.ndindex(*shape):
        n = int(rng.integers(3, SEQ - 1))
        ids[idx + (slice(1, n),)] = rng.integers(10, 400, size=n - 1)
        ids[idx + (n,)] = 49407  # EOT: the highest id, where argmax pools
    return ids, (ids > 0).astype(np.int64)


def _batch(seed):
    """A pretraining batch as ``PretrainCollator`` gives it: fp32 video
    [B, T, C, H, W], one fp32 image [B, 1, C, H, W] and one caption [B, 1, L]
    per clip."""
    rng = np.random.default_rng(seed)
    frames = rng.integers(0, 256, size=(BATCH, FRAMES + 1, IMAGE, IMAGE, 3), dtype=np.uint8)
    video = np.stack([transforms.normalize(f[:FRAMES]) for f in frames])
    image = np.stack([transforms.normalize(f[FRAMES:]) for f in frames])
    ids, mask = _tokens(rng, (BATCH,))
    cap_ids, cap_mask = _tokens(rng, (BATCH, 1))
    return {"video": video, "text_input_ids": ids, "text_input_mask": mask, "image": image,
            "caption_ids": cap_ids, "caption_masks": cap_mask}


def _torch(batch):
    return {k: torch.from_numpy(v) for k, v in batch.items()}


def _port_model(params):
    model = CLIPViPModel(CLIPVipConfig.tiny_debug(image_size=IMAGE, vip=VipConfig(temporal_size=TEMPORAL)))
    return load_jax_params(model, {"params": params})


@pytest.fixture(scope="module")
def jax_run():
    """The JAX model's noisy params (every leaf random), its four features on
    batch 0, and the ``vsc_fc`` loss's value and gradients there (at the
    logit scale the step clamps to)."""
    import jax
    import jax.numpy as jnp

    from xpretrain_tpu.models.clip_vip import CLIPVipConfig as JaxConfig
    from xpretrain_tpu.models.clip_vip import CLIPViPModel as JaxModel
    from xpretrain_tpu.models.clip_vip import VipConfig as JaxVip
    from xpretrain_tpu.ops.losses import build_loss_fn as jax_loss
    from xpretrain_tpu.optim.optimizer import clamp_logit_scale
    from xpretrain_tpu.parallel.train_step import contrastive_loss_from_outputs as jax_contrastive

    model = JaxModel(JaxConfig.tiny_debug(image_size=IMAGE, vip=JaxVip(temporal_size=TEMPORAL)))
    b0 = {k: jnp.asarray(v) for k, v in _batch(0).items()}
    params = jax.jit(model.init)(jax.random.PRNGKey(0), b0["video"], b0["text_input_ids"],
                                 b0["text_input_mask"])["params"]
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * rng.normal(size=np.shape(x)).astype(np.float32), params)

    def apply(p, batch):
        return model.apply({"params": p}, batch["video"], batch["text_input_ids"], batch["text_input_mask"],
                           image=batch["image"], caption_ids=batch["caption_ids"],
                           caption_masks=batch["caption_masks"])

    def loss_of(p, batch):
        out = apply(p, batch)
        return jax_contrastive(out, jax_loss(LOSS)), out

    # the clamp moves logit_scale alone, which no feature reads
    (loss, feats), grads = jax.jit(jax.value_and_grad(loss_of, has_aux=True))(clamp_logit_scale(params), b0)
    to_np = lambda t: jax.tree_util.tree_map(np.asarray, t)  # noqa: E731
    return to_np(params), to_np(feats), float(loss), to_np(grads)


def test_image_caption_forward_matches_jax(jax_run):
    params, want, *_ = jax_run
    model = _port_model(params).eval()
    with torch.no_grad():
        got = model(**_torch(_batch(0)))
    assert set(got) == set(want) == {"text_features", "vis_features", "img_features", "cap_features", "logit_scale"}
    for key in ("text_features", "vis_features", "img_features", "cap_features"):
        assert got[key].shape == want[key].shape == (BATCH, 32), key
        np.testing.assert_allclose(got[key].numpy(), want[key], atol=ATOL, rtol=0, err_msg=key)


def test_image_branch_is_a_one_frame_clip(jax_run):
    """An image goes through the video tower as a one-frame clip: its
    features are ``forward_video`` of [B, 1, C, H, W], whose temporal
    embedding is the lerp of rows 5 and 6 of the 12 (x = 5.5)."""
    model = _port_model(jax_run[0]).eval()
    batch = _torch(_batch(1))
    with torch.no_grad():
        got = model(**batch)["img_features"]
        want = model.forward_video(batch["image"])
        emb = model.vision_model.embeddings
        lerp = emb._time_embed(1)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    torch.testing.assert_close(lerp[0, 0], 0.5 * (emb.temporal_embedding[0, 5] + emb.temporal_embedding[0, 6]),
                               atol=1e-7, rtol=0)


def test_vsc_fc_loss_and_gradients_match_jax(jax_run):
    """The loss reads all four features, so every parameter has a gradient;
    the temporal embedding's comes from both branches: the video's T=2 lerps
    rows 2, 3, 8 and 9, the image's rows 5 and 6."""
    params, _, loss, grads = jax_run
    model = _port_model(params).train()
    with torch.no_grad():
        model.logit_scale.clamp_(0.0, 5.2983)  # the step clamps before its forward
    out = model(**_torch(_batch(0)))
    got_loss = contrastive_loss_from_outputs(out, build_loss_fn(LOSS))
    got_loss.backward()
    np.testing.assert_allclose(got_loss.item(), loss, rtol=1e-5)
    want = _port_model(grads).state_dict()  # the JAX grads tree, mapped like params
    for name, p in model.named_parameters():
        w = want[name].numpy()
        assert p.grad is not None, name
        tol = 5e-7 + ATOL * float(np.abs(w).max())
        np.testing.assert_allclose(p.grad.numpy(), w, atol=tol, rtol=0, err_msg=name)
    rows = np.abs(model.vision_model.embeddings.temporal_embedding.grad[0].numpy()).sum(-1)
    assert (rows[[2, 3, 5, 6, 8, 9]] > 0).all() and not rows[[0, 1, 4, 7, 10, 11]].any(), rows


def test_the_pair_loss_leaves_the_image_branch_without_gradient(jax_run):
    """What the JAX runner trains on without a config (its loss default never
    takes effect): the pair loss reads neither image nor caption features, so
    a temporal row only the image reaches gets no gradient."""
    model = _port_model(jax_run[0]).train()
    out = model(**_torch(_batch(0)))
    contrastive_loss_from_outputs(out, build_loss_fn("NCELearnableTempLoss")).backward()
    rows = np.abs(model.vision_model.embeddings.temporal_embedding.grad[0].numpy()).sum(-1)
    assert not rows[[5, 6]].any() and rows[[2, 3]].all()


def test_trainer_step_with_the_image_branch_matches_jax(jax_run, tmp_path):
    """One ``ClipVipTrainer`` train step on a pretraining batch: its forward
    runs the image branch (``_apply_train``), and its loss and gradient norm
    are JAX's."""
    import jax

    from xpretrain_tpu.config import ConfigDict

    params, _, loss, grads = jax_run
    cfg = ConfigDict(clip_size="tiny", crop_img_size=IMAGE, bf16=0, loss_name=LOSS, seed=0, learning_rate=1e-3,
                     clip_vision_additional_config={"temporal_size": TEMPORAL}, output_dir=str(tmp_path))
    trainer = ClipVipTrainer(cfg, train_loader=iter(()), init_params=params, device="cpu")
    state = TrainState(step=0, model=trainer.model, optimizer=trainer.optimizer)
    _, metrics = trainer.train_step(state, _torch(_batch(0)), 0)
    norm = float(np.sqrt(sum(float((np.asarray(g, np.float64) ** 2).sum()) for g in jax.tree_util.tree_leaves(grads))))
    np.testing.assert_allclose(metrics["loss"].item(), loss, rtol=1e-5)
    np.testing.assert_allclose(metrics["grad_norm"].item(), norm, rtol=1e-5)


def test_image_and_video_at_one_frame_through_proxy_attention():
    """The proxy attention at the image branch's N = 1 (S = M + L rows) on the
    CPU path against the JAX kernel in interpret mode."""
    import jax.numpy as jnp

    from xpretrain_tpu.ops.proxy_attention import proxy_flash_attention

    M, N, L, D = 4, 1, 49, 64
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(2, 2, M + N * L, D)).astype(np.float32) for _ in range(3))
    want = proxy_flash_attention(*map(jnp.asarray, (q, k, v)), M, N, L, D**-0.5, interpret=True)
    got = proxy_attention(*map(torch.from_numpy, (q, k, v)), M, N, L, D**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


# -- the host layer ----------------------------------------------------------


@pytest.mark.parametrize("mlm", [False, True], ids=["plain", "mlm"])
def test_pretrain_collator_matches_jax(mlm):
    from xpretrain_tpu.cli import run_pretrain_clipvip as jax_runner
    from xpretrain_tpu.data import datasets as jax_datasets
    from xpretrain_tpu.data import tokenization as jax_tokenization

    def batches(runner, ds_mod, tok_mod):
        ds = runner._SyntheticPretrain(8, 3, 24, seed=4)
        collate = ds_mod.PretrainCollator(tok_mod.HashTokenizer(), max_txt_len=12, mlm=mlm, seed=9)
        return [collate([ds[i] for i in range(j, j + 3)]) for j in (0, 3)]

    got = batches(run_pretrain_clipvip, datasets, tokenization)
    want = batches(jax_runner, jax_datasets, jax_tokenization)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for key in g:
            assert g[key].dtype == w[key].dtype, key
            np.testing.assert_array_equal(g[key], w[key], err_msg=key)
    assert got[0]["image"].shape == (3, 1, 3, 24, 24) and got[0]["caption_ids"].shape == (3, 1, 12)
    assert got[0]["video"].dtype == np.float32 and ("mlm_labels" in got[0]) == mlm


def test_meta_loader_draws_the_tasks_jax_draws():
    from xpretrain_tpu.data import loader as jax_loader

    def draws(mod):
        loaders = {name: (mod.BatchLoader(list(range(n)), 2, np.asarray, seed=i), ratio)
                   for i, (name, n, ratio) in enumerate((("a", 6, 2), ("b", 4, 1), ("c", 10, 3)))}
        meta = mod.MetaLoader(loaders, seed=11)
        return [next(meta) for _ in range(40)]

    got, want = draws(loader), draws(jax_loader)
    assert [t for t, _ in got] == [t for t, _ in want] and {t for t, _ in got} == {"a", "b", "c"}
    for (_, g), (_, w) in zip(got, want):
        np.testing.assert_array_equal(g, w)


# -- the runner ---------------------------------------------------------------

RUNNER = ["--dummy_data", "1", "--clip_size", "tiny", "--num_frm", "2", "--crop_img_size", "32",
          "--train_batch_size", "8", "--num_train_steps", "2", "--log_steps", "1", "--save_steps", "100",
          "--bf16", "0", "--learning_rate", "1e-3", "--warmup_ratio", "0", "--decay", "constant"]


def _losses(out_dir):
    with open(os.path.join(out_dir, "log", "scalars.jsonl")) as f:
        return [row["value"] for row in map(json.loads, f) if row["tag"] == "train/loss"]


class _FirstBatchTwice:
    """A loader that yields its first batch twice: the JAX trainer draws one
    batch for its init shapes and trains from the next, the port's trains
    from the first, so the JAX side sees that batch again."""

    def __init__(self, inner):
        self.inner, self.calls, self.first = inner, 0, None

    def __iter__(self):
        return self

    def __next__(self):
        self.calls += 1
        if self.calls == 1:
            self.first = next(self.inner)
        return self.first if self.calls <= 2 else next(self.inner)


def test_runner_matches_the_jax_runner(tmp_path, monkeypatch):
    """The slice as a whole: both packages' ``run_pretrain_clipvip`` for two
    steps on the synthetic pretraining data, from one ``--clip_weights`` file
    that covers every parameter (written from a seeded port model, noise on
    every tensor); their logged losses agree."""
    from xpretrain_tpu.cli import run_pretrain_clipvip as jax_runner
    from xpretrain_tpu.data import loader as jax_loader

    monkeypatch.setattr(jax_runner, "MetaLoader", lambda *a, **kw: _FirstBatchTwice(jax_loader.MetaLoader(*a, **kw)))

    model = CLIPViPModel(CLIPVipConfig.tiny_debug(image_size=32))
    model.init_weights(torch.Generator().manual_seed(5))
    g = torch.Generator().manual_seed(6)
    weights = {k: v + 0.02 * torch.randn(v.shape, generator=g) for k, v in torch_clip_state_dict(model).items()}
    assert set(weights) == set(clip_key_rules(2, 2))
    torch.save(weights, tmp_path / "clip.pt")
    common = RUNNER + ["--loss_name", LOSS, "--clip_weights", str(tmp_path / "clip.pt")]
    run_pretrain_clipvip.main(common + ["--device", "cpu", "--output_dir", str(tmp_path / "port")])
    jax_runner.main(common + ["--output_dir", str(tmp_path / "jax")])
    got, want = _losses(tmp_path / "port"), _losses(tmp_path / "jax")
    assert len(got) == len(want) == 2 and all(np.isfinite(got))
    np.testing.assert_allclose(got, want, rtol=1e-4)


def _parsed(argv):
    parser = run_pretrain_clipvip.build_parser()
    return parse_with_config(parser, argv)


def test_runner_default_loss_is_vsc_fc(tmp_path):
    """Without a config the loss is the documented ``vsc_fc``; a flag or a
    config's ``loss_name`` wins over it."""
    assert _parsed([]).loss_name == LOSS
    assert _parsed(["--loss_name", "NCELearnableTempLoss"]).loss_name == "NCELearnableTempLoss"
    (tmp_path / "cfg.json").write_text(json.dumps({"loss_name": "NCELearnableTempLoss_vsc"}))
    assert _parsed(["--config", str(tmp_path / "cfg.json")]).loss_name == "NCELearnableTempLoss_vsc"
    run_pretrain_clipvip.main(RUNNER[:-6] + ["--num_train_steps", "1", "--device", "cpu",
                                             "--output_dir", str(tmp_path / "run")])
    with open(tmp_path / "run" / "log" / "args.json") as f:
        assert json.load(f)["loss_name"] == LOSS


def test_jax_runner_default_loss_never_takes_effect(tmp_path, monkeypatch):
    """The reference-side fault the port does not copy: the JAX runner's
    ``setdefault`` of ``vsc_fc`` is dead code (the shared parser always
    fills ``loss_name``), so without a config it trains on the pair loss."""
    from xpretrain_tpu.cli import run_pretrain_clipvip as jax_runner

    seen = {}

    class Stop(Exception):
        pass

    def capture(cfg, *args, **kwargs):
        seen["loss_name"] = cfg.loss_name
        raise Stop

    monkeypatch.setattr(jax_runner, "ClipVipTrainer", capture)
    with pytest.raises(Stop):
        jax_runner.main(RUNNER + ["--output_dir", str(tmp_path)])
    assert seen["loss_name"] == "NCELearnableTempLoss"
