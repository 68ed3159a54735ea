"""Port parity, the whole CLIP-ViP slice: the JAX ``CLIPViPModel`` (flax)
against ``xpretrain_tpu_torch.models.clip_vip`` loaded from the same params
through ``load_jax_params``. fp32 on the CPU; the bar is the CLIP-ViP one in
PARITY.md, 2e-5 on the L2-normalized features."""

import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xpretrain_tpu.config import ConfigDict  # noqa: E402
from xpretrain_tpu.data.transforms import normalize  # noqa: E402
from xpretrain_tpu.models.clip_vip import CLIPVipConfig as JaxConfig  # noqa: E402
from xpretrain_tpu.models.clip_vip import CLIPViPModel as JaxModel  # noqa: E402
from xpretrain_tpu.models.clip_vip import VipConfig as JaxVip  # noqa: E402
from xpretrain_tpu.models.clip_vip.convert import flax_to_torch_clip  # noqa: E402
from xpretrain_tpu.train.trainer import clip_vip_config_from as jax_config_from  # noqa: E402
from xpretrain_tpu_torch.models.clip_vip.convert import load_jax_params  # noqa: E402
from xpretrain_tpu_torch.models.clip_vip.model import (  # noqa: E402
    CLIPVipConfig,
    CLIPViPModel,
    VipConfig,
)
from xpretrain_tpu_torch.serving.towers import RetrievalTowers  # noqa: E402
from xpretrain_tpu_torch.train.trainer import clip_vip_config_from  # noqa: E402

IMAGE, SEQ, TEMPORAL = 32, 16, 6
ATOL = 2e-5


def _tokens(rng, b):
    ids = np.zeros((b, SEQ), np.int64)
    ids[:, 0] = 49406
    lengths = rng.integers(3, SEQ - 1, size=b)
    for i, n in enumerate(lengths):
        ids[i, 1:n] = rng.integers(10, 400, size=n - 1)
        ids[i, n] = 49407  # EOT: the highest id, where argmax pools
    return ids, (ids > 0).astype(np.int64)


def _pair(vision_type="ViP", attention_mode="masked_full"):
    """A flax model with randomized params (every leaf, so zero-init biases
    and the temporal embedding count too) and the port loaded from them."""
    vip = dict(type=vision_type, temporal_size=TEMPORAL, attention_mode=attention_mode)
    jax_model = JaxModel(JaxConfig.tiny_debug(image_size=IMAGE, vip=JaxVip(**vip)))
    video = jnp.zeros((1, TEMPORAL, IMAGE, IMAGE, 3), jnp.uint8)
    ids = jnp.zeros((1, SEQ), jnp.int32).at[:, 3].set(49407)
    params = jax_model.init(jax.random.PRNGKey(0), video, ids, ids > 0)["params"]
    rng = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * rng.normal(size=np.shape(x)).astype(np.float32), params
    )
    model = CLIPViPModel(CLIPVipConfig.tiny_debug(image_size=IMAGE, vip=VipConfig(**vip)))
    load_jax_params(model, {"params": params})
    return jax_model, params, model.eval()


@pytest.fixture(scope="module")
def vip_pair():
    return _pair()


def _compare(pair, video, b, seed):
    jax_model, params, model = pair
    ids, mask = _tokens(np.random.default_rng(seed), b)
    want = jax_model.apply({"params": params}, jnp.asarray(video), jnp.asarray(ids), jnp.asarray(mask))
    with torch.inference_mode():
        got = model(torch.from_numpy(video), torch.from_numpy(ids), torch.from_numpy(mask))
    for key in ("vis_features", "text_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=ATOL, rtol=0, err_msg=key)
    assert got["logit_scale"].item() == pytest.approx(float(want["logit_scale"]))


@pytest.mark.parametrize("frames", [TEMPORAL, 4], ids=["T=temporal", "T!=temporal"])
def test_u8_video_features_match(vip_pair, frames):
    rng = np.random.default_rng(frames)
    video = rng.integers(0, 256, size=(2, frames, IMAGE, IMAGE, 3), dtype=np.uint8)
    _compare(vip_pair, video, 2, seed=frames)


def test_fp32_video_features_match(vip_pair):
    rng = np.random.default_rng(3)
    u8 = rng.integers(0, 256, size=(2, TEMPORAL, IMAGE, IMAGE, 3), dtype=np.uint8)
    video = np.stack([normalize(clip) for clip in u8])  # [B, T, C, H, W]
    _compare(vip_pair, video, 2, seed=3)


def test_frame_mean_baseline_matches():
    rng = np.random.default_rng(4)
    video = rng.integers(0, 256, size=(2, 3, IMAGE, IMAGE, 3), dtype=np.uint8)
    _compare(_pair("mean"), video, 2, seed=4)


def test_key_table_matches_flax_to_torch_clip(vip_pair):
    _, params, model = vip_pair
    exported = flax_to_torch_clip({"params": params})
    state = model.state_dict()
    assert set(state) == set(exported)
    for key, want in exported.items():
        got = state[key].numpy()
        if key == "vision_model.embeddings.patch_embedding.weight":
            got = got.transpose(3, 2, 0, 1)  # port [P,P,3,D] -> HF conv [D,3,P,P]
        np.testing.assert_array_equal(got, want, err_msg=key)


def test_load_rejects_missing_and_unexpected_keys(vip_pair):
    _, params, _ = vip_pair
    model = CLIPViPModel(CLIPVipConfig.tiny_debug(image_size=IMAGE, vip=VipConfig(temporal_size=TEMPORAL)))
    missing = {k: v for k, v in params.items() if k != "logit_scale"}
    with pytest.raises(KeyError, match="missing"):
        load_jax_params(model, {"params": missing})
    extra = dict(params, stray={"kernel": np.zeros(2, np.float32)})
    with pytest.raises(KeyError, match="stray"):
        load_jax_params(model, {"params": extra})


@pytest.fixture(scope="module")
def factorized_pair():
    return _pair(attention_mode="factorized")


def test_factorized_mode_matches_jax(factorized_pair):
    """``attention_mode="factorized"``: JAX's ``_factorized`` (two
    ``dot_attention`` calls) against the port's, same params, dropout 0."""
    rng = np.random.default_rng(8)
    video = rng.integers(0, 256, size=(2, TEMPORAL, IMAGE, IMAGE, 3), dtype=np.uint8)
    _compare(factorized_pair, video, 2, seed=8)


def test_factorized_mode_matches_masked_full(vip_pair, factorized_pair):
    """The two modes compute one function: the factorized model's features
    against the masked_full model's (the proxy kernel's plain path on the
    CPU), loaded from the same params."""
    _, params, factorized = factorized_pair
    _, params_full, full = vip_pair
    for key, value in params.items():  # one draw of the same init: the same params
        jax.tree_util.tree_map(np.testing.assert_array_equal, value, params_full[key])
    rng = np.random.default_rng(9)
    video = torch.from_numpy(rng.integers(0, 256, size=(3, TEMPORAL, IMAGE, IMAGE, 3), dtype=np.uint8))
    ids, mask = (torch.from_numpy(t) for t in _tokens(rng, 3))
    with torch.inference_mode():
        got, want = factorized(video, ids, mask), full(video, ids, mask)
    torch.testing.assert_close(got["vis_features"], want["vis_features"], atol=ATOL, rtol=0)


def test_factorized_attention_equals_the_masked_full_attention():
    """``factorized_proxy_attention`` against ``proxy_attention_plain`` on
    random [B, H, M+N*L, D] inputs (M=4, N=3, L=5), and its dropout: drawn in
    training from the generator (the same seed, the same output), so that it
    differs from the deterministic call, with gradients to q, k and v."""
    from xpretrain_tpu_torch.models.clip_vip.model import factorized_proxy_attention
    from xpretrain_tpu_torch.ops.proxy_attention import proxy_attention_plain

    M, N, L, D = 4, 3, 5, 8
    g = torch.Generator().manual_seed(0)
    q, k, v = (torch.randn(2, 3, M + N * L, D, generator=g) for _ in range(3))
    got = factorized_proxy_attention(q, k, v, M, N, L, D**-0.5)
    torch.testing.assert_close(got, proxy_attention_plain(q, k, v, M, L, D**-0.5), atol=ATOL, rtol=0)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    drop = lambda seed: factorized_proxy_attention(*leaves, M, N, L, D**-0.5, 0.3,  # noqa: E731
                                                   torch.Generator().manual_seed(seed))
    first = drop(5)
    assert torch.equal(first, drop(5)) and not torch.allclose(first, got)
    first.sum().backward()
    assert all(t.grad is not None and torch.isfinite(t.grad).all() for t in leaves)


def _train_grads(remat: bool, rate: float, attention_mode: str) -> dict:
    """The gradients of a seeded tiny model (attention dropout ``rate`` in
    both towers) for one batch, from one dropout seed."""
    cfg = CLIPVipConfig.tiny_debug(image_size=IMAGE, remat=remat,
                                   vip=VipConfig(temporal_size=TEMPORAL, attention_mode=attention_mode))
    cfg = dataclasses.replace(cfg, vision=dataclasses.replace(cfg.vision, attention_dropout=rate),
                              text=dataclasses.replace(cfg.text, attention_dropout=rate))
    model = CLIPViPModel(cfg)
    model.init_weights(torch.Generator().manual_seed(0)).train()
    rng = np.random.default_rng(3)
    video = torch.from_numpy(rng.integers(0, 256, size=(2, TEMPORAL, IMAGE, IMAGE, 3), dtype=np.uint8))
    ids, mask = (torch.from_numpy(t) for t in _tokens(rng, 2))
    out = model(video, ids, mask, generator=torch.Generator().manual_seed(1))
    (out["vis_features"] @ out["text_features"].T).sum().backward()
    return {name: p.grad for name, p in model.named_parameters() if p.grad is not None}


@pytest.mark.parametrize("attention_mode", ["masked_full", "factorized"])
def test_remat_recomputes_with_the_forwards_dropout_masks(attention_mode):
    """``remat`` under attention dropout: the backward's recompute takes the
    forward's keep masks (``common.recomputed``), so the gradients are those
    without remat, bit for bit; the masks were drawn (the gradients differ
    from those at rate 0)."""
    want = _train_grads(False, 0.2, attention_mode)
    got = _train_grads(True, 0.2, attention_mode)
    assert set(got) == set(want)
    for name, grad in want.items():
        assert torch.equal(got[name], grad), name
    plain = _train_grads(False, 0.0, attention_mode)
    assert any(not torch.equal(plain[name], grad) for name, grad in want.items())


def test_towers_match_model(vip_pair):
    _, _, model = vip_pair
    rng = np.random.default_rng(5)
    video = rng.integers(0, 256, size=(3, TEMPORAL, IMAGE, IMAGE, 3), dtype=np.uint8)
    ids, mask = _tokens(rng, 3)
    towers = RetrievalTowers(model, "cpu")
    v, t = towers.encode_video(video), towers.encode_text(ids, mask)
    with torch.inference_mode():
        out = model(torch.from_numpy(video), torch.from_numpy(ids), torch.from_numpy(mask))
    torch.testing.assert_close(v, out["vis_features"], rtol=0, atol=0)
    torch.testing.assert_close(t, out["text_features"], rtol=0, atol=0)
    sims = towers.similarity(t, v, scaled=True)
    torch.testing.assert_close(sims, (t @ v.T) * model.logit_scale.exp(), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("size", ["base_32", "base_16", "large_14", "tiny"])
@pytest.mark.parametrize("bf16", [True, False])
def test_config_from_matches_jax(size, bf16):
    cfg = ConfigDict(clip_size=size, bf16=bf16, crop_img_size=64,
                     clip_vision_additional_config={"add_cls_num": 2, "temporal_size": 8})
    got, want = clip_vip_config_from(cfg), jax_config_from(cfg)
    for name in ("text", "vision", "vip"):
        assert dataclasses.asdict(getattr(got, name)) == dataclasses.asdict(getattr(want, name))
    assert got.projection_dim == want.projection_dim
    assert str(got.dtype).split(".")[-1] == jnp.dtype(want.dtype).name
