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


def _pair(vision_type="ViP"):
    """A flax model with randomized params (every leaf, so zero-init biases
    and the temporal embedding count too) and the port loaded from them."""
    vip = dict(type=vision_type, temporal_size=TEMPORAL)
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


def test_factorized_mode_is_not_ported():
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CLIPViPModel(CLIPVipConfig.tiny_debug(vip=VipConfig(attention_mode="factorized")))


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
