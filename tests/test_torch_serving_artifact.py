"""Serving artifacts of the port (``xpretrain_tpu_torch/serving/artifact.py``):
export -> save -> load -> call, the cases of ``tests/test_serving_artifact.py``
on the port's CLIP-ViP, and the artifact against the JAX package's live
towers on the same weights.

The artifact reproduces the live model's features exactly on the device it
was exported for, serves several batch sizes from one export (a symbolic
batch dimension), and round-trips through the ``.xpsa`` zip with no model
code on the load path. fp32 on the CPU; the JAX bar is PARITY.md's CLIP-ViP
one, 2e-5 on the L2-normalized features."""

import json
import zipfile

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD  # noqa: E402
from xpretrain_tpu_torch.models import common  # noqa: E402
from xpretrain_tpu_torch.models.clip_vip.convert import load_jax_params  # noqa: E402
from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel  # noqa: E402
from xpretrain_tpu_torch.ops import patchify  # noqa: E402
from xpretrain_tpu_torch.serving import (  # noqa: E402
    RetrievalArtifact,
    export_retrieval_towers,
    load_artifact,
    save_artifact,
)

FRAMES, IMAGE, SEQ = 4, 32, 16
JAX_ATOL = 2e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: beside the other test processes, torch's
    all-cores default oversubscribes the CPU many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def tiny_model():
    model = CLIPViPModel(CLIPVipConfig.tiny_debug(image_size=IMAGE))
    return model.init_weights(torch.Generator().manual_seed(0)).eval()


def _batch(rng, b):
    video = rng.integers(0, 255, size=(b, FRAMES, IMAGE, IMAGE, 3)).astype(np.uint8)
    ids = np.zeros((b, SEQ), np.int64)
    ids[:, 0] = 49406
    ids[:, 1:6] = rng.integers(10, 400, size=(b, 5))
    ids[:, 6] = 49407
    mask = (ids > 0).astype(np.int64)
    return video, ids, mask


def _live(model, video, ids=None, mask=None):
    with torch.no_grad():
        v = model.forward_video(torch.from_numpy(video))
        t = None if ids is None else model.forward_text(torch.from_numpy(ids), torch.from_numpy(mask))
    return v, t


@pytest.fixture(scope="module")
def artifact_path(tiny_model, tmp_path_factory):
    art = export_retrieval_towers(tiny_model, frames=FRAMES, image_size=IMAGE, seq_len=SEQ)
    path = str(tmp_path_factory.mktemp("serving") / "clipvip_tiny.xpsa")
    save_artifact(path, art)
    return path


def test_artifact_matches_live_model(tiny_model, artifact_path, rng):
    """The loaded towers reproduce the live model's (same device)."""
    art = load_artifact(artifact_path)
    video, ids, mask = _batch(rng, 3)
    want_v, want_t = _live(tiny_model, video, ids, mask)
    got_v, got_t = art.encode_video(video), art.encode_text(ids, mask)
    np.testing.assert_allclose(got_v.numpy(), want_v.numpy(), atol=1e-6)
    np.testing.assert_allclose(got_t.numpy(), want_t.numpy(), atol=1e-6)
    # features are L2-normalized: the serving contract for plain-product ranking
    np.testing.assert_allclose(np.linalg.norm(got_v.numpy(), axis=-1), 1.0, atol=1e-5)


def test_symbolic_batch_serves_multiple_sizes(artifact_path, rng):
    """One export serves any batch size (the symbolic batch dimension)."""
    art = load_artifact(artifact_path)
    for b in (1, 2, 5):
        video, ids, mask = _batch(rng, b)
        assert art.encode_video(video).shape == (b, art.meta["projection_dim"])
        assert art.encode_text(ids, mask).shape == (b, art.meta["projection_dim"])


def test_batch_independence(artifact_path, rng):
    """Row i of a batched call equals the single-item call."""
    art = load_artifact(artifact_path)
    video, _, _ = _batch(rng, 4)
    full = art.encode_video(video).numpy()
    one = art.encode_video(video[2:3]).numpy()
    np.testing.assert_allclose(full[2:3], one, atol=1e-6)


def test_meta_and_similarity(tiny_model, artifact_path, rng):
    art = load_artifact(artifact_path)
    meta = art.meta
    assert meta["family"] == "clip_vip"
    assert (meta["frames"], meta["image_size"], meta["seq_len"]) == (FRAMES, IMAGE, SEQ)
    assert meta["video_dtype"] == "uint8"
    assert (meta["device"], meta["attention"]) == ("cpu", "plain")
    np.testing.assert_allclose(meta["logit_scale"], float(tiny_model.logit_scale.detach()), rtol=1e-6)
    video, ids, mask = _batch(rng, 3)
    t, v = art.encode_text(ids, mask), art.encode_video(video)
    scores = art.similarity(t, v).numpy()
    assert scores.shape == (3, 3)
    scaled = art.similarity(t, v, scaled=True).numpy()
    np.testing.assert_allclose(scaled, scores * np.exp(meta["logit_scale"]), rtol=1e-5)


def test_zip_layout_and_bad_file_error(artifact_path, tmp_path):
    with zipfile.ZipFile(artifact_path) as zf:
        assert {"video.pt2", "text.pt2", "meta.json"} <= set(zf.namelist())
        assert json.loads(zf.read("meta.json"))["format_version"] == 1
    bogus = tmp_path / "bogus.xpsa"
    with zipfile.ZipFile(bogus, "w") as zf:
        zf.writestr("meta.json", "{}")
    with pytest.raises(ValueError, match="not a serving artifact"):
        load_artifact(str(bogus))


def _rewrite_meta(src: str, dst, **changes) -> str:
    with zipfile.ZipFile(src) as zin, zipfile.ZipFile(dst, "w") as zout:
        for name in zin.namelist():
            data = zin.read(name)
            if name == "meta.json":
                data = json.dumps({**json.loads(data), **changes}).encode()
            zout.writestr(name, data)
    return str(dst)


def test_future_format_version_rejected(artifact_path, tmp_path):
    with pytest.raises(ValueError, match="newer than"):
        load_artifact(_rewrite_meta(artifact_path, tmp_path / "newer.xpsa", format_version=99))


def test_cli_exporter_writes_loadable_artifact(tmp_path, rng):
    """``python -m xpretrain_tpu_torch.cli.export_serving_clipvip`` end to end
    (tiny, on the CPU)."""
    from xpretrain_tpu_torch.cli.export_serving_clipvip import main

    out = str(tmp_path / "tiny.xpsa")
    meta = main([
        "--clip_size", "tiny", "--crop_img_size", str(IMAGE),
        "--num_frm", str(FRAMES), "--max_txt_len", str(SEQ),
        "--bf16", "0", "--device", "cpu", "--output", out, "--output_dir", str(tmp_path / "out"),
    ])
    assert meta["projection_dim"] > 0 and meta["attention"] == "plain"
    art = load_artifact(out)
    video, ids, mask = _batch(rng, 2)
    assert art.encode_video(video).shape == (2, meta["projection_dim"])
    assert art.encode_text(ids, mask).shape == (2, meta["projection_dim"])


def test_fp32_channel_first_export(tiny_model, rng):
    """The fp path exports the torch-layout [B,T,C,H,W] input convention."""
    art = export_retrieval_towers(tiny_model, frames=FRAMES, image_size=IMAGE, seq_len=SEQ,
                                  video_dtype=torch.float32)
    assert isinstance(art, RetrievalArtifact) and art.meta["video_dtype"] == "float32"
    video = rng.normal(size=(2, FRAMES, 3, IMAGE, IMAGE)).astype(np.float32)
    want, _ = _live(tiny_model, video)
    np.testing.assert_allclose(art.encode_video(video).numpy(), want.numpy(), atol=1e-6)


# -- the port's additions ------------------------------------------------------


@pytest.fixture(scope="module")
def jax_pair():
    """A JAX ``CLIPViPModel`` with noisy params (every leaf, the temporal
    embedding included) and the port's model loaded from them."""
    import jax
    import jax.numpy as jnp

    from xpretrain_tpu.models.clip_vip import CLIPVipConfig as JaxConfig
    from xpretrain_tpu.models.clip_vip import CLIPViPModel as JaxModel

    jax_model = JaxModel(JaxConfig.tiny_debug(image_size=IMAGE))
    video = jnp.zeros((1, FRAMES, IMAGE, IMAGE, 3), jnp.uint8)
    ids = jnp.zeros((1, SEQ), jnp.int32).at[:, 3].set(49407)
    params = jax_model.init(jax.random.PRNGKey(0), video, ids, ids > 0)["params"]
    noise = np.random.default_rng(7)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * noise.normal(size=np.shape(x)).astype(np.float32), params)
    port = CLIPViPModel(CLIPVipConfig.tiny_debug(image_size=IMAGE))
    load_jax_params(port, {"params": params})
    return jax_model, params, port.eval()


def test_artifact_matches_jax_live_towers(jax_pair, tmp_path):
    """The port's saved and loaded artifact against JAX's live towers on the
    same weights, at two batch sizes from one export."""
    import jax

    jax_model, params, port = jax_pair
    path = str(tmp_path / "parity.xpsa")
    save_artifact(path, export_retrieval_towers(port, frames=FRAMES, image_size=IMAGE, seq_len=SEQ))
    art = load_artifact(path)
    tower = jax.jit(lambda p, method, *a: jax_model.apply({"params": p}, *a, method=method), static_argnums=1)
    for b, seed in ((2, 11), (5, 12)):
        video, ids, mask = _batch(np.random.default_rng(seed), b)
        want_v = tower(params, type(jax_model).forward_video, video)
        want_t = tower(params, type(jax_model).forward_text, ids.astype(np.int32), mask.astype(np.int32))
        np.testing.assert_allclose(art.encode_video(video).numpy(), np.asarray(want_v), atol=JAX_ATOL, rtol=0)
        np.testing.assert_allclose(art.encode_text(ids, mask).numpy(), np.asarray(want_t), atol=JAX_ATOL, rtol=0)


def test_jax_artifact_is_not_a_port_artifact(tmp_path):
    """The JAX package's ``.xpsa`` holds StableHLO members: the port's loader
    rejects it with the missing-member error (ROADMAP Queue 3)."""
    import jax
    import jax.numpy as jnp

    from xpretrain_tpu.models.clip_vip import CLIPVipConfig as JaxConfig
    from xpretrain_tpu.models.clip_vip import CLIPViPModel as JaxModel
    from xpretrain_tpu.serving import export_retrieval_towers as jax_export
    from xpretrain_tpu.serving import save_artifact as jax_save

    jax_model = JaxModel(JaxConfig.tiny_debug(image_size=IMAGE))
    video = jnp.zeros((1, FRAMES, IMAGE, IMAGE, 3), jnp.uint8)
    ids = jnp.zeros((1, SEQ), jnp.int32).at[:, 3].set(49407)
    variables = jax_model.init(jax.random.PRNGKey(0), video, ids, ids > 0)
    path = str(tmp_path / "jax.xpsa")
    jax_save(path, jax_export(jax_model, variables, frames=FRAMES, image_size=IMAGE, seq_len=SEQ))
    with zipfile.ZipFile(path) as zf:
        assert {"video.jaxexp", "text.jaxexp", "meta.json"} <= set(zf.namelist())
    with pytest.raises(ValueError, match=r"not a serving artifact \(missing \['text.pt2', 'video.pt2'\]\)"):
        load_artifact(path)


def _clear_constant_caches():
    common._cached_constant.cache_clear()
    patchify._on_device.cache_clear()


def test_export_with_cold_caches_leaves_the_live_model_real(tiny_model, rng):
    """The device-constant caches (``models/common.py:device_constant``,
    ``ops/patchify.py:_on_device``) keep nothing a trace makes: after an
    export from cold caches the live model still returns real tensors,
    equal to its output before the export, and the caches hold real ones."""
    video, ids, mask = _batch(rng, 3)
    before_v, before_t = _live(tiny_model, video, ids, mask)
    _clear_constant_caches()
    export_retrieval_towers(tiny_model, frames=FRAMES, image_size=IMAGE, seq_len=SEQ)
    assert patchify._on_device.cache_info().currsize == 0
    after_v, after_t = _live(tiny_model, video, ids, mask)
    for before, after in ((before_v, after_v), (before_t, after_t)):
        assert type(after) is torch.Tensor
        torch.testing.assert_close(after, before, rtol=0, atol=0)
    assert patchify._on_device.cache_info().currsize == 1
    cached = patchify._on_device(patchify._values(CLIP_MEAN), patchify._values(CLIP_STD), torch.device("cpu"))
    assert all(type(t) is torch.Tensor for t in cached)


def test_kernel_attention_needs_a_card_and_a_cuda_artifact_needs_one_to_load(tiny_model, artifact_path, tmp_path):
    """No fallback: ``attention="kernel"`` on a CPU model raises, and an
    artifact exported for ``cuda`` loaded where torch sees no CUDA device
    raises instead of moving it."""
    with pytest.raises(ValueError, match="must be on a CUDA device"):
        export_retrieval_towers(tiny_model, frames=FRAMES, image_size=IMAGE, seq_len=SEQ, attention="kernel")
    if torch.cuda.is_available():
        pytest.skip("this machine has a CUDA device")
    cuda = _rewrite_meta(artifact_path, tmp_path / "cuda.xpsa", device="cuda", attention="kernel")
    with pytest.raises(RuntimeError, match="torch sees no CUDA device"):
        load_artifact(cuda)
