"""HD-VILA and LF-VILA serving artifacts of the port: the cases of
``tests/test_serving_families.py`` (export -> save -> load -> call against the
live model, several batch sizes from one export, meta and similarity), the
artifacts against the JAX package's live towers on the same weights
(PARITY.md's bars: LF-VILA 5e-5, HD-VILA 1e-4, fp32 on the CPU), and exports
from cold device-constant caches.

The port's HD-VILA video tower takes uint8 frames and normalizes them once
on the device; JAX's export takes float frames, so JAX is fed the same
values as float (ROADMAP Queue 3: the port's HD-VILA artifact takes uint8)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hdvila_parity import random_params  # noqa: E402
from xpretrain_tpu_torch.cli.run_pretrain_hdvila import HdVilaPretrainModel  # noqa: E402
from xpretrain_tpu_torch.models import common  # noqa: E402
from xpretrain_tpu_torch.models.hd_vila.e2e import HdVilaEncoderConfig  # noqa: E402
from xpretrain_tpu_torch.models.hd_vila.modeling import HdVilaModelConfig  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.convert import load_jax_params  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaConfig  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.tasks import LfVilaRetrieval  # noqa: E402
from xpretrain_tpu_torch.serving import (  # noqa: E402
    export_hdvila_retrieval_towers,
    export_lfvila_retrieval_towers,
    load_artifact,
    save_artifact,
)

HD_ATOL, LF_ATOL = 1e-4, 5e-5


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: beside the other test processes, torch's
    all-cores default oversubscribes the CPU many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _t(*arrays):
    return tuple(torch.from_numpy(np.asarray(a)) for a in arrays)


def _jax_tower(jax_model, params, method, *args):
    import jax

    return np.asarray(jax.jit(lambda p, *a: jax_model.apply({"params": p}, *a, method=method))(params, *args))


# ---------------------------------------------------------------- HD-VILA
HD_CLIPS, HD_LO, HD_HI_SIZE, HD_LO_SIZE, HD_SEQ = 2, 2, (64, 128), (16, 32), 12


def _hd_batch(rng, b):
    mid = rng.integers(0, 255, size=(b, HD_CLIPS, 3, *HD_HI_SIZE)).astype(np.uint8)
    oth = rng.integers(0, 255, size=(b, HD_CLIPS, HD_LO, 3, *HD_LO_SIZE)).astype(np.uint8)
    ids = rng.integers(2, 1000, size=(b, HD_SEQ))
    mask = np.ones((b, HD_SEQ), np.int64)
    return mid, oth, ids, mask


@pytest.fixture(scope="module")
def hdvila_pair():
    """The JAX ``HdVilaPretrainModel`` (tiny, stage 1), seeded params and the
    port's model loaded from them."""
    from xpretrain_tpu.cli.run_pretrain_hdvila import HdVilaPretrainModel as JaxModel
    from xpretrain_tpu.models.hd_vila.e2e import HdVilaEncoderConfig as JaxEnc
    from xpretrain_tpu.models.hd_vila.modeling import HdVilaModelConfig as JaxCfg

    jax_model = JaxModel(JaxEnc.tiny(timesformer_frames=HD_LO + 1, timesformer_hw=(1, 2)), JaxCfg.tiny(stage=1),
                         temp=0.05)
    mid, oth, ids, mask = _hd_batch(np.random.default_rng(0), 1)
    params = random_params(jax_model, mid.astype(np.float32), oth.astype(np.float32), ids, mask)
    port = HdVilaPretrainModel(HdVilaEncoderConfig.tiny(timesformer_frames=HD_LO + 1, timesformer_hw=(1, 2)),
                               HdVilaModelConfig.tiny(stage=1), temp=0.05)
    load_jax_params(port, {"params": params})
    return jax_model, params, port.eval()


@pytest.fixture(scope="module")
def hdvila_artifact_path(hdvila_pair, tmp_path_factory):
    art = export_hdvila_retrieval_towers(hdvila_pair[2], n_clips=HD_CLIPS, n_lo_frames=HD_LO, hi_size=HD_HI_SIZE,
                                         lo_size=HD_LO_SIZE, seq_len=HD_SEQ)
    path = str(tmp_path_factory.mktemp("serving") / "hdvila_tiny.xpsa")
    save_artifact(path, art)
    return path


def test_hdvila_artifact_matches_live_model(hdvila_pair, hdvila_artifact_path):
    _, _, port = hdvila_pair
    art = load_artifact(hdvila_artifact_path)
    mid, oth, ids, mask = _hd_batch(np.random.default_rng(1), 3)
    with torch.no_grad():
        want_v = port.forward_video(*_t(mid, oth))
        want_t = port.forward_text(*_t(ids, mask))
        full = port(*_t(mid, oth, ids, mask))
    got_v, got_t = art.encode_video(mid, oth), art.encode_text(ids, mask)
    np.testing.assert_allclose(got_v.numpy(), want_v.numpy(), atol=1e-6)
    np.testing.assert_allclose(got_t.numpy(), want_t.numpy(), atol=1e-6)
    np.testing.assert_allclose(np.linalg.norm(got_v.numpy(), axis=-1), 1.0, atol=1e-5)
    # the tower features ARE the stage-1 ITC features of the full forward
    np.testing.assert_allclose(full["vis_features"].numpy(), got_v.numpy(), atol=1e-6)
    np.testing.assert_allclose(full["text_features"].numpy(), got_t.numpy(), atol=1e-6)


def test_hdvila_symbolic_batch_and_meta(hdvila_artifact_path):
    art = load_artifact(hdvila_artifact_path)
    assert art.meta["family"] == "hd_vila"
    assert art.meta["temp"] == pytest.approx(0.05)
    assert (art.meta["video_dtype"], art.meta["attention"]) == ("uint8", "plain")
    for b in (1, 2):
        mid, oth, ids, mask = _hd_batch(np.random.default_rng(b), b)
        v = art.encode_video(mid, oth)
        t = art.encode_text(ids, mask)
        assert v.shape[0] == b and t.shape[0] == b
    scores = art.similarity(t, v).numpy()
    scaled = art.similarity(t, v, scaled=True).numpy()
    np.testing.assert_allclose(scaled, scores / art.meta["temp"], rtol=1e-5)


def test_hdvila_artifact_matches_jax_live_towers(hdvila_pair, hdvila_artifact_path):
    """The port's artifact on uint8 frames against JAX's live towers on the
    same values as float (JAX's model applied once), two batch sizes."""
    jax_model, params, _ = hdvila_pair
    art = load_artifact(hdvila_artifact_path)
    for b in (1, 3):
        mid, oth, ids, mask = _hd_batch(np.random.default_rng(10 + b), b)
        want_v = _jax_tower(jax_model, params, type(jax_model).forward_video, mid.astype(np.float32),
                            oth.astype(np.float32))
        want_t = _jax_tower(jax_model, params, type(jax_model).forward_text, ids, mask)
        np.testing.assert_allclose(art.encode_video(mid, oth).numpy(), want_v, atol=HD_ATOL, rtol=0)
        np.testing.assert_allclose(art.encode_text(ids, mask).numpy(), want_t, atol=HD_ATOL, rtol=0)


# ---------------------------------------------------------------- LF-VILA
LF_FRAMES, LF_SIZE, LF_SENT, LF_LEN = 8, (96, 160), 4, 10


def _lf_batch(rng, b):
    video = rng.normal(size=(b, 3, LF_FRAMES, *LF_SIZE)).astype(np.float32)
    ids = rng.integers(2, 1000, size=(b, LF_SENT, LF_LEN))
    mask = np.ones((b, LF_SENT, LF_LEN), np.int64)
    return video, ids, mask


@pytest.fixture(scope="module")
def lfvila_pair():
    """The JAX ``LfVilaRetrieval`` (tiny), its jitted init's params with
    noise on every leaf, and the port's model loaded from them."""
    import jax

    from xpretrain_tpu.models.lf_vila.pretrain import LfVilaConfig as JaxConfig
    from xpretrain_tpu.models.lf_vila.tasks import LfVilaRetrieval as JaxRetrieval

    jax_model = JaxRetrieval(JaxConfig.tiny(sample_clip=4, sample_frame=LF_FRAMES, final_num_patches=1))
    video, ids, mask = _lf_batch(np.random.default_rng(0), 1)
    params = jax.jit(jax_model.init)(jax.random.PRNGKey(0), video, ids, mask)["params"]
    noise = np.random.default_rng(1)
    params = jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * noise.normal(size=np.shape(x)).astype(np.float32), params)
    port = LfVilaRetrieval(LfVilaConfig.tiny(sample_clip=4, sample_frame=LF_FRAMES, final_num_patches=1))
    load_jax_params(port, {"params": params})
    return jax_model, params, port.eval()


@pytest.fixture(scope="module")
def lfvila_artifact_path(lfvila_pair, tmp_path_factory):
    art = export_lfvila_retrieval_towers(lfvila_pair[2], frames=LF_FRAMES, image_size=LF_SIZE, n_sent=LF_SENT,
                                         sent_len=LF_LEN)
    path = str(tmp_path_factory.mktemp("serving") / "lfvila_tiny.xpsa")
    save_artifact(path, art)
    return path


def test_lfvila_artifact_matches_live_model(lfvila_pair, lfvila_artifact_path):
    _, _, port = lfvila_pair
    art = load_artifact(lfvila_artifact_path)
    video, ids, mask = _lf_batch(np.random.default_rng(2), 3)
    with torch.no_grad():
        want_v = port.forward_video(*_t(video))
        want_t = port.forward_text(*_t(ids, mask))
        full = port(*_t(video, ids, mask))
    got_v, got_t = art.encode_video(video), art.encode_text(ids, mask)
    np.testing.assert_allclose(got_v.numpy(), want_v.numpy(), atol=1e-6)
    np.testing.assert_allclose(got_t.numpy(), want_t.numpy(), atol=1e-6)
    # the tower features ARE the dual-encoder features of the full forward
    np.testing.assert_allclose(full["video_global_feat"].numpy(), got_v.numpy(), atol=1e-6)
    np.testing.assert_allclose(full["text_global_feat"].numpy(), got_t.numpy(), atol=1e-6)


def test_lfvila_symbolic_batch_and_meta(lfvila_artifact_path):
    art = load_artifact(lfvila_artifact_path)
    assert art.meta["family"] == "lf_vila"
    for b in (1, 2):
        video, ids, mask = _lf_batch(np.random.default_rng(b), b)
        v = art.encode_video(video)
        t = art.encode_text(ids, mask)
        assert v.shape[0] == b and t.shape[0] == b
    scores = art.similarity(t, v).numpy()
    scaled = art.similarity(t, v, scaled=True).numpy()
    np.testing.assert_allclose(scaled, scores / art.meta["temp"], rtol=1e-5)


def test_lfvila_artifact_matches_jax_live_towers(lfvila_pair, lfvila_artifact_path):
    """The port's artifact against JAX's live towers on the same weights, two
    batch sizes from one export."""
    jax_model, params, _ = lfvila_pair
    art = load_artifact(lfvila_artifact_path)
    for b in (1, 3):
        video, ids, mask = _lf_batch(np.random.default_rng(20 + b), b)
        want_v = _jax_tower(jax_model, params, type(jax_model).forward_video, video)
        want_t = _jax_tower(jax_model, params, type(jax_model).forward_text, ids, mask)
        np.testing.assert_allclose(art.encode_video(video).numpy(), want_v, atol=LF_ATOL, rtol=0)
        np.testing.assert_allclose(art.encode_text(ids, mask).numpy(), want_t, atol=LF_ATOL, rtol=0)


# ------------------------------------------------- cold device-constant caches


@pytest.mark.parametrize("family", ["lf_vila", "hd_vila"])
def test_export_with_cold_caches_leaves_the_live_model_real(family, lfvila_pair, hdvila_pair):
    """LF-VILA's window masks and bias indices and HD-VILA's normalization
    constants come from ``models/common.py:device_constant``: an export from
    a cold cache leaves the live towers returning real tensors equal to
    their output before it, and the cache holds only real tensors."""
    if family == "lf_vila":
        port = lfvila_pair[2]
        video, ids, mask = _lf_batch(np.random.default_rng(3), 2)
        inputs, text = _t(video), _t(ids, mask)
        export = lambda: export_lfvila_retrieval_towers(  # noqa: E731
            port, frames=LF_FRAMES, image_size=LF_SIZE, n_sent=LF_SENT, sent_len=LF_LEN)
    else:
        port = hdvila_pair[2]
        mid, oth, ids, mask = _hd_batch(np.random.default_rng(3), 2)
        inputs, text = _t(mid, oth), _t(ids, mask)
        export = lambda: export_hdvila_retrieval_towers(  # noqa: E731
            port, n_clips=HD_CLIPS, n_lo_frames=HD_LO, hi_size=HD_HI_SIZE, lo_size=HD_LO_SIZE, seq_len=HD_SEQ)
    with torch.no_grad():
        before = (port.forward_video(*inputs), port.forward_text(*text))
    common._cached_constant.cache_clear()
    art = export()
    assert common._cached_constant.cache_info().currsize == 0
    assert art.video.constants  # the trace's constants went into the program
    with torch.no_grad():
        after = (port.forward_video(*inputs), port.forward_text(*text))
    for b, a in zip(before, after):
        assert type(a) is torch.Tensor
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert common._cached_constant.cache_info().currsize > 0
