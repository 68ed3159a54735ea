"""HD-VILA's data path in the port (``xpretrain_tpu_torch/data/
{transforms,sample_frames,datasets_hdvila,datasets_hdvila_tasks}.py``)
against the JAX package's, on the CPU.

The port ships uint8 frames and ``HdVilaEncoder.normalize`` normalizes them
once on the device; the JAX copy normalizes on the host and its encoder
normalizes again (ROADMAP Queue 3). Here:
- the port's uint8 frames, normalized once, equal JAX's host output within
  1e-6 (the two sides compute (x/255 - mean)/std and (x - 255 mean)/(255 std)
  in fp32);
- the samplers, the flip, the ids, masks and labels of both collators are
  bit-equal (host numpy code, copied);
- ``test_jax_hdvila_path_normalizes_twice`` shows the JAX fault.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu.data import datasets_hdvila as jax_ds  # noqa: E402
from xpretrain_tpu.data import datasets_hdvila_tasks as jax_tasks  # noqa: E402
from xpretrain_tpu.data import sample_frames as jax_sample_frames  # noqa: E402
from xpretrain_tpu.data import tokenization as jax_tokenization  # noqa: E402
from xpretrain_tpu.data import transforms as jax_transforms  # noqa: E402
from xpretrain_tpu_torch.data import datasets_hdvila, datasets_hdvila_tasks, sample_frames  # noqa: E402
from xpretrain_tpu_torch.data import tokenization, transforms  # noqa: E402
from xpretrain_tpu_torch.models.hd_vila.e2e import HdVilaEncoder  # noqa: E402

CROP = (64, 96)


def _normalize_once(frames_u8: np.ndarray) -> np.ndarray:
    """The port's one normalization, ``HdVilaEncoder.normalize``, on any
    [..., 3, H, W] uint8 array."""
    x = torch.from_numpy(np.ascontiguousarray(frames_u8))
    shape = x.shape
    return HdVilaEncoder.normalize(x.reshape(-1, *shape[-3:])).reshape(shape).numpy()


@pytest.mark.parametrize("train", [False, True])
@pytest.mark.parametrize("size,crop", [((7, 80, 120), (64, 96)), ((3, 64, 96), (64, 96)), ((5, 70, 90), (48, 64))])
def test_hybrid_res_transform_is_jax_once_normalized(train, size, crop):
    """The same crop, bicubic x4 resize and rng draws as JAX, uint8
    [1, C, H, W] and [T-1, C, H/4, W/4]; normalized once they are JAX's
    output within 1e-6."""
    frames = np.random.default_rng(0).integers(0, 256, size=(*size, 3), dtype=np.uint8)
    rng_port, rng_jax = np.random.default_rng(5), np.random.default_rng(5)
    mid, oth = transforms.hybrid_res_transform(frames, size[0] // 2, crop, train=train, rng=rng_port)
    want_mid, want_oth = jax_transforms.hybrid_res_transform(frames, size[0] // 2, crop, train=train, rng=rng_jax)
    assert mid.dtype == oth.dtype == np.uint8
    assert mid.shape == (1, 3, *crop) and oth.shape == (size[0] - 1, 3, crop[0] // 4, crop[1] // 4)
    np.testing.assert_allclose(_normalize_once(mid), want_mid, atol=1e-6, rtol=0)
    np.testing.assert_allclose(_normalize_once(oth), want_oth, atol=1e-6, rtol=0)
    assert rng_port.random() == rng_jax.random()  # the same draws were taken


def test_flip_and_samplers_match_jax():
    frames = np.random.default_rng(1).integers(0, 256, size=(2, 4, 6, 3), dtype=np.uint8)
    for seed in range(4):
        np.testing.assert_array_equal(
            transforms.random_horizontal_flip(frames, np.random.default_rng(seed)),
            jax_transforms.random_horizontal_flip(frames, np.random.default_rng(seed)))
    for total in (1, 5, 40, 97, 300):
        for test_mode in (False, True):
            got = sample_frames.center_neighbor_sample(total, 7, 12, np.random.default_rng(2), test_mode)
            want = jax_sample_frames.center_neighbor_sample(total, 7, 12, np.random.default_rng(2), test_mode)
            np.testing.assert_array_equal(got[0], want[0])
            assert got[1] == want[1]
            for n_clips in (1, 2, 5):
                got = sample_frames.spread_center_neighbor_sample(total, n_clips, 7, 12, np.random.default_rng(3),
                                                                   test_mode)
                want = jax_sample_frames.spread_center_neighbor_sample(total, n_clips, 7, 12,
                                                                       np.random.default_rng(3), test_mode)
                assert len(got) == len(want) == n_clips
                for g, w in zip(got, want):
                    np.testing.assert_array_equal(g, w)


def _assert_batch(got: dict, want: dict) -> None:
    assert set(got) == set(want)
    for key in got:
        if key.startswith("img_"):
            assert got[key].dtype == np.uint8 and want[key].dtype == np.float32
            np.testing.assert_allclose(_normalize_once(got[key]), want[key], atol=1e-6, rtol=0, err_msg=key)
        else:
            assert got[key].dtype == want[key].dtype, key
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)


@pytest.mark.parametrize("mlm,itm", [(False, False), (True, True), (True, False)])
def test_pretrain_dataset_and_collator_match_jax(mlm, itm):
    """``HdVilaPretrainDataset`` (synthetic, train crops) and
    ``HdVilaPretrainCollator``: ITM negative swaps, MLM masks and labels,
    ids and masks bit-equal; frames uint8 (JAX: fp32, normalized)."""
    def build(ds_mod, tok_mod):
        ds = ds_mod.HdVilaPretrainDataset(None, None, train_n_clips=2, num_frm=3, crop_hw=CROP, seed=4,
                                          synthetic_size=8)
        collate = ds_mod.HdVilaPretrainCollator(tok_mod.HashTokenizer(1000), max_txt_len=12, mlm=mlm, itm=itm,
                                                seed=6)
        return [collate([ds[i] for i in idx]) for idx in ((0, 1, 2, 3), (4, 5, 6, 7))]

    for got, want in zip(build(datasets_hdvila, tokenization), build(jax_ds, jax_tokenization)):
        _assert_batch(got, want)
        assert got["img_middle"].shape == (4, 2, 3, *CROP) and got["img_other"].shape == (4, 2, 2, 3, 16, 24)


@pytest.mark.parametrize("task_type", ["mc", "open", "count"])
def test_task_datasets_and_qa_collator_match_jax(task_type):
    """``HdVilaClipLoader`` (synthetic, spread clips), the retrieval and QA
    datasets and ``HdVilaQACollator`` (multiple choice: [B, n_choice, L])."""
    rows = [{"clip_id": f"c{i}", "question": f"question {i}", "question_id": i, "text": f"caption {i}",
             "options": ["a", "b", "c"], "label": i % 3, "answer": 1 + i % 10 if task_type == "count" else "x"}
            for i in range(4)]

    def build(tasks_mod, ds_mod, tok_mod):
        loader = tasks_mod.HdVilaClipLoader(None, n_clips=2, num_frm=3, crop_hw=CROP, synthetic_seed=7)
        qa = tasks_mod.HdVilaQADataset(None, loader, task_type, rows=rows, train=True, seed=1)
        qa_collate = tasks_mod.HdVilaQACollator(tok_mod.HashTokenizer(1000), max_txt_len=8,
                                                multiple_choice=task_type == "mc")
        retrieval = tasks_mod.HdVilaRetrievalDataset(None, loader, rows=rows, train=False)
        ret_collate = ds_mod.HdVilaPretrainCollator(tok_mod.HashTokenizer(1000), max_txt_len=8, mlm=False, itm=False)
        return [qa_collate([qa[i] for i in range(4)]), ret_collate([retrieval[i] for i in range(4)])]

    got = build(datasets_hdvila_tasks, datasets_hdvila, tokenization)
    want = build(jax_tasks, jax_ds, jax_tokenization)
    for g, w in zip(got, want):
        _assert_batch(g, w)
    if task_type == "mc":
        assert got[0]["text_input_ids"].shape == (4, 3, 8)


def test_jax_hdvila_path_normalizes_twice():
    """The JAX data path's fault (ROADMAP Queue 3): ``hybrid_res_transform``
    ImageNet-normalizes on the host, the collator ships that as fp32, and
    ``HdVilaEncoder.normalize`` subtracts the 0-255 mean and divides by the
    0-255 std again: the ResNets see near-constant frames (std < 0.2). The
    port's uint8 frames through its one normalize have unit-scale spread."""
    import jax.numpy as jnp

    from xpretrain_tpu.models.hd_vila.e2e import HdVilaEncoder as JaxEncoder
    from xpretrain_tpu.models.hd_vila.e2e import HdVilaEncoderConfig as JaxConfig

    def batch(ds_mod, tok_mod):
        ds = ds_mod.HdVilaPretrainDataset(None, None, train_n_clips=1, num_frm=3, crop_hw=(128, 256), seed=0,
                                          synthetic_size=2)
        collate = ds_mod.HdVilaPretrainCollator(tok_mod.HashTokenizer(1000), mlm=False, itm=False)
        return collate([ds[0], ds[1]])["img_middle"]

    jax_frames = batch(jax_ds, jax_tokenization)
    encoder = JaxEncoder(JaxConfig.tiny())
    twice = np.asarray(encoder.apply({}, jnp.asarray(jax_frames.reshape(-1, 3, 128, 256)), method=encoder.normalize))
    once = _normalize_once(batch(datasets_hdvila, tokenization))
    assert twice.std() < 0.2 and twice.max() - twice.min() < 0.5
    assert once.std() > 0.5 and once.max() - once.min() > 4.0
    # the JAX frames are the port's, once normalized: the second pass is the fault
    np.testing.assert_allclose(jax_frames.reshape(-1, 3, 128, 256), once.reshape(-1, 3, 128, 256), atol=1e-6)
