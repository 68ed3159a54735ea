"""Port parity: uint8 ingest math (``xpretrain_tpu_torch/ops/patchify.py``)
against ``xpretrain_tpu/ops/patchify.py``, same seeded inputs, fp32 on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from xpretrain_tpu.data.transforms import CLIP_MEAN, CLIP_STD, normalize  # noqa: E402
from xpretrain_tpu.ops import patchify as jax_patchify  # noqa: E402
from xpretrain_tpu_torch.ops import patchify  # noqa: E402

P, D = 8, 24


@pytest.fixture()
def inputs():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(3, 16, 24, 3), dtype=np.uint8)
    kernel = rng.normal(size=(P, P, 3, D)).astype(np.float32) * 0.05
    return frames, kernel


def test_fold_normalization_matches(inputs):
    _, kernel = inputs
    want_w, want_b = jax_patchify.fold_normalization(jnp.asarray(kernel), CLIP_MEAN, CLIP_STD)
    got_w, got_b = patchify.fold_normalization(torch.from_numpy(kernel), CLIP_MEAN, CLIP_STD)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=0, atol=1e-6)


def test_extract_patches_u8_matches(inputs):
    frames, _ = inputs
    want = jax_patchify.extract_patches_u8(jnp.asarray(frames), P)
    got = patchify.extract_patches_u8(torch.from_numpy(frames), P)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas_interpret"])
def test_u8_patch_embed_matches(inputs, use_pallas):
    frames, kernel = inputs
    want = jax_patchify.fused_patch_embed(
        jnp.asarray(frames), jnp.asarray(kernel), CLIP_MEAN, CLIP_STD,
        use_pallas=use_pallas, interpret=use_pallas,
    )
    got = patchify.patch_embed_u8(torch.from_numpy(frames), torch.from_numpy(kernel), CLIP_MEAN, CLIP_STD)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)


def test_folded_gemm_equals_normalize_then_project(inputs):
    """The fold is exact algebra: same answer as normalizing first."""
    frames, kernel = inputs
    norm = normalize(frames).transpose(0, 2, 3, 1)  # [N, H, W, 3] fp32
    patches = patchify.extract_patches_u8(torch.from_numpy(np.ascontiguousarray(norm)), P)
    want = patches @ torch.from_numpy(kernel).reshape(P * P * 3, D)
    got = patchify.patch_embed_u8(torch.from_numpy(frames), torch.from_numpy(kernel), CLIP_MEAN, CLIP_STD)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=2e-5, rtol=0)
