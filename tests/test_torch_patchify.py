"""Port parity: uint8 ingest math (``xpretrain_tpu_torch/ops/patchify.py``)
against ``xpretrain_tpu/ops/patchify.py``, same seeded inputs, fp32 on the CPU,
and the fused patch-embed kernel against its plain version on the card.

The JAX reference is imported inside a fixture, so that on a machine without
JAX the CUDA-gated cases below still collect and run:
``python -m pytest tests/test_torch_patchify.py -m cuda --noconftest``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _xpt_ops import xpt_ops_on_cpu  # noqa: E402

from xpretrain_tpu_torch.data.transforms import CLIP_MEAN, CLIP_STD, normalize  # noqa: E402
from xpretrain_tpu_torch.ops import patchify  # noqa: E402

P, D = 8, 24


@pytest.fixture(autouse=True)
def _ops_take_cpu_tensors():
    """The CUDA branch's wiring runs here on CPU tensors, its launch replaced
    by the plain version: the ``xpt::`` ops take the CPU for each test."""
    with xpt_ops_on_cpu():
        yield


@pytest.fixture(scope="module")
def jax_patchify():
    return pytest.importorskip("xpretrain_tpu.ops.patchify")


@pytest.fixture()
def inputs():
    rng = np.random.default_rng(0)
    frames = rng.integers(0, 256, size=(3, 16, 24, 3), dtype=np.uint8)
    kernel = rng.normal(size=(P, P, 3, D)).astype(np.float32) * 0.05
    return frames, kernel


def test_fold_normalization_matches(inputs, jax_patchify):
    import jax.numpy as jnp

    _, kernel = inputs
    want_w, want_b = jax_patchify.fold_normalization(jnp.asarray(kernel), CLIP_MEAN, CLIP_STD)
    got_w, got_b = patchify.fold_normalization(torch.from_numpy(kernel), CLIP_MEAN, CLIP_STD)
    np.testing.assert_allclose(got_w.numpy(), np.asarray(want_w), rtol=1e-6, atol=0)
    np.testing.assert_allclose(got_b.numpy(), np.asarray(want_b), rtol=0, atol=1e-6)


def test_extract_patches_u8_matches(inputs, jax_patchify):
    import jax.numpy as jnp

    frames, _ = inputs
    want = jax_patchify.extract_patches_u8(jnp.asarray(frames), P)
    got = patchify.extract_patches_u8(torch.from_numpy(frames), P)
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas_interpret"])
def test_u8_patch_embed_matches(inputs, use_pallas, jax_patchify):
    import jax.numpy as jnp

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


# -- fused_patch_embed: the public entry and its kernel ----------------------


@pytest.mark.parametrize("out_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("use_pallas", [False, True], ids=["xla", "pallas_interpret"])
@pytest.mark.parametrize("use_kernel", [None, True], ids=["plain", "kernel_entry_on_cpu"])
def test_fused_patch_embed_matches_jax(inputs, jax_patchify, use_pallas, use_kernel, out_dtype):
    """The port's entry on the CPU (the plain GEMM, whatever ``use_kernel``)
    against JAX's ``fused_patch_embed`` through the XLA GEMM and through the
    Pallas kernel in interpret mode: within 1e-4 (``tests/test_patchify.py``);
    a bf16 output also within one bf16 rounding of the values."""
    import jax.numpy as jnp

    frames, kernel = inputs
    want = jax_patchify.fused_patch_embed(
        jnp.asarray(frames), jnp.asarray(kernel), CLIP_MEAN, CLIP_STD,
        out_dtype=getattr(jnp, out_dtype), use_pallas=use_pallas, interpret=use_pallas,
    )
    got = patchify.fused_patch_embed(
        torch.from_numpy(frames), torch.from_numpy(kernel), CLIP_MEAN, CLIP_STD,
        out_dtype=getattr(torch, out_dtype), use_kernel=use_kernel,
    )
    assert got.dtype == getattr(torch, out_dtype) and tuple(got.shape) == (3, 6, D)
    want = np.asarray(want.astype(jnp.float32))
    rtol = 0 if out_dtype == "float32" else 2.0**-8
    np.testing.assert_allclose(got.float().numpy(), want, atol=1e-4, rtol=rtol)


def test_fused_patch_embed_rejects_what_jax_cannot_reshape(inputs):
    frames, kernel = inputs
    f, k = torch.from_numpy(frames), torch.from_numpy(kernel)
    for bad in (f[:, :-1], f[:, :, :-3]):  # H or W not a multiple of P
        with pytest.raises(ValueError, match="multiple of the patch size"):
            patchify.fused_patch_embed(bad, k, CLIP_MEAN, CLIP_STD, use_kernel=True)
    with pytest.raises(ValueError, match="uint8"):
        patchify.fused_patch_embed(f.float(), k, CLIP_MEAN, CLIP_STD)
    with pytest.raises(ValueError, match=r"\[P, P, 3, D\]"):
        patchify.fused_patch_embed(f, k[:, :4], CLIP_MEAN, CLIP_STD)


def test_fused_patch_embed_cpu_launches_no_kernel(inputs):
    frames, kernel = inputs
    before = patchify.fused_patch_embed.launches
    patchify.fused_patch_embed(torch.from_numpy(frames), torch.from_numpy(kernel), CLIP_MEAN, CLIP_STD, use_kernel=True)
    assert patchify.fused_patch_embed.launches == before == 0


def _fold(kernel):
    return patchify.fold_normalization(torch.from_numpy(kernel), CLIP_MEAN, CLIP_STD)


@pytest.mark.parametrize("out_dtype", [torch.float32, torch.bfloat16])
def test_kernel_branch_wiring(inputs, monkeypatch, out_dtype):
    """The CUDA branch (``_launch``) on CPU tensors with the launch replaced
    by the plain version: it hands the kernel the frames, the [K, D] folded
    weight and an [N, L, D] output of ``out_dtype``, and counts one launch."""
    frames, kernel = inputs
    seen = []

    def fake(frames_u8, folded_w, bias, out, patch):
        seen.append((tuple(frames_u8.shape), tuple(folded_w.shape), tuple(out.shape), out.dtype, patch))
        out.copy_(patchify.patch_embed_plain(frames_u8, folded_w, bias, patch, out.dtype))

    monkeypatch.setattr(patchify._kernels, "patch_embed_u8", fake)
    monkeypatch.setattr(patchify.fused_patch_embed, "launches", 0)
    folded_w, bias = _fold(kernel)
    got = patchify._launch(torch.from_numpy(frames), folded_w, bias, P, out_dtype)
    want = patchify.fused_patch_embed(torch.from_numpy(frames), torch.from_numpy(kernel), CLIP_MEAN, CLIP_STD,
                                      out_dtype=out_dtype)
    torch.testing.assert_close(got, want, atol=0, rtol=0)
    assert seen == [((3, 16, 24, 3), (P * P * 3, D), (3, 6, D), out_dtype, P)]
    assert patchify.fused_patch_embed.launches == 1


def test_kernel_branch_raises_and_counts_nothing(inputs, monkeypatch):
    """A failed launch propagates; outputs and embedding dims the kernel does
    not take raise before any launch. Nothing falls back to the plain GEMM."""
    frames, kernel = inputs
    f = torch.from_numpy(frames)
    folded_w, bias = _fold(kernel)

    def refuse(*args):
        raise RuntimeError("patch_embed_u8 launch failed: CUDA error 1 (invalid argument)")

    monkeypatch.setattr(patchify._kernels, "patch_embed_u8", refuse)
    monkeypatch.setattr(patchify.fused_patch_embed, "launches", 0)
    with pytest.raises(RuntimeError, match="launch failed"):
        patchify._launch(f, folded_w, bias, P, torch.float32)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        patchify._launch(f, folded_w, bias, P, torch.float16)
    with pytest.raises(ValueError, match="multiple of 4"):
        patchify._launch(f, folded_w[:, :-1], bias[:-1], P, torch.float32)
    assert patchify.fused_patch_embed.launches == 0


@pytest.mark.cuda
def test_byte_gather_path_equals_the_cp_async_path_on_card():
    """Frames that do not start 16-byte aligned take the bf16 kernel's
    byte-by-byte patch gather; it stages the same bytes as the 16-byte
    cp.async runs, so the two outputs are bit-equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    rng = np.random.default_rng(7)
    frames = torch.from_numpy(rng.integers(0, 256, size=(6, 224, 224, 3), dtype=np.uint8)).cuda()
    kernel = torch.from_numpy(rng.normal(size=(32, 32, 3, 768)).astype(np.float32) * 0.02).cuda()
    shifted = torch.empty(frames.numel() + 1, dtype=torch.uint8, device="cuda")[1:].view(frames.shape)
    shifted.copy_(frames)
    assert shifted.data_ptr() % 16 and shifted.is_contiguous()
    aligned = patchify.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD, torch.bfloat16, use_kernel=True)
    gathered = patchify.fused_patch_embed(shifted, kernel, CLIP_MEAN, CLIP_STD, torch.bfloat16, use_kernel=True)
    assert torch.equal(aligned, gathered)


def _bf16_ulps_of_max(got, want):
    """Largest |got - want| in bf16 ulps of ``want`` (fp32), |want| below
    2^-8 max|want| counted at that floor."""
    mag = want.abs().clamp_min(2.0**-8 * want.abs().max().item())
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - want) / ulp).abs().max().item()


# Relative to max|out|: K = 3*P*P terms of up to 255*|w| are summed in fp32
# in another order than cuBLAS's, so the absolute difference grows with the
# size of the sums, not with an output that happens to be small.
FP32_REL = 3e-5


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(4, 224, 224, 32, 768), (3, 224, 224, 16, 768), (7, 64, 96, 16, 200),
                                   (5, 96, 160, 32, 768), (2, 28, 42, 14, 64)])
def test_kernel_matches_plain_on_card(shape):
    """fp32 out within 3e-5 max|out| of the plain fp32 GEMM; bf16 out within
    one bf16 ulp of it (one rounding at the store); ragged row, K and D edges."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    N, H, W, p, d = shape
    rng = np.random.default_rng(sum(shape))
    frames = torch.from_numpy(rng.integers(0, 256, size=(N, H, W, 3), dtype=np.uint8)).cuda()
    kernel = torch.from_numpy(rng.normal(size=(p, p, 3, d)).astype(np.float32) * 0.02).cuda()
    want = patchify.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD)
    for out_dtype in (torch.float32, torch.bfloat16):
        before = patchify.fused_patch_embed.launches
        got = patchify.fused_patch_embed(frames, kernel, CLIP_MEAN, CLIP_STD, out_dtype, use_kernel=True)
        torch.cuda.synchronize()
        assert patchify.fused_patch_embed.launches == before + 1
        assert got.dtype == out_dtype and got.shape == want.shape
        if out_dtype == torch.float32:
            assert (got - want).abs().max().item() <= FP32_REL * want.abs().max().item()
        else:
            assert _bf16_ulps_of_max(got, want) <= 1.0


# -- the bf16 tensor-core kernel's numerics -----------------------------------


def _split(x):
    """fp32 x as the two bf16 terms the kernel feeds a product: hi = bf16(x),
    lo = bf16(x - hi), each returned as fp32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _emulate_bf16_kernel(frames_u8, folded_w, bias, patch, split=True):
    """The bf16 kernel's rounding points: uint8 patches widened exactly and
    centred (b - 128), the fp32 weight as hi + lo bf16 terms (or rounded
    once, ``split=False``), the products summed in fp32, + the bias shifted
    by 128 sum_k w, one bf16 rounding at the store. Returns [N, L, D] as
    fp32."""
    patches = patchify.extract_patches_u8(frames_u8, patch).float() - 128
    shifted = bias + 128 * folded_w.sum(dim=0)
    if split:
        hi, lo = _split(folded_w)
        acc = patches @ hi + patches @ lo
    else:
        acc = patches @ folded_w.to(torch.bfloat16).float()
    return (acc + shifted).to(torch.bfloat16).float()


def _b32_clip(seed):
    """The 12 uint8 frames of one B/32 clip (224x224) and a patch kernel of
    the model's shape [32, 32, 3, 768] (std 0.02), folded with the CLIP
    normalization."""
    rng = np.random.default_rng(seed)
    frames = torch.from_numpy(rng.integers(0, 256, size=(12, 224, 224, 3), dtype=np.uint8))
    kernel = rng.normal(size=(32, 32, 3, 768)).astype(np.float32) * 0.02
    return frames, *_fold(kernel)


@pytest.mark.parametrize("seed", [40, 41])
def test_kernel_rounding_points_meet_the_chip_bar(seed):
    """With the bf16 kernel's rounding points at the B/32 frame shape (one
    clip of 12 frames, P=32, D=768): <= 1 bf16 ulp (``BF16_MAX_ULP``, |out|
    below 2^-8 max|out| counted at that floor) of the fp32 plain GEMM."""
    frames, folded_w, bias = _b32_clip(seed)
    want = patchify.patch_embed_plain(frames, folded_w, bias, 32, torch.float32)
    assert _bf16_ulps_of_max(_emulate_bf16_kernel(frames, folded_w, bias, 32), want) <= 1.0


def test_one_bf16_rounding_of_the_weight_misses_the_bar():
    """The emulation can fail: the fp32 folded weight rounded once to bf16
    (what ``patch_embed_u8``'s bf16 GEMM does) lands beyond 1 ulp of the fp32
    plain GEMM at the B/32 frame shape, which is why the kernel splits it."""
    frames, folded_w, bias = _b32_clip(40)
    want = patchify.patch_embed_plain(frames, folded_w, bias, 32, torch.float32)
    assert _bf16_ulps_of_max(_emulate_bf16_kernel(frames, folded_w, bias, 32, split=False), want) > 8.0
