"""Port parity: the Swin3D/HTWA video encoder
(``xpretrain_tpu_torch/models/lf_vila/swin3d.py``) against the flax modules
of ``xpretrain_tpu/models/lf_vila/swin3d.py``, loaded from the same params
through ``load_jax_params``. fp32 on the CPU; the bar is the LF-VILA one of
ROADMAP Queue 1, 5e-5."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xpretrain_tpu.models.lf_vila import swin3d as jswin  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila import swin3d  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.convert import load_jax_params  # noqa: E402
from xpretrain_tpu_torch.ops.window_attention import window_attention  # noqa: E402

ATOL = 5e-5


def _noisy(params, seed=0):
    """Every leaf moved off its init (zero biases, unit norms included)."""
    rng = np.random.default_rng(seed)
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) + 0.02 * rng.normal(size=np.shape(x)).astype(np.float32), params
    )


def _pair(flax_module, port_module, *inputs, seed=0):
    params = _noisy(jax.jit(flax_module.init)(jax.random.PRNGKey(seed), *inputs)["params"], seed)
    load_jax_params(port_module, {"params": params})
    return params, port_module.eval()


@pytest.mark.parametrize("window", [(2, 3, 5), (4, 3, 5), (16, 3, 5), (32, 3, 5), (1, 2, 2)])
def test_relative_position_index_matches(window):
    np.testing.assert_array_equal(swin3d.relative_position_index(window), jswin.relative_position_index(window))


@pytest.mark.parametrize(
    "dims,window,shift,G",
    [((8, 12, 20), (2, 3, 5), (0, 1, 2), 4), ((8, 6, 10), (4, 3, 5), (0, 1, 2), 2),
     ((8, 6, 10), (4, 3, 5), (0, 0, 0), 2), ((16, 6, 10), (16, 3, 5), (0, 1, 2), 1)],
)
def test_masks_match(dims, window, shift, G):
    np.testing.assert_array_equal(swin3d.grouped_window_mask(dims, window, shift, G),
                                  jswin.grouped_window_mask(dims, window, shift, G))
    if any(shift):
        np.testing.assert_array_equal(swin3d.shifted_window_mask(dims, window, shift),
                                      jswin.shifted_window_mask(dims, window, shift))


def test_window_group_clip_partition_match():
    for nw in (1, 2, 4, 8, 6):
        for N in (30, 60, 120, 240):
            assert swin3d.pick_window_group(nw, N) == jswin.pick_window_group(nw, N)
    for size in ((8, 6, 10), (32, 3, 5), (4, 2, 3)):
        assert swin3d._clip_window(size, (16, 3, 5), (0, 1, 2)) == jswin._clip_window(size, (16, 3, 5), (0, 1, 2))
    x = np.random.default_rng(0).normal(size=(2, 4, 6, 10, 3)).astype(np.float32)
    got = swin3d.window_partition(torch.from_numpy(x), (2, 3, 5))
    np.testing.assert_array_equal(got.numpy(), np.asarray(jswin.window_partition(jnp.asarray(x), (2, 3, 5))))
    back = swin3d.window_reverse(got, (2, 3, 5), 2, 4, 6, 10)
    np.testing.assert_array_equal(back.numpy(), x)


def test_static_tensors_are_built_once_per_device():
    a = swin3d.device_constant(swin3d.shifted_window_mask, ((4, 6, 10), (2, 3, 5), (0, 1, 2)), torch.device("cpu"))
    b = swin3d.device_constant(swin3d.shifted_window_mask, ((4, 6, 10), (2, 3, 5), (0, 1, 2)), torch.device("cpu"))
    assert a is b
    with pytest.raises(ValueError):  # the shared numpy arrays are read-only
        swin3d.shifted_window_mask((4, 6, 10), (2, 3, 5), (0, 1, 2))[0, 0, 0] = 1.0


@pytest.mark.parametrize("hw", [(16, 24), (17, 30)], ids=["even", "padded"])
def test_patch_embed_u8_and_fp32_match(hw):
    """Both input paths; odd sizes pad D, H and W up to the patch."""
    rng = np.random.default_rng(1)
    u8 = rng.integers(0, 256, size=(2, 3, *hw, 3), dtype=np.uint8)
    f32 = rng.normal(size=(2, 3, 3, *hw)).astype(np.float32)
    flax_mod = jswin.PatchEmbed3D((2, 8, 8), 16)
    params, port = _pair(flax_mod, swin3d.PatchEmbed3D((2, 8, 8), 16), jnp.asarray(f32))
    for x in (u8, f32):
        want = flax_mod.apply({"params": params}, jnp.asarray(x))
        with torch.no_grad():
            got = port(torch.from_numpy(x))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_patch_merging_matches_with_odd_padding():
    x = np.random.default_rng(2).normal(size=(2, 3, 5, 7, 8)).astype(np.float32)
    flax_mod = jswin.PatchMerging(8)
    params, port = _pair(flax_mod, swin3d.PatchMerging(8), jnp.asarray(x))
    want = flax_mod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


BLOCKS = {  # name -> (input [D, H, W], window, shift, use_pallas, group_windows)
    "grouped_shifted": ((4, 6, 20), (2, 3, 5), (0, 1, 2), False, True),
    "ungrouped_shifted": ((4, 6, 20), (2, 3, 5), (0, 1, 2), False, False),
    "kernel_gate_shifted": ((8, 6, 10), (4, 3, 5), (0, 1, 2), True, True),
    "clipped_padded": ((5, 4, 7), (16, 3, 5), (0, 1, 2), True, True),
}


@pytest.mark.parametrize("name", BLOCKS)
def test_block_matches(name):
    """One W-MSA/SW-MSA block: grouped and not, through ``window_attention``
    (the kernel's gate; its plain version here) or the inline math, and a
    clipped, padded window whose bias truncates the full window's index."""
    dims, window, shift, use_pallas, group = BLOCKS[name]
    x = np.random.default_rng(3).normal(size=(2, *dims, 16)).astype(np.float32)
    flax_mod = jswin.SwinBlock3D(16, 2, window, shift, use_pallas=use_pallas, group_windows=group)
    port_mod = swin3d.SwinBlock3D(16, 2, window, shift, use_pallas=use_pallas, group_windows=group)
    params, port = _pair(flax_mod, port_mod, jnp.asarray(x))
    want = flax_mod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got = port(torch.from_numpy(x))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def _encoder_pair(cfg_kw, frames=(8, 48, 80), seed=0):
    x = np.random.default_rng(seed).normal(size=(2, 3, *frames)).astype(np.float32)
    flax_mod = jswin.SwinTransformer3D(jswin.Swin3DConfig.tiny(**cfg_kw))
    port_mod = swin3d.SwinTransformer3D(swin3d.Swin3DConfig.tiny(**cfg_kw))
    params, port = _pair(flax_mod, port_mod, jnp.asarray(x), seed=seed)
    return flax_mod, params, port, x


@pytest.mark.parametrize(
    "cfg_kw",
    [dict(use_pallas_attention=True), dict(group_windows=False), dict(faithful_local_branch=False),
     dict(attn_fold=True)],
    ids=["kernel_gate", "ungrouped", "captured_local", "fold"],
)
def test_encoder_matches(cfg_kw):
    """The whole tiny encoder, global and local outputs, in its layouts."""
    flax_mod, params, port, x = _encoder_pair(cfg_kw)
    want_global, want_local = flax_mod.apply({"params": params}, jnp.asarray(x))
    with torch.no_grad():
        got_global, got_local = port(torch.from_numpy(x))
    np.testing.assert_allclose(got_global.numpy(), np.asarray(want_global), atol=ATOL, rtol=0)
    np.testing.assert_allclose(got_local.numpy(), np.asarray(want_local), atol=ATOL, rtol=0)


def test_kernel_gate_counts_the_unclipped_window(monkeypatch):
    """At 8 frames of 96x160 the stage 3-5 windows clip to N=120 (8x3x5) and
    48 (8x2x3), but the gate tests the configured 240 and 480: those six
    blocks, and no others, go through ``window_attention``."""
    calls = []
    monkeypatch.setattr(swin3d, "window_attention",
                        lambda q, *a: calls.append(tuple(q.shape)) or window_attention(q, *a))
    port = swin3d.SwinTransformer3D(swin3d.Swin3DConfig.tiny(use_pallas_attention=True, depths=(2,) * 6))
    with torch.no_grad():
        port(torch.zeros(1, 3, 8, 96, 160))
    assert [s[2] for s in calls] == [120, 120, 120, 120, 48, 48]


def test_training_and_multi_device_options_raise():
    """Context parallelism builds, with or without remat, and outside a mesh
    with a model axis changes nothing, as JAX's constraint outside a mesh
    (its sharded forward: ``tests/test_torch_context_parallel.py``); remat
    builds, and with an unknown policy raises, as JAX's ``getattr`` does; a
    policy without remat is ignored, as in JAX."""
    tiny = swin3d.Swin3DConfig.tiny
    plain = swin3d.SwinTransformer3D(tiny()).eval()
    x = torch.randn(1, 3, 8, 48, 80, generator=torch.Generator().manual_seed(0))
    want = plain(x)
    for kw in (dict(context_parallel_axis="model"), dict(context_parallel_axis="model", remat=True)):
        cp = swin3d.SwinTransformer3D(tiny(**kw)).eval()
        cp.load_state_dict(plain.state_dict())
        assert cp.context_mesh() is None
        for got, ref in zip(cp(x), want):
            torch.testing.assert_close(got, ref, atol=0, rtol=0)
    assert swin3d.SwinTransformer3D(tiny(remat=True)).remat_context_fn is None
    assert swin3d.SwinTransformer3D(tiny(remat=True, remat_policy="dots_saveable")).remat_context_fn is not None
    assert swin3d.SwinTransformer3D(tiny(remat_policy="dots_saveable")).remat_context_fn is None
    with pytest.raises(ValueError, match="remat_policy"):
        swin3d.SwinTransformer3D(tiny(remat=True, remat_policy="not_a_policy"))


def test_kernel_gated_attention_dropout_raises_off_the_cpu(monkeypatch):
    """The name is the check this test made before the port took JAX's gate
    (``xpretrain_tpu/models/lf_vila/swin3d.py:270``): a kernel-gated block in
    training with attention dropout calls ``dot_attention`` and not the
    kernel wrapper, on any device (a meta tensor stands in for the card); in
    eval, or at dropout 0, it calls the wrapper. On the CPU the dropout
    branch draws from its generator, as JAX does on XLA."""
    calls = []

    def recorder(name):
        def record(q, *args, **kwargs):
            calls.append((name, q.device.type))
            return torch.empty_like(q)
        return record

    with monkeypatch.context() as patch:
        for name in ("dot_attention", "window_attention"):
            patch.setattr(swin3d, name, recorder(name))
        x = torch.empty(4, 30, 32, device="meta")
        for rate, training, want in ((0.25, True, "dot_attention"), (0.25, False, "window_attention"),
                                     (0.0, True, "window_attention")):
            calls.clear()
            attn = swin3d.WindowAttention3D(32, (2, 3, 5), 2, attn_drop=rate, use_pallas=True,
                                            device="meta").train(training)
            assert attn(x).shape == x.shape
            assert calls == [(want, "meta")], (rate, training, calls)
    attn = swin3d.WindowAttention3D(32, (2, 3, 5), 2, attn_drop=0.25, use_pallas=True).train()
    x = torch.randn(4, 30, 32, generator=torch.Generator().manual_seed(0))
    a = attn(x, generator=torch.Generator().manual_seed(1))
    b = attn(x, generator=torch.Generator().manual_seed(1))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert not torch.allclose(a, attn.eval()(x))


def test_drop_path_draws_from_its_generator_in_training_only():
    dp = swin3d.DropPath(0.5)
    x = torch.ones(64, 3)
    assert dp.eval()(x) is x
    dp.train()
    a = dp(x, torch.Generator().manual_seed(0))
    b = dp(x, torch.Generator().manual_seed(0))
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    assert set(a[:, 0].tolist()) == {0.0, 2.0}  # whole samples dropped or scaled by 1/keep
