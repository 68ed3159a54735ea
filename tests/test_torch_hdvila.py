"""Port parity: HD-VILA's video encoder (``xpretrain_tpu_torch/models/hd_vila/
{resnet,timesformer,e2e}.py``) against the JAX package's modules on the CPU.

Each module is built in JAX, seeded params of its shape are carried into
the port by ``load_jax_params`` (which raises unless the trees match leaf
for leaf), and both run on the same seeded numpy inputs in fp32. Outputs
agree within 1e-4 of max(1, max|JAX output|) (PARITY.md's HD-VILA bar; the
ResNets' sums run over up to 4608 terms in another order). The JAX modules
are shared per module of tests, and their applies run jitted.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _hdvila_parity import assert_close as _close  # noqa: E402
from _hdvila_parity import jit_apply, random_params  # noqa: E402
from xpretrain_tpu_torch.models.hd_vila.convert import load_jax_params  # noqa: E402
from xpretrain_tpu_torch.models.hd_vila.e2e import HdVilaEncoder, HdVilaEncoderConfig  # noqa: E402
from xpretrain_tpu_torch.models.hd_vila.resnet import Conv2d, FrozenBatchNorm, ResNet  # noqa: E402
from xpretrain_tpu_torch.models.hd_vila.timesformer import (  # noqa: E402
    TimeSformer,
    TimeSformerConfig,
    _interp_1d,
    _interp_2d,
)

@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: beside the other test processes, torch's
    all-cores default oversubscribes the CPU many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


# -- ResNet -------------------------------------------------------------------

RESNETS = {"resnet18": dict(depth=18, base_channels=64), "resnet50_narrow": dict(depth=50, base_channels=16)}


@pytest.fixture(scope="module")
def resnets():
    """name -> (kwargs, flax params, the JAX module, the port module loaded
    from them)."""
    from xpretrain_tpu.models.hd_vila.resnet import ResNet as JaxResNet

    out = {}
    for name, kw in RESNETS.items():
        jax_model = JaxResNet(**kw)
        params = random_params(jax_model, np.zeros((1, 3, 64, 96), np.float32))
        out[name] = (kw, params, jax_model, load_jax_params(ResNet(**kw), {"params": params}))
    return out


def _images(shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.mark.parametrize("name", sorted(RESNETS))
def test_resnet_stages_match_jax(resnets, name):
    """All four stage outputs, ``forward_to_stage``, ``forward_stage_out`` and
    ``forward_in_stage`` at 64x96."""
    kw, params, jax_model, port = resnets[name]
    x = _images((2, 3, 64, 96))
    want = jit_apply(jax_model)(params, x)
    got = port(torch.from_numpy(x))
    assert len(got) == len(want) == 4
    for i, (g, w) in enumerate(zip(got, want)):
        _close(g, w, f"stage {i}")
    _close(port.forward_to_stage(torch.from_numpy(x), 2),
           jit_apply(jax_model, jax_model.forward_to_stage, stage=2)(params, x), "forward_to_stage")
    shallow, outs = port.forward_stage_out(torch.from_numpy(x), 1)
    w_shallow, w_outs = jit_apply(jax_model, jax_model.forward_stage_out, stage=1)(params, x)
    _close(shallow, w_shallow, "shallow")
    for g, w in zip(outs, w_outs):
        _close(g, w, "forward_stage_out")
    mid = np.array(want[1])
    for g, w in zip(port.forward_in_stage(torch.from_numpy(mid), 1),
                    jit_apply(jax_model, jax_model.forward_in_stage, stage=1)(params, mid)):
        _close(g, w, "forward_in_stage")


def test_low_res_resnet_has_no_fourth_stage_as_flax(resnets):
    """``num_stages=3`` holds exactly the params that ``forward_to_stage(2)``
    creates in flax (the encoder's ``cnn_low``): the load is total, the
    output is the full model's, and a stage-4 forward raises."""
    import jax

    kw, params, jax_model, port = resnets["resnet50_narrow"]
    shapes = jax.eval_shape(lambda r, a: jax_model.init(r, a, 2, method=jax_model.forward_to_stage),
                            jax.random.PRNGKey(0), np.zeros((1, 3, 64, 96), np.float32))["params"]
    assert all(shapes[k]["conv1"]["kernel"].shape == params[k]["conv1"]["kernel"].shape
               for k in shapes if k.startswith("layer"))
    assert set(shapes) == {k for k in params if not k.startswith("layer4")}
    low = load_jax_params(ResNet(**kw, num_stages=3), {"params": {k: params[k] for k in shapes}})
    x = torch.from_numpy(_images((1, 3, 64, 96)))
    torch.testing.assert_close(low.forward_to_stage(x, 2), port.forward_to_stage(x, 2), atol=0, rtol=0)
    with pytest.raises(ValueError, match="stage 3"):
        low(x)  # stage 3 (layer4) is not built


def test_direct_stem_is_jax_s2d_stem():
    """The port always runs the direct 7x7/s2 conv: it equals JAX's
    space-to-depth stem (``s2d=True``) on the same kernel, and its direct
    one."""
    import jax

    from xpretrain_tpu.models.hd_vila.resnet import StemConv

    x = _images((2, 46, 64, 3))
    params = StemConv(8, s2d=True).init(jax.random.PRNGKey(1), x)
    conv = Conv2d(3, 8, 7, 2)
    with torch.no_grad():
        conv.weight.copy_(torch.from_numpy(np.array(params["params"]["kernel"]).transpose(3, 2, 0, 1)))
    got = conv(torch.from_numpy(x.transpose(0, 3, 1, 2))).permute(0, 2, 3, 1)
    for s2d in (True, False):
        want = StemConv(8, s2d=s2d).apply(params, x)
        np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_odd_size_runs_where_jax_s2d_stem_fails(resnets):
    """At an odd input size JAX's s2d stem raises; the port's ResNet with
    ``s2d_stem=True`` runs the direct conv and matches JAX's direct stem."""
    from xpretrain_tpu.models.hd_vila.resnet import ResNet as JaxResNet

    kw, params, direct, _ = resnets["resnet18"]
    x = _images((1, 3, 33, 49))
    with pytest.raises(Exception):
        jit_apply(JaxResNet(**kw, s2d_stem=True))(params, x)
    port = load_jax_params(ResNet(**kw, s2d_stem=True), {"params": params})
    for g, w in zip(port(torch.from_numpy(x)), jit_apply(direct)(params, x)):
        _close(g, w)


def test_stem_max_pool_is_the_minus_inf_padded_pool():
    """``nn.MaxPool2d(3, 2, 1)`` equals JAX's -inf pad by 1 and VALID 3x3/s2
    pool (``resnet.py:213-214``), at even and odd sizes, on negative inputs."""
    import flax.linen as fnn
    import jax.numpy as jnp

    for shape in ((2, 4, 10, 14), (1, 3, 9, 7)):
        x = _images(shape) - 3.0
        nhwc = jnp.pad(jnp.asarray(x.transpose(0, 2, 3, 1)), ((0, 0), (1, 1), (1, 1), (0, 0)),
                       constant_values=-jnp.inf)
        want = np.asarray(fnn.max_pool(nhwc, (3, 3), strides=(2, 2))).transpose(0, 3, 1, 2)
        np.testing.assert_array_equal(torch.nn.MaxPool2d(3, 2, 1)(torch.from_numpy(x)).numpy(), want)


def test_frozen_bn_computes_its_scale_in_fp32_before_the_cast():
    """bf16 activations: ``rsqrt(var + eps) * scale`` in fp32, then cast, as
    JAX (``resnet.py:51-53``); a variance where a bf16 rsqrt would be off by
    several ulps still gives JAX's output within one bf16 ulp."""
    import jax.numpy as jnp

    from xpretrain_tpu.models.hd_vila.resnet import FrozenBatchNorm as JaxBN

    rng = np.random.default_rng(3)
    c = 8
    stats = {"scale": rng.normal(size=c) + 2.0, "bias": rng.normal(size=c), "mean": rng.normal(size=c),
             "var": rng.uniform(3e3, 9e3, size=c)}
    stats = {k: v.astype(np.float32) for k, v in stats.items()}
    x = _images((2, 5, 4, c)) * 50.0
    want = np.asarray(JaxBN(c, dtype=jnp.bfloat16).apply({"params": stats}, jnp.asarray(x, jnp.bfloat16)),
                      np.float32)
    bn = FrozenBatchNorm(c)
    with torch.no_grad():
        for k, v in stats.items():
            getattr(bn, k).copy_(torch.from_numpy(v))
    with torch.no_grad():
        got = bn(torch.from_numpy(x.transpose(0, 3, 1, 2)).bfloat16()).float().permute(0, 2, 3, 1).numpy()
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0**-20))) - 7)
    assert np.abs(got - want).max() / 1.0 <= ulp.max() and np.all(np.abs(got - want) <= ulp)


# -- TimeSformer --------------------------------------------------------------


@pytest.mark.parametrize("src,dst", [(3, 3), (3, 5), (7, 2), (4, 1)])
def test_interp_1d_matches_jax(src, dst):
    from xpretrain_tpu.models.hd_vila.timesformer import _interp_1d as jax_interp_1d

    emb = _images((1, src, 6))
    np.testing.assert_allclose(_interp_1d(torch.from_numpy(emb), dst).numpy(), np.asarray(jax_interp_1d(emb, dst)),
                               atol=1e-6, rtol=0)


@pytest.mark.parametrize("src,dst", [((2, 4), (2, 4)), ((2, 4), (3, 6)), ((10, 16), (7, 5)), ((3, 3), (1, 2))])
def test_interp_2d_matches_jax(src, dst):
    from xpretrain_tpu.models.hd_vila.timesformer import _interp_2d as jax_interp_2d

    emb = _images((1, src[0] * src[1], 6))
    np.testing.assert_allclose(_interp_2d(torch.from_numpy(emb), src, dst).numpy(),
                               np.asarray(jax_interp_2d(emb, src, dst)), atol=1e-6, rtol=0)


@pytest.fixture(scope="module")
def timesformer():
    from xpretrain_tpu.models.hd_vila.timesformer import TimeSformer as JaxTimeSformer
    from xpretrain_tpu.models.hd_vila.timesformer import TimeSformerConfig as JaxConfig

    kw = dict(depth=2, num_frames=3, H=2, W=4, embed_dim=32, num_heads=4)
    jax_model = JaxTimeSformer(JaxConfig(**kw))
    params = random_params(jax_model, np.zeros((1, 3, 32, 2, 4), np.float32))
    return jit_apply(jax_model), params, load_jax_params(TimeSformer(TimeSformerConfig(**kw)), {"params": params})


@pytest.mark.parametrize("shape", [(2, 3, 32, 2, 4), (1, 5, 32, 3, 6), (2, 2, 32, 1, 3)],
                         ids=["matched", "more_frames_larger_grid", "fewer_frames_smaller_grid"])
def test_timesformer_matches_jax(timesformer, shape):
    """At the trained grid and frame count, and at mismatched ones (both
    position embeddings interpolated)."""
    jax_apply, params, port = timesformer
    x = _images(shape)
    _close(port(torch.from_numpy(x)), jax_apply(params, x))


def test_timesformer_init_and_tree_follow_jax():
    """``temporal_fc`` is zero in blocks i > 0 only, and no final LayerNorm
    exists (the reference declares it and never applies it)."""
    from xpretrain_tpu_torch.cli.run_pretrain_hdvila import init_hdvila_weights

    model = init_hdvila_weights(TimeSformer(TimeSformerConfig(depth=3, embed_dim=16, num_heads=2)),
                                torch.Generator().manual_seed(0))
    assert model.blocks_0.temporal_fc.weight.abs().sum() > 0
    assert all(getattr(model, f"blocks_{i}").temporal_fc.weight.abs().sum() == 0 for i in (1, 2))
    assert not any("norm" in name and "blocks" not in name for name, _ in model.named_parameters())
    assert not model.time_embed.detach().any()


# -- the hybrid encoder -------------------------------------------------------

B, CLIPS, FRM = 2, 2, 3


@pytest.fixture(scope="module")
def encoder():
    """The tiny encoder of ``tests/test_hdvila.py`` (middles 128x256,
    neighbours 32x64, TimeSformer grid (2, 4)) in both packages, and 0-255
    frames."""
    from xpretrain_tpu.models.hd_vila.e2e import HdVilaEncoder as JaxEncoder
    from xpretrain_tpu.models.hd_vila.e2e import HdVilaEncoderConfig as JaxConfig

    rng = np.random.default_rng(0)
    mid = rng.integers(0, 256, size=(B, CLIPS, 3, 128, 256)).astype(np.uint8)
    oth = rng.integers(0, 256, size=(B, CLIPS, FRM - 1, 3, 32, 64)).astype(np.uint8)
    jax_model = JaxEncoder(JaxConfig.tiny(timesformer_frames=FRM, timesformer_hw=(2, 4)))
    params = random_params(jax_model, mid[:1].astype(np.float32), oth[:1].astype(np.float32))
    port = HdVilaEncoder(HdVilaEncoderConfig.tiny(timesformer_frames=FRM, timesformer_hw=(2, 4)))
    return jax_model, params, load_jax_params(port, {"params": params}), mid, oth


def test_encoder_matches_jax(encoder):
    """``__call__`` of both branches together: the [B, clips, 1, H', W', C]
    grid, from uint8 frames in the port and their 0-255 fp32 in JAX."""
    jax_model, params, port, mid, oth = encoder
    want = jit_apply(jax_model)(params, mid.astype(np.float32), oth.astype(np.float32))
    got = port(torch.from_numpy(mid), torch.from_numpy(oth))
    assert tuple(got.shape) == (B, CLIPS, 1, 2, 4, 64)
    _close(got, want)
    _close(port(torch.from_numpy(mid).float(), torch.from_numpy(oth).float()), want, "0-255 fp32 frames")


@pytest.mark.parametrize("branch", ["middle_only", "other_only"])
def test_encoder_single_branches_match_jax(encoder, branch):
    """``extract_features`` with no neighbours (the middle frame alone
    through the TimeSformer) and with no middle frame (the neighbours
    alone, at a frame count the time embedding interpolates to)."""
    jax_model, params, port, mid, oth = encoder
    args = (mid, None) if branch == "middle_only" else (None, oth)
    jax_args = tuple(None if a is None else a.astype(np.float32) for a in args)
    want_stages, want = _jax_branch(jax_model, params, jax_args)
    got_stages, got = port.extract_features(*(None if a is None else torch.from_numpy(a) for a in args))
    _close(got, want)
    assert len(got_stages) == len(want_stages)
    for g, w in zip(got_stages, want_stages):
        _close(g, w, "stage features")


def _jax_branch(jax_model, params, args):
    import jax

    middle, other = args
    run = jax.jit(lambda p, x: jax_model.apply({"params": p}, x if middle is not None else None,
                                               x if other is not None else None, method=jax_model.extract_features))
    return run(params, middle if middle is not None else other)


def test_encoder_remat_gives_the_same_gradients(encoder):
    """``remat`` (per-block recompute) changes neither the output nor the
    gradients."""
    _, params, _, mid, oth = encoder
    grads = {}
    for remat in (False, True):
        model = load_jax_params(HdVilaEncoder(HdVilaEncoderConfig.tiny(timesformer_frames=FRM, timesformer_hw=(2, 4),
                                                                       remat=remat)), {"params": params})
        model(torch.from_numpy(mid[:1]), torch.from_numpy(oth[:1])).square().mean().backward()
        grads[remat] = {n: p.grad.clone() for n, p in model.named_parameters() if p.grad is not None}
    assert grads[False].keys() == grads[True].keys() and grads[False]
    for name, g in grads[False].items():
        torch.testing.assert_close(grads[True][name], g, atol=1e-6, rtol=1e-5)
