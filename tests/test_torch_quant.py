"""Int8 serving of the port (``xpretrain_tpu_torch/ops/quant.py``): the cases
of ``tests/test_quant.py`` at their bars, and the port's int8 features
against JAX's int8 features on the same weights.

The reference has no quantized path (it serves fp16 torch); this is the w8a8
serving option of the JAX package. Accuracy contract: per-family embedding
cosine against the float path."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch import nn  # noqa: E402

from xpretrain_tpu_torch.models.clip_vip.convert import load_jax_params  # noqa: E402
from xpretrain_tpu_torch.models.clip_vip.model import (  # noqa: E402
    CLIPTextConfig,
    CLIPVipConfig,
    CLIPViPModel,
    CLIPVisionConfig,
    VipConfig,
)
from xpretrain_tpu_torch.ops.quant import (  # noqa: E402
    int8_matmul,
    int8_serving,
    maybe_int8_serving,
    quantize_weight,
)

# The port's int8 features against JAX's on the same weights and inputs: the
# two quantize the same fp32 activations (round half to even in both), sum
# int8 products exactly in int32 and rescale in fp32; what differs is the
# order of the fp32 arithmetic around the products (layer norms, attention,
# the rescale). Measured at this size on the CPU: max |diff| 6.0e-8 (video)
# and 3.0e-8 (text) on the L2-normalized features; the bar leaves room for an
# activation that lands on a rounding boundary in one and not the other.
INT8_JAX_ATOL = 1e-6
# float against int8 features of this CLIP-ViP: JAX's test holds 0.99, its
# module docstring reports >= 0.9994 at B/32; measured here 0.99994 (video)
# and 0.99984 (text), in the port and in JAX alike
CLIP_INT8_COS = 0.9994


def _cos(a, b):
    a = np.asarray(a, np.float64).ravel()
    b = np.asarray(b, np.float64).ravel()
    return float(a @ b / (np.linalg.norm(a) * np.linalg.norm(b) + 1e-12))


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: beside the other test processes, torch's
    all-cores default oversubscribes the CPU many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def test_quantize_weight_roundtrip():
    rng = np.random.default_rng(0)
    w = torch.from_numpy((rng.standard_normal((64, 48)) * 0.05).astype(np.float32))
    q, scale = quantize_weight(w)
    assert q.dtype == torch.int8 and scale.shape == (48,)
    deq = q.float().numpy() * scale.numpy()
    # absmax symmetric: per-channel max error is scale/2 = absmax/254
    err = np.abs(deq - w.numpy()).max(axis=0)
    bound = np.abs(w.numpy()).max(axis=0) / 254.0 + 1e-6
    assert (err <= bound + 1e-7).all()


def test_int8_matmul_accuracy():
    rng = np.random.default_rng(1)
    x = torch.from_numpy(rng.standard_normal((10, 3, 128)).astype(np.float32))
    w = torch.from_numpy((rng.standard_normal((128, 96)) * 0.1).astype(np.float32))
    q, s = quantize_weight(w)
    ref = (x @ w).numpy()
    out = int8_matmul(x, q, s).numpy()
    assert out.shape == (10, 3, 96)
    rel = np.linalg.norm(out - ref) / np.linalg.norm(ref)
    assert rel < 0.02, rel
    assert _cos(out, ref) > 0.999


def test_int8_matmul_preserves_dtype():
    x = torch.ones((4, 32), dtype=torch.bfloat16)
    q, s = quantize_weight(torch.ones((32, 16)))
    assert int8_matmul(x, q, s).dtype == torch.bfloat16


class _TwoDense(nn.Module):
    def __init__(self):
        super().__init__()
        self.big = nn.Linear(300, 512)
        self.small_head = nn.Linear(512, 4)

    def forward(self, x):
        return self.small_head(self.big(x))


def _two_dense(seed=0):
    torch.manual_seed(seed)
    return _TwoDense()


def test_interceptor_thresholds():
    m = _two_dense()
    x = torch.from_numpy(np.random.default_rng(2).standard_normal((8, 300)).astype(np.float32))
    with torch.no_grad():
        ref = m(x)
        with int8_serving(min_in_features=256, min_features=256):
            out = m(x)
        # thresholds above every layer -> the exact float path
        with int8_serving(min_in_features=4096, min_features=4096):
            out_fp = m(x)
    # big Linear quantized -> a small numeric difference; the head stays float
    assert not np.allclose(out.numpy(), ref.numpy(), atol=1e-7)
    assert _cos(out, ref) > 0.99
    np.testing.assert_allclose(out_fp.numpy(), ref.numpy(), atol=1e-6)


def test_module_built_under_int8_serving_is_untouched():
    """Building a model inside the context creates its float parameters as
    usual (JAX: an init under interception falls through); leaving the
    context restores every ``nn.Linear`` class's forward."""
    forward = nn.Linear.forward
    with int8_serving(min_in_features=8, min_features=8):
        m = _two_dense()
        assert nn.Linear.forward is not forward
    assert nn.Linear.forward is forward
    assert m.big.weight.shape == (512, 300) and m.big.weight.dtype == torch.float32


def test_int8_under_export():
    """The int8 forward traces into an exported program (JAX: under jit) that
    equals the eager int8 forward."""
    m = _two_dense().eval()
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((4, 300)).astype(np.float32))
    with torch.no_grad(), int8_serving(min_in_features=8, min_features=8):
        eager = m(x)
        program = torch.export.export(m, (x,))
    assert any("_int_mm" in str(node.target) for node in program.graph.nodes)
    with torch.no_grad():
        np.testing.assert_allclose(program.module()(x).numpy(), eager.numpy(), atol=1e-5)


def test_maybe_int8_serving_disabled_is_exact():
    m = _two_dense()
    x = torch.ones((2, 300))
    with torch.no_grad():
        with maybe_int8_serving(False, min_in_features=8, min_features=8):
            out = m(x)
        np.testing.assert_allclose(out.numpy(), m(x).numpy(), atol=1e-7)


# -- per-family accuracy: embedding cosine, float against int8 ---------------------


def _clip_configs():
    """(port config, JAX config) of the small CLIP-ViP of ``tests/test_quant.py``."""
    import jax.numpy as jnp

    from xpretrain_tpu.models import clip_vip as jcv

    text = dict(vocab_size=49408, hidden_size=64, intermediate_size=128, num_hidden_layers=2,
                num_attention_heads=4, max_position_embeddings=16)
    vision = dict(hidden_size=64, intermediate_size=128, num_hidden_layers=2, num_attention_heads=4,
                  image_size=32, patch_size=16)
    vip = dict(temporal_size=2, add_cls_num=2)
    port = CLIPVipConfig(text=CLIPTextConfig(**text), vision=CLIPVisionConfig(**vision), vip=VipConfig(**vip),
                         projection_dim=32, dtype=torch.float32)
    jax = jcv.CLIPVipConfig(text=jcv.CLIPTextConfig(**text), vision=jcv.CLIPVisionConfig(**vision),
                            vip=jcv.VipConfig(**vip), projection_dim=32, dtype=jnp.float32)
    return port, jax


def _clip_inputs():
    rng = np.random.default_rng(4)
    video = rng.standard_normal((3, 2, 3, 32, 32)).astype(np.float32)
    ids = np.zeros((3, 12), np.int64)
    ids[:, 0] = 49406
    ids[:, 1:4] = rng.integers(300, 40000, (3, 3))
    ids[:, 4] = 49407
    return video, ids, (ids > 0).astype(np.int64)


@pytest.fixture(scope="module")
def clip_pair():
    """The JAX model, its params, and the port's model loaded from them."""
    import jax

    from xpretrain_tpu.models.clip_vip import CLIPViPModel as JaxModel

    port_cfg, jax_cfg = _clip_configs()
    jax_model = JaxModel(jax_cfg)
    video, ids, mask = _clip_inputs()
    params = jax_model.init(jax.random.PRNGKey(0), video, ids.astype(np.int32), mask.astype(np.int32))["params"]
    port = CLIPViPModel(port_cfg)
    load_jax_params(port, {"params": params})
    return jax_model, params, port.eval()


def test_clipvip_int8_embedding_cosine(clip_pair):
    _, _, port = clip_pair
    inputs = [torch.from_numpy(a) for a in _clip_inputs()]
    with torch.no_grad():
        ref = port(*inputs)
        with int8_serving(min_in_features=8, min_features=8):
            out = port(*inputs)
    for key in ("vis_features", "text_features"):
        c = _cos(out[key], ref[key])
        assert c >= CLIP_INT8_COS, (key, c)


def test_clipvip_int8_features_match_jax_int8(clip_pair):
    """The port's int8 features against JAX's int8 features on the same
    weights and inputs (``INT8_JAX_ATOL``)."""
    import jax

    from xpretrain_tpu.ops.quant import int8_serving as jax_int8_serving

    jax_model, params, port = clip_pair
    video, ids, mask = _clip_inputs()
    with jax_int8_serving(min_in_features=8, min_features=8):
        want = jax.jit(lambda p, *a: jax_model.apply({"params": p}, *a))(
            params, video, ids.astype(np.int32), mask.astype(np.int32))
    with torch.no_grad(), int8_serving(min_in_features=8, min_features=8):
        got = port(*(torch.from_numpy(a) for a in (video, ids, mask)))
    for key in ("vis_features", "text_features"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), atol=INT8_JAX_ATOL, rtol=0,
                                   err_msg=key)


def test_bert_int8_hidden_cosine():
    """The staged BERT (HD-VILA's and LF-VILA's text towers) under int8
    serving."""
    from xpretrain_tpu_torch.models.bert import BertConfig, StagedBertModel

    cfg = BertConfig(vocab_size=1000, hidden_size=64, num_hidden_layers=4, num_attention_heads=4,
                     intermediate_size=128, max_position_embeddings=64)
    model = StagedBertModel(cfg).eval()
    g = torch.Generator().manual_seed(1)
    with torch.no_grad():
        for p in model.parameters():
            p.normal_(0.0, 0.05, generator=g)
    rng = np.random.default_rng(5)
    ids = torch.from_numpy(rng.integers(1, 1000, (2, 24)))
    mask = torch.ones((2, 24), dtype=torch.long)
    with torch.no_grad():
        ref = model(ids, attention_mask=mask)
        with int8_serving(min_in_features=8, min_features=8):
            out = model(ids, attention_mask=mask)
    ref, out = (x[0] if isinstance(x, (tuple, list)) else x for x in (ref, out))
    assert _cos(out, ref) > 0.99
