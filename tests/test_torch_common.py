"""Port parity: shared transformer blocks (``xpretrain_tpu_torch/models/common.py``)
against the flax originals, same seeded inputs and weights, fp32 on the CPU."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xpretrain_tpu.models import common as jax_common  # noqa: E402
from xpretrain_tpu_torch.models import common  # noqa: E402

B, S, E, HEADS = 3, 7, 32, 4


def _load_dense(linear, params):
    with torch.no_grad():
        linear.weight.copy_(torch.from_numpy(np.array(params["kernel"]).T))
        linear.bias.copy_(torch.from_numpy(np.array(params["bias"])))


def _padding_mask(rng):
    lengths = rng.integers(2, S + 1, size=B)
    return (np.arange(S)[None] < lengths[:, None]).astype(np.int64)


@pytest.mark.parametrize("masks", ["none", "causal", "causal+padding"])
def test_multi_head_attention_matches_flax(masks):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(B, S, E)).astype(np.float32)
    keep = _padding_mask(rng)

    def mask_of(mod, as_array):
        if masks == "none":
            return None
        m = mod.make_causal_mask(S)
        if masks == "causal+padding":
            m = m + mod.expand_padding_mask(as_array(keep))
        return m

    flax_mha = jax_common.MultiHeadAttention(E, HEADS)
    params = flax_mha.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    want = flax_mha.apply({"params": params}, jnp.asarray(x), mask_of(jax_common, jnp.asarray))

    mha = common.MultiHeadAttention(E, HEADS)
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _load_dense(getattr(mha, name), params[name])
    got = mha(torch.from_numpy(x), mask_of(common, torch.from_numpy))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6, rtol=0)


@pytest.mark.parametrize("act", ["quick_gelu", "gelu", "gelu_new", "relu"])
def test_mlp_matches_flax(act):
    rng = np.random.default_rng(1)
    x = rng.normal(size=(B, S, E)).astype(np.float32)
    flax_mlp = jax_common.TransformerMLP(E, 2 * E, act)
    params = flax_mlp.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"]
    want = flax_mlp.apply({"params": params}, jnp.asarray(x))

    mlp = common.TransformerMLP(E, 2 * E, act)
    _load_dense(mlp.fc1, params["fc1"])
    _load_dense(mlp.fc2, params["fc2"])
    got = mlp(torch.from_numpy(x))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6, rtol=0)


def test_masks_match_flax():
    keep = _padding_mask(np.random.default_rng(2))
    np.testing.assert_array_equal(
        common.make_causal_mask(S).numpy(), np.asarray(jax_common.make_causal_mask(S))
    )
    np.testing.assert_array_equal(
        common.expand_padding_mask(torch.from_numpy(keep)).numpy(),
        np.asarray(jax_common.expand_padding_mask(jnp.asarray(keep))),
    )


def test_dot_attention_bf16_scores_in_fp32():
    """bf16 inputs: fp32 scores + softmax, weights cast to bf16 before PV,
    as the flax ``dot_attention`` does (bf16 output, one bf16 rounding)."""
    rng = np.random.default_rng(3)
    q, k, v = (rng.normal(size=(B, HEADS, S, 8)).astype(np.float32) for _ in range(3))
    mask = np.array(jax_common.make_causal_mask(S))
    want = jax_common.dot_attention(
        *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)), 8**-0.5, jnp.asarray(mask)
    )
    got = common.dot_attention(
        *(torch.from_numpy(a).bfloat16() for a in (q, k, v)), 8**-0.5, torch.from_numpy(mask)
    )
    assert got.dtype == torch.bfloat16
    np.testing.assert_allclose(
        got.float().numpy(), np.asarray(want, np.float32), atol=1.6e-2, rtol=0
    )


def test_dropout_rate_zero_equals_no_dropout():
    rng = np.random.default_rng(4)
    x = torch.from_numpy(rng.normal(size=(B, S, E)).astype(np.float32))
    mha = common.MultiHeadAttention(E, HEADS, dropout_rate=0.0).train()
    want = common.MultiHeadAttention(E, HEADS).eval()
    want.load_state_dict(mha.state_dict())
    got = mha(x, common.make_causal_mask(S), torch.Generator().manual_seed(0))
    torch.testing.assert_close(got, want(x, common.make_causal_mask(S)), rtol=0, atol=0)
    # and a rate only acts in training mode
    mha.dropout_rate = 0.5
    torch.testing.assert_close(mha.eval()(x), want(x), rtol=0, atol=0)


def test_dot_attention_dropout_matches_flax_with_its_keep_mask():
    """The flax version draws ``bernoulli(rng, 1 - rate)`` over the weights;
    handed that same mask, the port drops and rescales the same entries."""
    rng = np.random.default_rng(5)
    q, k, v = (rng.normal(size=(B, HEADS, S, 8)).astype(np.float32) for _ in range(3))
    mask = np.array(jax_common.make_causal_mask(S))
    key, rate = jax.random.PRNGKey(3), 0.3
    want = jax_common.dot_attention(
        *map(jnp.asarray, (q, k, v)), 8**-0.5, jnp.asarray(mask), key, rate, deterministic=False
    )
    keep = np.asarray(jax.random.bernoulli(key, 1.0 - rate, (B, HEADS, S, S)))
    got = common.dot_attention(
        *map(torch.from_numpy, (q, k, v)), 8**-0.5, torch.from_numpy(mask), rate,
        keep=torch.from_numpy(keep),
    )
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6, rtol=0)


def test_dot_attention_dropout_draws_from_its_generator():
    rng = np.random.default_rng(6)
    q, k, v = (torch.from_numpy(rng.normal(size=(B, HEADS, S, 8)).astype(np.float32)) for _ in range(3))
    a = common.dot_attention(q, k, v, 8**-0.5, dropout_rate=0.5, generator=torch.Generator().manual_seed(1))
    b = common.dot_attention(q, k, v, 8**-0.5, dropout_rate=0.5, generator=torch.Generator().manual_seed(1))
    c = common.dot_attention(q, k, v, 8**-0.5, dropout_rate=0.5, generator=torch.Generator().manual_seed(2))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert (a - c).abs().max() > 1e-3


def _capture_bernoulli(monkeypatch):
    """Record the keep masks the flax dropout draws, to hand them to the port."""
    drawn = []
    real = jax.random.bernoulli

    def bernoulli(*args, **kwargs):
        drawn.append(np.asarray(real(*args, **kwargs)))
        return jnp.asarray(drawn[-1])

    monkeypatch.setattr(jax.random, "bernoulli", bernoulli)
    return drawn


def test_multi_head_attention_dropout_matches_flax(monkeypatch):
    rng = np.random.default_rng(7)
    x = rng.normal(size=(B, S, E)).astype(np.float32)
    mask = np.array(jax_common.make_causal_mask(S))
    flax_mha = jax_common.MultiHeadAttention(E, HEADS, dropout_rate=0.3)
    params = flax_mha.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"]
    drawn = _capture_bernoulli(monkeypatch)
    want = flax_mha.apply({"params": params}, jnp.asarray(x), jnp.asarray(mask), deterministic=False,
                          rngs={"dropout": jax.random.PRNGKey(4)})
    mha = common.MultiHeadAttention(E, HEADS, dropout_rate=0.3).train()
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _load_dense(getattr(mha, name), params[name])
    got = mha(torch.from_numpy(x), torch.from_numpy(mask), keep=torch.from_numpy(drawn[0]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6, rtol=0)


def test_proxy_attention_dropout_branch_matches_flax(monkeypatch):
    """With dropout on in training, both models leave the kernel for the
    masked ``dot_attention`` over the proxy mask."""
    from xpretrain_tpu.models.clip_vip.model import ProxyAttention as FlaxProxy
    from xpretrain_tpu_torch.models.clip_vip.model import ProxyAttention

    M, N, L = 2, 3, 4
    rng = np.random.default_rng(8)
    x = rng.normal(size=(B, M + N * L, E)).astype(np.float32)
    flax_attn = FlaxProxy(E, HEADS, dropout_rate=0.25)
    params = flax_attn.init(jax.random.PRNGKey(0), jnp.asarray(x), (M, N, L))["params"]
    drawn = _capture_bernoulli(monkeypatch)
    want = flax_attn.apply({"params": params}, jnp.asarray(x), (M, N, L), deterministic=False,
                           rngs={"dropout": jax.random.PRNGKey(5)})
    attn = ProxyAttention(E, HEADS, dropout_rate=0.25).train()
    for name in ("q_proj", "k_proj", "v_proj", "out_proj"):
        _load_dense(getattr(attn, name), params[name])
    got = attn(torch.from_numpy(x), (M, N, L), keep=torch.from_numpy(drawn[0]))
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=2e-6, rtol=0)


def _recorders(monkeypatch, module, names) -> list:
    """Replace ``module``'s ``names`` with recorders that log (name, device)
    and return an empty tensor shaped as their first argument."""
    calls = []

    def recorder(name):
        def record(q, *args, **kwargs):
            calls.append((name, q.device.type))
            return torch.empty_like(q)
        return record

    for name in names:
        monkeypatch.setattr(module, name, recorder(name))
    return calls


def test_proxy_attention_dropout_raises_off_the_cpu(monkeypatch):
    """The name is the check this test made before the port took JAX's gate
    (``xpretrain_tpu/models/clip_vip/model.py:216``): in training with
    dropout on, the layer calls the masked ``dot_attention`` and not the
    kernel wrapper, on any device (a meta tensor stands in for a CUDA one);
    in eval, or at dropout 0, it calls the wrapper."""
    from xpretrain_tpu_torch.models.clip_vip import model

    M, N, L = 2, 3, 4
    calls = _recorders(monkeypatch, model, ("dot_attention", "proxy_attention"))
    x = torch.empty(B, M + N * L, E, device="meta")
    for rate, training, want in ((0.25, True, "dot_attention"), (0.25, False, "proxy_attention"),
                                 (0.0, True, "proxy_attention")):
        calls.clear()
        attn = model.ProxyAttention(E, HEADS, dropout_rate=rate, device="meta").train(training)
        assert attn(x, (M, N, L)).shape == x.shape
        assert calls == [(want, "meta")], (rate, training, calls)
