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
