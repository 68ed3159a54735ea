"""Port parity: the contrastive-loss zoo (``xpretrain_tpu_torch/ops/losses.py``)
against the JAX losses, value and gradients, fp32 on the CPU.

The features are L2-normalized rows made with numpy from a seed; the
learnable-temperature losses run at logit_scale = 4.6 (exp = 99.5), so the
similarities reach ~100 and logsumexp runs over 2B terms in another order
than XLA's: 1e-5 relative covers the values. A gradient entry sums ~B terms
each scaled by ~100, so fp32 rounding reaches 100 * 2^-23 * B ~ 1e-5 in
absolute terms: 2e-5 absolute covers the gradients.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.ops import losses  # noqa: E402

B, D, K_MIL = 8, 16, 2
STATIC = {"HardNegLoss": {"hard_negative_num": 4}, "TripletContrastiveLoss": {"max_violation": True}}
RTOL, ATOL = 1e-5, 2e-5


@pytest.fixture(scope="module")
def jax_losses():
    return pytest.importorskip("xpretrain_tpu.ops.losses")


def _features(name, seed):
    rng = np.random.default_rng(seed)

    def unit(n):
        x = rng.normal(size=(n, D)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    kind = losses.LOSS_REGISTRY[name][1]
    if name == "MILNCEContrastiveLoss":
        return [unit(B), unit(B * K_MIL)]
    feats = [unit(B), unit(B)]
    if kind == "quad_scale":
        feats += [unit(B), unit(B)]
    if kind != "pair_temp":
        feats.append(np.asarray(4.6, np.float32))
    return feats


@pytest.mark.parametrize("name", sorted(losses.LOSS_REGISTRY))
def test_loss_value_and_grads_match_jax(jax_losses, name):
    import jax
    import jax.numpy as jnp

    args = _features(name, seed=sorted(losses.LOSS_REGISTRY).index(name))
    jax_fn = jax_losses.build_loss_fn(name, **STATIC.get(name, {}))
    fn = losses.build_loss_fn(name, **STATIC.get(name, {}))
    assert fn.signature_kind == jax_fn.signature_kind == losses.LOSS_REGISTRY[name][1]

    argnums = tuple(range(len(args)))
    want, want_grads = jax.value_and_grad(jax_fn, argnums=argnums)(*map(jnp.asarray, args))
    tensors = [torch.from_numpy(np.array(a)).requires_grad_() for a in args]
    got = fn(*tensors)
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=RTOL)
    for i, (t, w) in enumerate(zip(tensors, want_grads)):
        # an input the loss ignores (img_feat of the vs_vc / vsc losses) gets
        # no gradient in torch and zeros in JAX
        g = t.grad.numpy() if t.grad is not None else np.zeros_like(t.detach().numpy())
        np.testing.assert_allclose(g, np.asarray(w), rtol=RTOL, atol=ATOL, err_msg=f"arg {i}")


def test_learnable_temp_promotes_bf16_similarity_to_fp32(jax_losses):
    """bf16 features times an fp32 exp(logit_scale): JAX computes the scaled
    similarity in fp32, and so must the port (torch would keep bf16 for a
    0-d tensor)."""
    import jax.numpy as jnp

    vis, txt, scale = _features("NCELearnableTempLoss", seed=42)
    want = jax_losses.nce_learnable_temp(
        jnp.asarray(vis, jnp.bfloat16), jnp.asarray(txt, jnp.bfloat16), jnp.asarray(scale)
    )
    got = losses.nce_learnable_temp(
        torch.from_numpy(vis).bfloat16(), torch.from_numpy(txt).bfloat16(), torch.from_numpy(scale)
    )
    # same bf16 products, fp32 from the scale on: only summation order differs
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-5)


def test_unknown_loss_raises():
    with pytest.raises(KeyError, match="unknown loss"):
        losses.build_loss_fn("NoSuchLoss")
