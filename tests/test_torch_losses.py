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


# -- masked-modeling and matching losses (LF-VILA) ---------------------------

MASKED_RTOL = 1e-6


def _logits_and_labels(seed, rows=12, classes=7, ignored=0.3):
    rng = np.random.default_rng(seed)
    logits = (3 * rng.normal(size=(rows, classes))).astype(np.float32)
    labels = rng.integers(0, classes, size=rows)
    return logits, np.where(rng.random(rows) < ignored, -100, labels)


def _mtc_inputs(seed=0, b=5, m=4, c=16):
    rng = np.random.default_rng(seed)

    def unit():
        x = rng.normal(size=(b, m, c)).astype(np.float32)
        return x / np.linalg.norm(x, axis=-1, keepdims=True)

    # row 0: key 1 between values 0 and 2 (a first-vs-last tie, label -100);
    # the others random prefixes of permutations
    perm = np.stack([rng.permutation(m) for _ in range(3 * b)])
    key, value, other = perm[:b, :2], perm[b:2 * b, :2], perm[2 * b:, 0]
    key[0], value[0] = [1, 3], [0, 2]
    return unit(), unit(), (key, value, other)


MASKED_CASES = {
    "mlm_loss": lambda: (lambda x, y: (x.reshape(3, 4, 7), y.reshape(3, 4)))(*_logits_and_labels(0)),
    "mlm_loss_all_ignored": lambda: (_logits_and_labels(1)[0], np.full(12, -100)),
    "itm_loss": lambda: (_logits_and_labels(2, classes=2)[0], np.random.default_rng(2).integers(0, 2, 12)),
    "label_smoothing_xent": lambda: (_logits_and_labels(3)[0], np.random.default_rng(3).integers(0, 7, 12)),
    "_masked_xent_flat": lambda: _logits_and_labels(4),
}


@pytest.mark.parametrize("name", sorted(MASKED_CASES))
def test_masked_losses_match_jax(jax_losses, name):
    """fp32 logits, -100 rows ignored with a max(count, 1) denominator (0
    when every row is ignored); value to 1e-6 relative, gradients as above."""
    import jax
    import jax.numpy as jnp

    logits, labels = MASKED_CASES[name]()
    fn = name.removesuffix("_all_ignored")
    want, want_grad = jax.value_and_grad(getattr(jax_losses, fn))(jnp.asarray(logits), jnp.asarray(labels))
    t = torch.from_numpy(logits).requires_grad_()
    got = getattr(losses, fn)(t, torch.from_numpy(labels))
    got.backward()
    assert got.dtype == torch.float32 and got.dim() == 0
    np.testing.assert_allclose(got.item(), float(want), rtol=MASKED_RTOL, atol=0 if float(want) else 1e-12)
    np.testing.assert_allclose(t.grad.numpy(), np.asarray(want_grad), rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("num_other_neg", [3, 0])
def test_mtc_loss_matches_jax_with_explicit_indices(jax_losses, num_other_neg):
    """The same clips (a first-vs-last tie among them) give JAX's loss and
    gradients; the rolled negatives include shift 0, the sample itself."""
    import jax
    import jax.numpy as jnp

    video, text, (key, value, other) = _mtc_inputs()
    kw = dict(num_key=2, num_value=2, num_other_neg=num_other_neg, temp=0.05)
    jax_fn = lambda v, t: jax_losses.mtc_loss(v, t, jax.random.PRNGKey(0),  # noqa: E731
                                              indices=(jnp.asarray(key), jnp.asarray(value), jnp.asarray(other)), **kw)
    want, want_grads = jax.value_and_grad(jax_fn, argnums=(0, 1))(jnp.asarray(video), jnp.asarray(text))
    tensors = [torch.from_numpy(a).requires_grad_() for a in (video, text)]
    got = losses.mtc_loss(*tensors, indices=(key, value, other), **kw)
    got.backward()
    np.testing.assert_allclose(got.item(), float(want), rtol=MASKED_RTOL)
    for t, w in zip(tensors, want_grads):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), rtol=RTOL, atol=ATOL)


def test_mtc_loss_draws_its_clips_from_the_generator():
    """Without indices: distinct clips per row (prefixes of permutations),
    the same seed the same loss, another seed (almost surely) another."""
    video, text, _ = _mtc_inputs(seed=1, b=8, m=6)
    perms = losses.mtc_permutations(64, 6, 4, torch.Generator().manual_seed(0))
    assert perms.shape == (64, 4) and all(len(set(row.tolist())) == 4 for row in perms)
    assert perms.min() >= 0 and perms.max() < 6
    run = lambda seed: losses.mtc_loss(torch.from_numpy(video), torch.from_numpy(text),  # noqa: E731
                                       torch.Generator().manual_seed(seed)).item()
    assert run(1) == run(1) and np.isfinite(run(1)) and len({run(s) for s in range(5)}) > 1
