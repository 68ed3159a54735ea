"""Port parity: ring attention (``xpretrain_tpu_torch/ops/ring_attention.py``)
against the JAX package's ``make_ring_attention`` and its dense reference
(``tests/test_ring_attention.py``'s), in one process: a ring of one rank,
fp32 on the CPU, at JAX's bars (2e-5 forward, 3e-5 gradients). The rings
of 4 ranks, and of 2 by 2 with a data axis, run in
``tests/test_torch_seq_pipe_expert.py``."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402

from xpretrain_tpu.ops.ring_attention import make_ring_attention as jax_ring  # noqa: E402
from xpretrain_tpu.parallel.mesh import create_mesh  # noqa: E402
from xpretrain_tpu_torch.ops.ring_attention import make_ring_attention, sequence_block  # noqa: E402
from xpretrain_tpu_torch.parallel.mesh import DataMesh  # noqa: E402
from xpretrain_tpu_torch.parallel.p2p import ring_shift  # noqa: E402

B, H, S, D = 2, 4, 48, 16


def _dense(q, k, v, mask=None):
    s = jnp.einsum("bhqd,bhkd->bhqk", q, k).astype(jnp.float32) * D**-0.5
    if mask is not None:
        s = s + ((1.0 - mask.astype(jnp.float32)) * -1e30)[:, None, None, :]
    w = jax.nn.softmax(s, axis=-1)
    return jnp.einsum("bhqk,bhkd->bhqd", w, v.astype(jnp.float32)).astype(q.dtype)


def _inputs(seed=0):
    rng = np.random.default_rng(seed)
    q, k, v, target = (rng.normal(size=(B, H, S, D)).astype(np.float32) for _ in range(4))
    mask = np.ones((B, S), np.int32)
    mask[0, -10:] = 0
    mask[1, -3:] = 0
    return q, k, v, target, mask


def _mesh(size: int, axis: str = "seq") -> DataMesh:
    """A mesh object of ``size`` ranks on ``axis`` at index 0, for the checks
    made before any communication."""
    return DataMesh(rank=0, world_size=1, device=torch.device("cpu"), backend="gloo", model_size=size,
                    model_axis=axis)


@pytest.mark.parametrize("with_mask", [False, True])
def test_ring_of_one_matches_jax(with_mask):
    q, k, v, _, mask = _inputs()
    mask = mask if with_mask else None
    ring = jax_ring(create_mesh((1,), ("seq",), devices=jax.devices()[:1]))
    want = np.asarray(jax.jit(ring)(q, k, v, mask))
    np.testing.assert_allclose(want, np.asarray(_dense(q, k, v, mask)), atol=2e-5)
    fn = make_ring_attention(None)
    got = fn(*(torch.from_numpy(a) for a in (q, k, v)), None if mask is None else torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("with_mask", [False, True])
def test_ring_of_one_gradients_match_jax(with_mask):
    q, k, v, target, mask = _inputs(2)
    mask = mask if with_mask else None

    def dense_loss(args):
        return jnp.mean((_dense(*args, mask) - target) ** 2)

    want_loss, want = jax.jit(jax.value_and_grad(dense_loss))((q, k, v))
    args = [torch.from_numpy(a).requires_grad_(True) for a in (q, k, v)]
    out = make_ring_attention(None)(*args, None if mask is None else torch.from_numpy(mask))
    loss = ((out - torch.from_numpy(target)) ** 2).mean()
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(want_loss), rtol=1e-5)
    for a, w in zip(args, want):
        np.testing.assert_allclose(a.grad.numpy(), np.asarray(w), atol=3e-5, rtol=0)


def test_indivisible_sequence_raises():
    q = torch.zeros(B, H, 42, D)
    with pytest.raises(ValueError, match="not divisible by ring size 8"):
        sequence_block(q, _mesh(8))
    assert sequence_block(torch.zeros(B, H, 48, D), _mesh(8)).shape == (B, H, 6, D)
    assert sequence_block(torch.zeros(B, 48), _mesh(8), dim=1).shape == (B, 6)


def test_a_mesh_without_the_axis_raises():
    with pytest.raises(ValueError, match="no axis 'seq'"):
        make_ring_attention(_mesh(4, axis="pipe"))
    with pytest.raises(ValueError, match="no axis 'seq'"):
        sequence_block(torch.zeros(B, H, 48, D), _mesh(4, axis="expert"))


def test_a_ring_of_one_rank_shifts_nothing():
    t = torch.randn(3, requires_grad=True)
    (out,) = ring_shift((t,), None)
    assert out is t
