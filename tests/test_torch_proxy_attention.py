"""Port parity: proxy attention (``xpretrain_tpu_torch/ops/proxy_attention.py``)
against the JAX package's XLA path and its Pallas kernel in interpret mode.

The JAX reference is imported inside a fixture, so that on a machine without
JAX the CUDA-gated case below still collects and runs:
``python -m pytest tests/test_torch_proxy_attention.py -m cuda --noconftest``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.ops.proxy_attention import (  # noqa: E402
    proxy_attention,
    proxy_attention_plain,
)

# (M, N, L, D): odd L, single proxy, wide head, and the B/32 frame geometry
SHAPES = [(3, 4, 13, 16), (1, 3, 7, 32), (4, 2, 49, 64)]
B, H = 2, 2


@pytest.fixture(scope="module")
def jax_ref():
    return pytest.importorskip("xpretrain_tpu.ops.proxy_attention")


def _qkv(M, N, L, D, seed=0):
    rng = np.random.default_rng(seed)
    shape = (B, H, M + N * L, D)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(3)]


@pytest.mark.parametrize("M,N,L,D", SHAPES)
def test_plain_matches_jax_xla_path(jax_ref, M, N, L, D):
    import jax.numpy as jnp

    q, k, v = _qkv(M, N, L, D)
    want = jax_ref._attention_xla(*map(jnp.asarray, (q, k, v)), M, L, D**-0.5)
    got = proxy_attention_plain(*map(torch.from_numpy, (q, k, v)), M, L, D**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("M,N,L,D", SHAPES)
def test_plain_matches_pallas_interpret(jax_ref, M, N, L, D):
    import jax.numpy as jnp

    q, k, v = _qkv(M, N, L, D, seed=1)
    want = jax_ref.proxy_flash_attention(
        *map(jnp.asarray, (q, k, v)), M, N, L, D**-0.5, interpret=True
    )
    got = proxy_attention(*map(torch.from_numpy, (q, k, v)), M, N, L, D**-0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_plain_gradient_matches_jax(jax_ref):
    """The CPU path keeps autograd; its gradients match jax.grad."""
    import jax
    import jax.numpy as jnp

    M, N, L, D = SHAPES[0]
    q, k, v = _qkv(M, N, L, D, seed=2)

    def loss_jax(q, k, v):
        out = jax_ref._attention_xla(q, k, v, M, L, D**-0.5)
        return jnp.sum(out * jnp.cos(out))

    want = jax.grad(loss_jax, argnums=(0, 1, 2))(*map(jnp.asarray, (q, k, v)))
    tq, tk, tv = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    out = proxy_attention(tq, tk, tv, M, N, L, D**-0.5)
    (out * torch.cos(out)).sum().backward()
    for t, w, name in zip((tq, tk, tv), want, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=2e-5, err_msg=f"d{name}")


def test_patch_isolation():
    """A patch token must be unaffected by patches of OTHER frames."""
    M, N, L, D = SHAPES[0]
    q, k, v = map(torch.from_numpy, _qkv(M, N, L, D))
    out1 = proxy_attention(q, k, v, M, N, L, D**-0.5)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, M + 3 * L :] += 5.0
    v2[:, :, M + 3 * L :] += 5.0
    out2 = proxy_attention(q, k2, v2, M, N, L, D**-0.5)
    f0 = slice(M, M + L)
    np.testing.assert_allclose(out1[:, :, f0].numpy(), out2[:, :, f0].numpy(), atol=1e-6)
    # but the proxies (which see everything) must move
    assert (out1[:, :, :M] - out2[:, :, :M]).abs().max() > 1e-3


def test_cpu_dispatch_launches_no_kernel():
    M, N, L, D = SHAPES[1]
    q, k, v = map(torch.from_numpy, _qkv(M, N, L, D))
    before = proxy_attention.launches
    proxy_attention(q, k, v, M, N, L, D**-0.5)
    assert proxy_attention.launches == before == 0


@pytest.mark.parametrize(
    "mutate,error",
    [
        (lambda q, k, v: (q[:, :, :-1], k[:, :, :-1], v[:, :, :-1]), ValueError),  # S != M+N*L
        (lambda q, k, v: (q, k[:1], v), ValueError),  # shapes differ
        (lambda q, k, v: (q, k.double(), v), TypeError),  # dtypes differ
    ],
)
def test_wrapper_rejects_bad_inputs(mutate, error):
    M, N, L, D = SHAPES[0]
    q, k, v = mutate(*map(torch.from_numpy, _qkv(M, N, L, D)))
    with pytest.raises(error):
        proxy_attention(q, k, v, M, N, L, D**-0.5)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize("M,N,L,D", SHAPES + [(4, 12, 49, 64), (4, 3, 196, 64), (1, 2, 256, 128)])
def test_kernel_matches_plain_on_card(dtype, atol, M, N, L, D):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to("cuda", dt) for x in _qkv(M, N, L, D))
    before = proxy_attention.launches
    got = proxy_attention(q, k, v, M, N, L, D**-0.5)
    torch.cuda.synchronize()
    assert proxy_attention.launches == before + 1
    want = proxy_attention_plain(q, k, v, M, L, D**-0.5)
    assert got.dtype == dt
    assert (got.float() - want.float()).abs().max().item() <= atol
    if dt == torch.bfloat16:
        # Against the fp32 plain version of the same inputs only the kernel's
        # output rounding is left: at most one bf16 ulp of the exact value.
        exact = proxy_attention_plain(q.float(), k.float(), v.float(), M, L, D**-0.5)
        ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2.0**-8))) - 7)
        assert ((got.float() - exact) / ulp).abs().max().item() <= 1.0


@pytest.mark.cuda
def test_kernel_path_raises_instead_of_falling_back():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    M, N, L, D = SHAPES[0]
    q, k, v = (torch.from_numpy(x).cuda() for x in _qkv(M, N, L, D))
    with pytest.raises(RuntimeError, match="backward"):
        proxy_attention(q.requires_grad_(), k, v, M, N, L, D**-0.5)
    with pytest.raises(ValueError, match="contiguous"):
        proxy_attention(q.detach().transpose(1, 2).contiguous().transpose(1, 2), k, v, M, N, L, D**-0.5)
    with pytest.raises(TypeError):
        proxy_attention(q.detach().half(), k.half(), v.half(), M, N, L, D**-0.5)
