"""Port parity: proxy attention (``xpretrain_tpu_torch/ops/proxy_attention.py``)
against the JAX package's XLA path and its Pallas kernel in interpret mode.

The JAX reference is imported inside a fixture, so that on a machine without
JAX the CUDA-gated cases below still collect and run:
``python -m pytest tests/test_torch_proxy_attention.py -m cuda --noconftest``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.ops import proxy_attention as pa  # noqa: E402
from xpretrain_tpu_torch.ops.proxy_attention import (  # noqa: E402
    proxy_attention,
    proxy_attention_bwd,
    proxy_attention_bwd_plain,
    proxy_attention_plain,
)

# (M, N, L, D): odd L, single proxy, wide head, and the B/32 frame geometry
SHAPES = [(3, 4, 13, 16), (1, 3, 7, 32), (4, 2, 49, 64)]
B, H = 2, 2


@pytest.fixture(scope="module")
def jax_ref():
    return pytest.importorskip("xpretrain_tpu.ops.proxy_attention")


def _qkv(M, N, L, D, seed=0, n=3, b=B):
    rng = np.random.default_rng(seed)
    shape = (b, H, M + N * L, D)
    return [rng.normal(size=shape).astype(np.float32) for _ in range(n)]


def _jax_vjp(fn, q, k, v, d_out):
    import jax
    import jax.numpy as jnp

    _, vjp = jax.vjp(fn, *map(jnp.asarray, (q, k, v)))
    return [np.asarray(g) for g in vjp(jnp.asarray(d_out))]


# The backward sums up to S = M + N*L products per entry in fp32, in another
# order than XLA's: 2e-5 absolute covers that at these shapes (|g| <= ~10).
GRAD_ATOL = 2e-5


@pytest.mark.parametrize("M,N,L,D", SHAPES)
def test_bwd_plain_matches_jax_grad_of_xla_path(jax_ref, M, N, L, D):
    q, k, v, d_out = _qkv(M, N, L, D, seed=3, n=4)
    want = _jax_vjp(lambda q, k, v: jax_ref._attention_xla(q, k, v, M, L, D**-0.5), q, k, v, d_out)
    got = proxy_attention_bwd_plain(*map(torch.from_numpy, (q, k, v, d_out)), M, L, D**-0.5)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=0, err_msg=f"d{name}")


@pytest.mark.parametrize("M,N,L,D", SHAPES)
def test_bwd_plain_matches_pallas_interpret_bwd(jax_ref, M, N, L, D):
    """Against ``_attention_pallas_bwd`` run in interpret mode (the custom VJP
    of ``proxy_flash_attention(..., interpret=True)``)."""
    q, k, v, d_out = _qkv(M, N, L, D, seed=4, n=4)
    want = _jax_vjp(
        lambda q, k, v: jax_ref.proxy_flash_attention(q, k, v, M, N, L, D**-0.5, interpret=True),
        q, k, v, d_out,
    )
    got = proxy_attention_bwd(*map(torch.from_numpy, (q, k, v, d_out)), M, N, L, D**-0.5)
    for g, w, name in zip(got, want, "qkv"):
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=0, err_msg=f"d{name}")


def test_bwd_plain_matches_autograd_of_plain_forward():
    """The written-out backward equals torch autograd through the plain
    forward (fp32, the same masked softmax): summation order only."""
    M, N, L, D = SHAPES[2]
    q, k, v, d_out = map(torch.from_numpy, _qkv(M, N, L, D, seed=5, n=4))
    tq, tk, tv = (t.clone().requires_grad_() for t in (q, k, v))
    proxy_attention(tq, tk, tv, M, N, L, D**-0.5).backward(d_out)
    got = proxy_attention_bwd(q, k, v, d_out, M, N, L, D**-0.5)
    for g, t, name in zip(got, (tq, tk, tv), "qkv"):
        torch.testing.assert_close(g, t.grad, atol=GRAD_ATOL, rtol=0, msg=f"d{name}")


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
    q, k, v, d_out = map(torch.from_numpy, _qkv(M, N, L, D, n=4))
    before, before_bwd = proxy_attention.launches, proxy_attention_bwd.launches
    proxy_attention(q, k, v, M, N, L, D**-0.5)
    proxy_attention_bwd(q, k, v, d_out, M, N, L, D**-0.5)
    assert proxy_attention.launches == before == 0
    assert proxy_attention_bwd.launches == before_bwd == 0


def test_autograd_function_wiring(monkeypatch):
    """``_ProxyAttentionFn`` (the CUDA path's autograd) on CPU tensors, with
    the two launches replaced by their plain versions: its gradients equal
    autograd of the plain forward, the head-merge gradient reaches the
    backward contiguous, and each launch counts once."""
    M, N, L, D = SHAPES[0]

    def fwd(q, k, v, out, M, N, L, scale):
        out.copy_(proxy_attention_plain(q, k, v, M, L, scale))

    def bwd(q, k, v, d_out, dq, dk, dv, lse, delta, M, N, L, scale):
        assert d_out.is_contiguous()
        for dst, src in zip((dq, dk, dv), proxy_attention_bwd_plain(q, k, v, d_out, M, L, scale)):
            dst.copy_(src)

    monkeypatch.setattr(pa._kernels, "proxy_attention_fwd", fwd)
    monkeypatch.setattr(pa._kernels, "proxy_attention_bwd", bwd)
    monkeypatch.setattr(pa, "_check_kernel_inputs", lambda q, k, v: None)
    monkeypatch.setattr(pa.proxy_attention, "launches", 0)
    monkeypatch.setattr(pa.proxy_attention_bwd, "launches", 0)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _qkv(M, N, L, D, seed=6))
    w = torch.from_numpy(_qkv(M, N, L, D, seed=7, n=1)[0]).transpose(1, 2).reshape(B, -1, H * D)
    out = pa._ProxyAttentionFn.apply(q, k, v, M, N, L, D**-0.5)
    (out.transpose(1, 2).reshape(B, -1, H * D) * w).sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (proxy_attention_plain(q, k, v, M, L, D**-0.5).transpose(1, 2).reshape(B, -1, H * D) * w).sum().backward()
    for g, t, name in zip(got, (q, k, v), "qkv"):
        torch.testing.assert_close(g, t.grad, atol=GRAD_ATOL, rtol=0, msg=f"d{name}")
    assert (pa.proxy_attention.launches, pa.proxy_attention_bwd.launches) == (1, 1)


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
    with pytest.raises((error, ValueError)):
        proxy_attention_bwd(q, k, v, q, M, N, L, D**-0.5)


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


def _bf16_grad_ulps(got, want):
    """Largest |got - want| in bf16 ulps of ``want`` (fp32); |want| below
    2^-8 max|want| counts at that floor."""
    mag = want.abs().clamp_min(2.0**-8 * want.abs().max().item())
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - want) / ulp).abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,L,D", SHAPES + [(4, 12, 49, 64), (4, 3, 196, 64), (1, 2, 256, 128), (4, 5, 7, 48)])
def test_bwd_kernel_matches_plain_on_card(dtype, M, N, L, D):
    """fp32: <= 1e-4 max abs (summation order over up to S terms). bf16:
    <= 2 bf16 ulps of the fp32 plain gradients of the same inputs (fp32
    accumulation and one rounding at the store)."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, k, v, d_out = (torch.from_numpy(x).to("cuda", dt) for x in _qkv(M, N, L, D, seed=8, n=4))
    before = proxy_attention_bwd.launches
    got = proxy_attention_bwd(q, k, v, d_out, M, N, L, D**-0.5)
    torch.cuda.synchronize()
    assert proxy_attention_bwd.launches == before + 1
    want = proxy_attention_bwd_plain(*(t.float() for t in (q, k, v, d_out)), M, L, D**-0.5)
    for g, w, name in zip(got, want, "qkv"):
        assert g.dtype == dt and g.shape == q.shape, f"d{name}"
        if dt == torch.float32:
            assert (g - w).abs().max().item() <= 1e-4, f"d{name}"
        else:
            assert _bf16_grad_ulps(g, w) <= 2.0, f"d{name}"


@pytest.mark.cuda
def test_bwd_kernel_gradient_equals_autograd_of_plain_forward():
    """gradcheck-style: the kernels' gradients through ``proxy_attention``
    equal autograd through the plain forward, fp32, at the tiny shape."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    M, N, L, D = SHAPES[0]
    q, k, v, d_out = (torch.from_numpy(x).cuda() for x in _qkv(M, N, L, D, seed=9, n=4))
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    proxy_attention(*leaves, M, N, L, D**-0.5).backward(d_out)
    ref = [t.clone().requires_grad_() for t in (q, k, v)]
    proxy_attention_plain(*ref, M, L, D**-0.5).backward(d_out)
    for a, b, name in zip(leaves, ref, "qkv"):
        assert (a.grad - b.grad).abs().max().item() <= 1e-4, f"d{name}"


@pytest.mark.cuda
def test_kernel_path_raises_instead_of_falling_back():
    """A gradient on the card goes through the backward kernel; inputs the
    kernels do not take raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    M, N, L, D = SHAPES[0]
    q, k, v = (torch.from_numpy(x).cuda() for x in _qkv(M, N, L, D))
    before = proxy_attention_bwd.launches
    proxy_attention(q.clone().requires_grad_(), k, v, M, N, L, D**-0.5).sum().backward()
    torch.cuda.synchronize()
    assert proxy_attention_bwd.launches == before + 1
    with pytest.raises(ValueError, match="contiguous"):
        proxy_attention(q.transpose(1, 2).contiguous().transpose(1, 2), k, v, M, N, L, D**-0.5)
    with pytest.raises(ValueError, match="contiguous"):
        proxy_attention_bwd(q, k, v, q.transpose(1, 2).contiguous().transpose(1, 2), M, N, L, D**-0.5)
    with pytest.raises(TypeError):
        proxy_attention(q.half(), k.half(), v.half(), M, N, L, D**-0.5)
