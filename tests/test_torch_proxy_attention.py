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


# -- the packed [B, S, H*D] entry (``proxy_flash_attention_packed``) ---------

# the JAX packed test's sizes: (M, N, L, D), H, B
PACKED = (3, 4, 13, 16)
PACKED_H, PACKED_B = 2, 2


def _packed(M, N, L, D, seed, n=3, b=PACKED_B, h=PACKED_H):
    rng = np.random.default_rng(seed)
    return [rng.normal(size=(b, M + N * L, h * D)).astype(np.float32) for _ in range(n)]


def test_packed_plain_matches_jax_pallas_interpret(jax_ref):
    """Forward within 1e-5 and gradients within 2e-5 of
    ``proxy_flash_attention_packed(..., interpret=True)`` (the bars of
    ``tests/test_proxy_attention.py``); the gradient through autograd of the
    CPU path and :func:`proxy_attention_packed_bwd` both."""
    import jax.numpy as jnp

    M, N, L, D = PACKED
    q, k, v, d_out = _packed(M, N, L, D, seed=10, n=4)

    def jax_fn(q, k, v):
        return jax_ref.proxy_flash_attention_packed(q, k, v, M, N, L, D**-0.5, D, interpret=True)

    want = jax_fn(*map(jnp.asarray, (q, k, v)))
    want_grads = _jax_vjp(jax_fn, q, k, v, d_out)
    leaves = [torch.from_numpy(x).requires_grad_() for x in (q, k, v)]
    got = pa.proxy_attention_packed(*leaves, M, N, L, D**-0.5, D)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=1e-5, rtol=0)
    got.backward(torch.from_numpy(d_out))
    direct = pa.proxy_attention_packed_bwd(*map(torch.from_numpy, (q, k, v, d_out)), M, N, L, D**-0.5, D)
    for t, g, w, name in zip(leaves, direct, want_grads, "qkv"):
        np.testing.assert_allclose(t.grad.numpy(), w, atol=GRAD_ATOL, rtol=0, err_msg=f"autograd d{name}")
        np.testing.assert_allclose(g.numpy(), w, atol=GRAD_ATOL, rtol=0, err_msg=f"direct d{name}")


def test_packed_plain_matches_jax_fallback_path(jax_ref):
    """``use_pallas=False``: the JAX split, ``_attention_xla``, merge."""
    import jax.numpy as jnp

    M, N, L, D = PACKED
    q, k, v = _packed(M, N, L, D, seed=11)
    want = jax_ref.proxy_flash_attention_packed(*map(jnp.asarray, (q, k, v)), M, N, L, D**-0.5, D, use_pallas=False)
    got = pa.proxy_attention_packed(*map(torch.from_numpy, (q, k, v)), M, N, L, D**-0.5, D)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


def test_packed_is_split_attention_merge():
    """Bit-equal to splitting heads, :func:`proxy_attention`, merging."""
    M, N, L, D = PACKED
    q, k, v = map(torch.from_numpy, _packed(M, N, L, D, seed=12))
    split = [t.view(PACKED_B, -1, PACKED_H, D).transpose(1, 2).contiguous() for t in (q, k, v)]
    want = proxy_attention(*split, M, N, L, D**-0.5).transpose(1, 2).reshape(q.shape)
    torch.testing.assert_close(pa.proxy_attention_packed(q, k, v, M, N, L, D**-0.5, D), want, atol=0, rtol=0)


def _fake_launches(monkeypatch, seen):
    """The two kernel launches replaced by their plain versions, run on the
    [B, H, S, D] views they are handed; records each view's strides."""

    def fwd(q, k, v, out, M, N, L, scale):
        seen.append(("fwd", tuple(t.stride() for t in (q, k, v, out))))
        out.copy_(proxy_attention_plain(q, k, v, M, L, scale))

    def bwd(q, k, v, d_out, dq, dk, dv, lse, delta, M, N, L, scale):
        seen.append(("bwd", tuple(t.stride() for t in (q, k, v, d_out, dq, dk, dv))))
        assert lse.is_contiguous() and lse.shape == q.shape[:3] and delta.shape == q.shape[:3]
        for dst, src in zip((dq, dk, dv), proxy_attention_bwd_plain(q, k, v, d_out, M, L, scale)):
            dst.copy_(src)

    monkeypatch.setattr(pa._kernels, "proxy_attention_fwd", fwd)
    monkeypatch.setattr(pa._kernels, "proxy_attention_bwd", bwd)
    for counter in (pa.proxy_attention, pa.proxy_attention_bwd, pa.proxy_attention_packed,
                    pa.proxy_attention_packed_bwd):
        monkeypatch.setattr(counter, "launches", 0)


def test_packed_autograd_function_wiring(monkeypatch):
    """``_ProxyAttentionPackedFn`` (the CUDA path of the packed entry) on CPU
    tensors with the launches replaced by their plain versions: the kernels
    get head views of the packed tensors (strides (S*E, D, E, 1)); a strided
    output gradient reaches the backward as packed [B, S, E]; gradients come
    back packed and equal autograd of the plain path; only the packed
    counters count, once each."""
    M, N, L, D = PACKED
    seen = []
    _fake_launches(monkeypatch, seen)
    q, k, v = (torch.from_numpy(x).requires_grad_() for x in _packed(M, N, L, D, seed=13))
    B, S, E = q.shape
    w = torch.from_numpy(_packed(M, N, L, D, seed=14, n=1)[0])
    out = pa._ProxyAttentionPackedFn.apply(q, k, v, M, N, L, D**-0.5, D)
    assert out.shape == (B, S, E) and out.is_contiguous()
    # the gradient of a transpose reaches the function non-contiguous
    (out.transpose(0, 1) * w.transpose(0, 1)).sum().backward()
    got = [t.grad.clone() for t in (q, k, v)]
    for t in (q, k, v):
        t.grad = None
    (pa.proxy_attention_packed_plain(q, k, v, M, L, D**-0.5, D) * w).sum().backward()
    for g, t, name in zip(got, (q, k, v), "qkv"):
        assert g.shape == (B, S, E)
        torch.testing.assert_close(g, t.grad, atol=GRAD_ATOL, rtol=0, msg=f"d{name}")
    packed_view = (S * E, D, E, 1)
    assert seen == [("fwd", (packed_view,) * 4), ("bwd", (packed_view,) * 7)]
    assert (pa.proxy_attention_packed.launches, pa.proxy_attention_packed_bwd.launches) == (1, 1)
    assert (pa.proxy_attention.launches, pa.proxy_attention_bwd.launches) == (0, 0)


def test_packed_launch_error_propagates(monkeypatch):
    """A failed launch raises through the autograd function and counts no
    launch; nothing falls back to the plain path."""
    M, N, L, D = PACKED
    _fake_launches(monkeypatch, [])

    def refuse(*args):
        raise RuntimeError("proxy_attention_fwd launch failed: CUDA error 1 (invalid argument)")

    monkeypatch.setattr(pa._kernels, "proxy_attention_fwd", refuse)
    q, k, v = map(torch.from_numpy, _packed(M, N, L, D, seed=15))
    with pytest.raises(RuntimeError, match="launch failed"):
        pa._ProxyAttentionPackedFn.apply(q, k, v, M, N, L, D**-0.5, D)
    monkeypatch.setattr(pa._kernels, "proxy_attention_bwd", refuse)
    with pytest.raises(RuntimeError, match="launch failed"):
        pa._launch_bwd(q, k, v, q, M, N, L, D**-0.5, D)
    assert (pa.proxy_attention_packed.launches, pa.proxy_attention_packed_bwd.launches) == (0, 0)


@pytest.mark.parametrize(
    "mutate,error",
    [
        (lambda q, k, v, hd: ((q[:, :-1], k[:, :-1], v[:, :-1]), hd), ValueError),  # S != M+N*L
        (lambda q, k, v, hd: ((q, k[:1], v), hd), ValueError),  # shapes differ
        (lambda q, k, v, hd: ((q, k.double(), v), hd), TypeError),  # dtypes differ
        (lambda q, k, v, hd: ((q, k, v), hd + 1), ValueError),  # E not a multiple of head_dim
        (lambda q, k, v, hd: ((q[..., None], k[..., None], v[..., None]), hd), ValueError),  # not [B, S, E]
    ],
)
def test_packed_wrapper_rejects_bad_inputs(mutate, error):
    M, N, L, D = PACKED
    (q, k, v), hd = mutate(*map(torch.from_numpy, _packed(M, N, L, D, seed=16)), D)
    with pytest.raises(error):
        pa.proxy_attention_packed(q, k, v, M, N, L, D**-0.5, hd)
    with pytest.raises((error, ValueError)):
        pa.proxy_attention_packed_bwd(q, k, v, q, M, N, L, D**-0.5, hd)


def test_packed_cpu_dispatch_launches_no_kernel():
    M, N, L, D = PACKED
    q, k, v, d_out = map(torch.from_numpy, _packed(M, N, L, D, seed=17, n=4))
    before = (pa.proxy_attention_packed.launches, pa.proxy_attention_packed_bwd.launches)
    pa.proxy_attention_packed(q, k, v, M, N, L, D**-0.5, D)
    pa.proxy_attention_packed_bwd(q, k, v, d_out, M, N, L, D**-0.5, D)
    assert (pa.proxy_attention_packed.launches, pa.proxy_attention_packed_bwd.launches) == before == (0, 0)


def test_cost_matches_jax(jax_ref):
    for args in [(24, 12, 592, 64, 4, 49, 2, False), (32, 12, 592, 64, 4, 49, 2, True), (2, 2, 55, 16, 3, 13, 4, True)]:
        assert pa.proxy_attention_cost(*args) == jax_ref.proxy_attention_cost(*args)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,L,D,H", [(3, 4, 13, 16, 2), (4, 12, 49, 64, 12), (1, 2, 256, 128, 3), (4, 5, 7, 48, 3)])
def test_packed_kernels_equal_the_unpacked_kernels_on_card(dtype, M, N, L, D, H):
    """The packed forward and backward read the packed tensors through their
    head strides and do the [B, H, S, D] kernels' arithmetic: bit-equal to
    them on the same data, and within their bars of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, k, v, d_out = (torch.from_numpy(x).to("cuda", dt) for x in _packed(M, N, L, D, seed=18, n=4, h=H))
    B, S, E = q.shape
    split = [t.view(B, S, H, D).transpose(1, 2).contiguous() for t in (q, k, v, d_out)]
    before = (pa.proxy_attention_packed.launches, pa.proxy_attention_packed_bwd.launches)
    got = pa.proxy_attention_packed(q, k, v, M, N, L, D**-0.5, D)
    grads = pa.proxy_attention_packed_bwd(q, k, v, d_out, M, N, L, D**-0.5, D)
    torch.cuda.synchronize()
    assert (pa.proxy_attention_packed.launches, pa.proxy_attention_packed_bwd.launches) == (before[0] + 1, before[1] + 1)
    merge = lambda t: t.transpose(1, 2).reshape(B, S, E)  # noqa: E731
    assert torch.equal(got, merge(proxy_attention(*split[:3], M, N, L, D**-0.5)))
    for g, w in zip(grads, proxy_attention_bwd(*split, M, N, L, D**-0.5)):
        assert g.shape == (B, S, E) and torch.equal(g, merge(w))
    want = pa.proxy_attention_packed_plain(*(t.float() for t in (q, k, v)), M, L, D**-0.5, D)
    assert (got.float() - want).abs().max().item() <= (2e-5 if dt == torch.float32 else 2e-2)
