"""Port parity: proxy attention (``xpretrain_tpu_torch/ops/proxy_attention.py``)
against the JAX package's XLA path and its Pallas kernel in interpret mode.

The JAX reference is imported inside a fixture, so that on a machine without
JAX the CUDA-gated cases below still collect and run:
``python -m pytest tests/test_torch_proxy_attention.py -m cuda --noconftest``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _xpt_ops import xpt_ops_on_cpu  # noqa: E402

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


@pytest.fixture(autouse=True)
def _ops_take_cpu_tensors():
    """The CUDA branch's wiring runs here on CPU tensors, its launch replaced
    by the plain version: the ``xpt::`` ops take the CPU for each test."""
    with xpt_ops_on_cpu():
        yield


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

    def fwd(q, k, v, out, lse, M, N, L, scale):
        out.copy_(proxy_attention_plain(q, k, v, M, L, scale))

    def bwd(q, k, v, d_out, dq, dk, dv, lse, delta, lse_given, M, N, L, scale):
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

    def fwd(q, k, v, out, lse, M, N, L, scale):
        seen.append(("fwd", tuple(t.stride() for t in (q, k, v, out))))
        out.copy_(proxy_attention_plain(q, k, v, M, L, scale))
        if lse is not None:
            lse.copy_(pa.proxy_attention_lse_plain(q, k, M, L, scale))

    def bwd(q, k, v, d_out, dq, dk, dv, lse, delta, lse_given, M, N, L, scale):
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


# -- the LSE the forward saves, and the tensor-core kernels' numerics ---------


@pytest.mark.parametrize("M,N,L,D", SHAPES)
def test_lse_plain_matches_jax_logsumexp(jax_ref, M, N, L, D):
    """``proxy_attention_lse_plain`` is ``jax.nn.logsumexp`` of the JAX
    reference's masked scores (``_proxy_bias``), fp32, within 1e-5."""
    import jax
    import jax.numpy as jnp

    q, k = _qkv(M, N, L, D, seed=19, n=2)
    S = q.shape[2]
    scores = jnp.einsum("bhqd,bhkd->bhqk", q, k) * D**-0.5 + jax_ref._proxy_bias(S, M, L)
    want = jax.nn.logsumexp(scores, axis=-1)
    got = pa.proxy_attention_lse_plain(*map(torch.from_numpy, (q, k)), M, L, D**-0.5)
    assert got.dtype == torch.float32 and got.shape == q.shape[:3]
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5, rtol=0)


LOG2E = np.float32(1.4426950408889634)
B32_GEOMETRY = (4, 12, 49, 64)  # (M, N, L, D) of CLIP-ViP B/32


def _split(x):
    """fp32 x as the two bf16 terms the kernels feed a product: hi = bf16(x),
    lo = bf16(x - hi), each returned as fp32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _dot(x, y, split):
    """x @ y with x entering as bf16 terms: two (split) or one (rounded once)."""
    if not split:
        return x.to(torch.bfloat16).float() @ y
    hi, lo = _split(x)
    return hi @ y + lo @ y


def _emulate_fwd(q, k, v, M, L, scale, split=True):
    """The bf16 forward kernel's rounding points for one (b, h), q/k/v [S, D]
    fp32 holding bf16 values: scores in the log2 domain, an online softmax
    over 16-key chunks in the kernel's order (a frame block walks its keys
    [M proxies | own L]; each of the proxy block's four warps takes its own
    chunk of every 64-key tile, and the four are merged in warp order), P
    entering PV as hi + lo bf16 terms, fp32 sums, one bf16 rounding at the
    store. Returns the output (bf16 values as fp32) and the fp32 LSE."""
    S, D = q.shape
    N = (S - M) // L
    c = np.float32(scale) * LOG2E
    out, lse = torch.empty_like(q), torch.empty(S)

    def walk(rows, chunks):
        m = torch.full((len(rows),), -float("inf"))
        l, acc = torch.zeros(len(rows)), torch.zeros(len(rows), D)
        for keys in chunks:
            s = (q[rows] @ k[keys].T) * c
            mn = torch.maximum(m, s.max(dim=1).values)
            base = torch.where(mn == -float("inf"), torch.zeros_like(mn), mn)
            corr = torch.exp2(m - base)
            p = torch.exp2(s - base[:, None])
            l = l * corr + p.sum(dim=1)
            acc = acc * corr[:, None] + _dot(p, v[keys], split)
            m = mn
        return acc, m, l

    for f in range(N):
        rows = torch.arange(M + f * L, M + (f + 1) * L)
        keys = torch.cat([torch.arange(M), rows])
        acc, m, l = walk(rows, keys.split(16))
        out[rows] = (acc * (1 / l)[:, None]).to(torch.bfloat16).float()
        lse[rows] = (m + torch.log2(l)) * np.float32(np.log(2))
    rows = torch.arange(M)
    parts = [walk(rows, [torch.arange(t0 + 16 * w, min(t0 + 16 * w + 16, S)) for t0 in range(0, S, 64)
                         if t0 + 16 * w < S]) for w in range(4)]
    mx = torch.stack([m for _, m, _ in parts]).max(dim=0).values
    weights = [torch.exp2(m - mx) for _, m, _ in parts]
    lsum = sum(l * w for (_, _, l), w in zip(parts, weights))
    acc = sum(a * w[:, None] for (a, _, _), w in zip(parts, weights))
    out[rows] = (acc * (1 / lsum)[:, None]).to(torch.bfloat16).float()
    lse[rows] = (mx + torch.log2(lsum)) * np.float32(np.log(2))
    return out, lse


def _emulate_bwd(q, k, v, d_out, lse, M, L, scale):
    """The bf16 backward kernel's rounding points for one (b, h), given the
    forward's LSE: pass 1 forms P from the LSE and sums delta = rowsum(P dP),
    (P dP) K and P K with P dP and P as hi + lo terms, then dQ = s ((P dP) K -
    delta P K); pass 2 forms dS = P (dP - delta) and sums P^T dO and dS^T Q
    with P and dS as hi + lo terms; one bf16 rounding per output."""
    S, D = q.shape
    N = (S - M) // L
    c = np.float32(scale) * LOG2E
    lse2 = lse * LOG2E
    dq, dk, dv, delta = torch.empty_like(q), torch.empty_like(k), torch.empty_like(v), torch.empty(S)
    frames = [torch.arange(M + f * L, M + (f + 1) * L) for f in range(N)]
    # (fixed rows, the stream they meet): the proxy block, then the frames
    blocks = [(torch.arange(M), torch.arange(S))] + [(r, torch.cat([torch.arange(M), r])) for r in frames]
    for rows, keys in blocks:
        p = torch.exp2((q[rows] @ k[keys].T) * c - lse2[rows, None])
        pdp = p * (d_out[rows] @ v[keys].T)
        delta[rows] = pdp.sum(dim=1)
        a1, a2 = _dot(pdp, k[keys], True), _dot(p, k[keys], True)
        dq[rows] = ((a1 - delta[rows, None] * a2) * scale).to(torch.bfloat16).float()
    for keys, rows in blocks:
        pt = torch.exp2((k[keys] @ q[rows].T) * c - lse2[None, rows])
        dst = pt * ((v[keys] @ d_out[rows].T) - delta[None, rows])
        dv[keys] = _dot(pt, d_out[rows], True).to(torch.bfloat16).float()
        dk[keys] = (_dot(dst, q[rows], True) * scale).to(torch.bfloat16).float()
    return dq, dk, dv


def _out_ulps(got, want):
    """``chip_smoke.bf16_ulps``: largest |got - want| in bf16 ulps of want;
    |want| below 2^-8 counts as 2^-8."""
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0**-8))) - 7)
    return ((got - want) / ulp).abs().max().item()


def _b32_head(seed):
    """bf16-exact q, k, v, dO of one (b, h) of the B/32 train shape, as fp32."""
    M, N, L, D = B32_GEOMETRY
    rng = np.random.default_rng(seed)
    return [torch.from_numpy(rng.normal(size=(M + N * L, D)).astype(np.float32)).to(torch.bfloat16).float()
            for _ in range(4)]


@pytest.mark.parametrize("seed", [20, 21, 22])
def test_kernel_rounding_points_meet_the_chip_bars(seed):
    """With the kernels' rounding points at the B/32 shape, a few (b, h)
    heads: forward <= 1 bf16 ulp (``BF16_MAX_ULP``), gradients <= 2
    (``BWD_MAX_ULP``) of the fp32 plain version, LSE within 1e-5 of
    ``proxy_attention_lse_plain``."""
    M, N, L, D = B32_GEOMETRY
    q, k, v, d_out = _b32_head(seed)
    out, lse = _emulate_fwd(q, k, v, M, L, D**-0.5)
    as4 = lambda t: t[None, None]  # noqa: E731
    assert _out_ulps(out, proxy_attention_plain(as4(q), as4(k), as4(v), M, L, D**-0.5)[0, 0]) <= 1.0
    torch.testing.assert_close(lse, pa.proxy_attention_lse_plain(as4(q), as4(k), M, L, D**-0.5)[0, 0],
                               atol=1e-5, rtol=0)
    got = _emulate_bwd(q, k, v, d_out, lse, M, L, D**-0.5)
    want = proxy_attention_bwd_plain(as4(q), as4(k), as4(v), as4(d_out), M, L, D**-0.5)
    for g, w, name in zip(got, want, "qkv"):
        assert _bf16_grad_ulps(g, w[0, 0]) <= 2.0, f"d{name}"


def test_one_bf16_rounding_of_p_misses_the_forward_bar():
    """The emulation can fail: P rounded once to bf16 before PV (what
    ``_cell_fwd`` and SDPA do) lands far beyond 1 ulp of the fp32 plain
    version at the B/32 shape, which is why the kernels split it."""
    M, N, L, D = B32_GEOMETRY
    q, k, v, _ = _b32_head(20)
    out, _ = _emulate_fwd(q, k, v, M, L, D**-0.5, split=False)
    as4 = lambda t: t[None, None]  # noqa: E731
    assert _out_ulps(out, proxy_attention_plain(as4(q), as4(k), as4(v), M, L, D**-0.5)[0, 0]) > 8.0


def _lse_launches(monkeypatch, calls):
    """The two launches replaced by their plain versions; records what each
    launch was handed: the forward's LSE buffer, the backward's LSE and flag."""

    def fwd(q, k, v, out, lse, M, N, L, scale):
        calls.append(("fwd", lse))
        out.copy_(proxy_attention_plain(q, k, v, M, L, scale))
        if lse is not None:
            lse.copy_(pa.proxy_attention_lse_plain(q, k, M, L, scale))

    def bwd(q, k, v, d_out, dq, dk, dv, lse, delta, lse_given, M, N, L, scale):
        calls.append(("bwd", lse, lse_given))
        for dst, src in zip((dq, dk, dv), proxy_attention_bwd_plain(q, k, v, d_out, M, L, scale)):
            dst.copy_(src)

    monkeypatch.setattr(pa._kernels, "proxy_attention_fwd", fwd)
    monkeypatch.setattr(pa._kernels, "proxy_attention_bwd", bwd)


@pytest.mark.parametrize("packed", [False, True])
def test_autograd_saves_the_forward_lse_for_the_backward(monkeypatch, packed):
    """The autograd functions on CPU tensors with the launches replaced: the
    forward gets an LSE buffer only when an input needs a gradient, and the
    backward gets that very buffer, flagged as given."""
    M, N, L, D = PACKED
    calls = []
    _lse_launches(monkeypatch, calls)
    if packed:
        q, k, v = map(torch.from_numpy, _packed(M, N, L, D, seed=23))
        fn, entry, args = pa._ProxyAttentionPackedFn, pa.proxy_attention_packed, (M, N, L, D**-0.5, D)
    else:
        q, k, v = map(torch.from_numpy, _qkv(M, N, L, D, seed=23))
        fn, entry, args = pa._ProxyAttentionFn, proxy_attention, (M, N, L, D**-0.5)
    fn.apply(q, k, v, *args)
    assert calls == [("fwd", None)]
    calls.clear()
    leaf = k.clone().requires_grad_()
    fn.apply(q, leaf, v, *args).sum().backward()
    (_, saved), (_, handed, given) = calls
    B, S = q.shape[0], M + N * L
    assert saved.shape == (B, PACKED_H if packed else H, S) and saved.dtype == torch.float32
    assert handed is saved and given is True
    ref = k.clone().requires_grad_()
    entry(q, ref, v, *args).sum().backward()  # the CPU path: plain, under autograd
    torch.testing.assert_close(leaf.grad, ref.grad, atol=GRAD_ATOL, rtol=0)


def test_standalone_backward_launch_computes_its_own_lse(monkeypatch):
    """``_launch_bwd`` without an LSE (what ``proxy_attention_bwd`` and
    ``proxy_attention_packed_bwd`` call, with ``_attention_pallas_bwd``'s
    signature) hands the kernel a fresh fp32 [B, H, S] buffer flagged as not
    given; with one it hands that buffer over, flagged as given."""
    M, N, L, D = PACKED
    calls = []
    _lse_launches(monkeypatch, calls)
    q, k, v, d_out = map(torch.from_numpy, _qkv(M, N, L, D, seed=24, n=4))
    pa._launch_bwd(q, k, v, d_out, M, N, L, D**-0.5)
    (_, lse, given), = calls
    assert given is False and lse.shape == q.shape[:3] and lse.dtype == torch.float32 and lse.is_contiguous()
    calls.clear()
    mine = pa.proxy_attention_lse_plain(q, k, M, L, D**-0.5)
    pa._launch_bwd(q, k, v, d_out, M, N, L, D**-0.5, lse=mine)
    assert calls[0][1] is mine and calls[0][2] is True
    pq, pk, pv, pd = map(torch.from_numpy, _packed(M, N, L, D, seed=24, n=4))
    calls.clear()
    pa._launch_bwd(pq, pk, pv, pd, M, N, L, D**-0.5, D)
    assert calls[0][2] is False and calls[0][1].shape == (PACKED_B, PACKED_H, M + N * L)


def _misaligned(shape):
    """A contiguous bf16 tensor whose data starts 2 bytes past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=torch.bfloat16)[1:n + 1].view(shape)


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: _misaligned((2, 2, 55, 16)), "16-byte aligned"),
        # a [B, H, S, D] view whose rows are 20 elements apart
        (lambda: torch.zeros(2, 2, 55, 20, dtype=torch.bfloat16)[..., :16], "multiples of 8"),
        (lambda: torch.zeros(2, 2, 55, 20, dtype=torch.bfloat16)[..., 4:], "16-byte aligned|multiples of 8"),
    ],
)
def test_bf16_launches_check_what_cp_async_needs(monkeypatch, make, match):
    """The bf16 kernels stage tiles with 16-byte ``cp.async``: a launch on a
    view that is not 16-byte aligned, or whose strides are not multiples of 8
    elements, raises before it reaches the kernel; fp32 views are not held to
    it (the CUDA-core kernels load element by element)."""
    M, N, L, D = PACKED
    calls = []
    _lse_launches(monkeypatch, calls)
    bad = make()
    good = torch.zeros(2, 2, M + N * L, D, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match=match):
        pa._launch_fwd(bad, good, good, M, N, L, D**-0.5)
    with pytest.raises(ValueError, match=match):
        pa._launch_bwd(good, good, good, bad, M, N, L, D**-0.5)
    assert calls == []
    pa._check_cp_async(bad.float(), good.float())  # fp32: nothing to check
    pa._check_cp_async(good, good)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,L,D", SHAPES + [(4, 12, 49, 64), (4, 3, 196, 64), (1, 2, 256, 128)])
def test_forward_lse_matches_plain_on_card(dtype, M, N, L, D):
    """The LSE the forward saves is ``proxy_attention_lse_plain`` of the same
    inputs within 1e-5 (fp32 sums in another order), and saving it leaves the
    output's bits alone."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, k, v = (torch.from_numpy(x).to("cuda", dt) for x in _qkv(M, N, L, D, seed=25))
    out, lse = pa._launch_fwd(q, k, v, M, N, L, D**-0.5, with_lse=True)
    torch.cuda.synchronize()
    assert torch.equal(out, proxy_attention(q, k, v, M, N, L, D**-0.5))
    want = pa.proxy_attention_lse_plain(q.float(), k.float(), M, L, D**-0.5)
    assert lse.dtype == torch.float32 and (lse - want).abs().max().item() <= 1e-5


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("M,N,L,D", SHAPES + [(4, 12, 49, 64), (1, 2, 256, 128)])
def test_bwd_on_the_forward_lse_on_card(dtype, M, N, L, D):
    """The backward on the forward's LSE (as autograd runs it): within the
    standalone backward's bars, bit-identical over two calls, and for bf16
    bit-equal to the standalone call, whose LSE pass is the forward's code."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, k, v, d_out = (torch.from_numpy(x).to("cuda", dt) for x in _qkv(M, N, L, D, seed=26, n=4))
    _, lse = pa._launch_fwd(q, k, v, M, N, L, D**-0.5, with_lse=True)
    got = pa._launch_bwd(q, k, v, d_out, M, N, L, D**-0.5, lse=lse)
    again = pa._launch_bwd(q, k, v, d_out, M, N, L, D**-0.5, lse=lse)
    alone = proxy_attention_bwd(q, k, v, d_out, M, N, L, D**-0.5)
    torch.cuda.synchronize()
    want = proxy_attention_bwd_plain(*(t.float() for t in (q, k, v, d_out)), M, L, D**-0.5)
    for g, a, s, w, name in zip(got, again, alone, want, "qkv"):
        assert torch.equal(g, a), f"d{name}"
        if dt == torch.float32:
            assert (g - w).abs().max().item() <= 1e-4, f"d{name}"
        else:
            assert _bf16_grad_ulps(g, w) <= 2.0 and torch.equal(g, s), f"d{name}"
