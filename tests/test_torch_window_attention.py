"""Port parity: window attention (``xpretrain_tpu_torch/ops/window_attention.py``)
against the JAX package's XLA path and its Pallas kernel in interpret mode,
as ``tests/test_window_attention.py`` runs it.

The JAX reference is imported inside a fixture, so that on a machine without
JAX the CUDA-gated cases below still collect and run:
``python -m pytest tests/test_torch_window_attention.py -m cuda --noconftest``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from _xpt_ops import xpt_ops_on_cpu  # noqa: E402

from xpretrain_tpu_torch.ops import window_attention as wa  # noqa: E402
from xpretrain_tpu_torch.ops.window_attention import (  # noqa: E402
    window_attention,
    window_attention_plain,
)

# fp32 on the CPU: the same math in another summation order (N <= 120 terms)
ATOL = 2e-5

# name -> (Bn, H, N, d, nW); nW = 0: no mask
CASES = {
    "masked": (6, 2, 30, 16, 3),
    "unmasked": (6, 2, 30, 16, 0),
    "n120_d32_masked": (4, 2, 120, 32, 2),
    "n77_d64_one_window": (3, 3, 77, 64, 1),
}


@pytest.fixture(autouse=True)
def _ops_take_cpu_tensors():
    """The CUDA branch's wiring runs here on CPU tensors, its launch replaced
    by the plain version: the ``xpt::`` ops take the CPU for each test."""
    with xpt_ops_on_cpu():
        yield


@pytest.fixture(scope="module")
def jax_ref():
    return pytest.importorskip("xpretrain_tpu.ops.window_attention")


def _inputs(Bn, H, N, d, nW, seed=0):
    """q, k, v, bias and a random -100 mask (None for nW = 0), as numpy."""
    rng = np.random.default_rng(seed)
    q, k, v = (rng.normal(size=(Bn, H, N, d)).astype(np.float32) for _ in range(3))
    bias = rng.normal(size=(H, N, N)).astype(np.float32)
    mask = None
    if nW:
        mask = np.where(rng.random((nW, N, N)) < 0.2, -100.0, 0.0).astype(np.float32)
    return q, k, v, bias, mask


def _torch(*arrays):
    return [None if a is None else torch.from_numpy(a) for a in arrays]


def _jax(*arrays):
    import jax.numpy as jnp

    return [None if a is None else jnp.asarray(a) for a in arrays]


def _grouped_inputs(seed=0):
    """Stage-0 style grouped windows: G=4 windows of N=30 tokens under the
    block-diagonal bias and the -100 grouped shifted-window mask, as
    ``WindowAttention3D`` builds them, and the same windows ungrouped."""
    from xpretrain_tpu_torch.models.lf_vila.swin3d import (
        grouped_window_mask,
        relative_position_index,
        shifted_window_mask,
    )

    dims, window, shift, G = (4, 6, 20), (2, 3, 5), (0, 1, 2), 4
    N, H, d = 30, 2, 16
    nW = (dims[0] // 2) * (dims[1] // 3) * (dims[2] // 5)
    rng = np.random.default_rng(seed)
    table = rng.normal(size=(3 * 5 * 9, H)).astype(np.float32)
    bias = table[relative_position_index(window).reshape(-1)].reshape(N, N, H).transpose(2, 0, 1)
    q, k, v = (rng.normal(size=(2 * nW, H, N, d)).astype(np.float32) for _ in range(3))

    def group(x):  # [B*nW, H, N, d] -> [B*nW/G, H, G*N, d]
        return x.reshape(-1, G, H, N, d).transpose(0, 2, 1, 3, 4).reshape(-1, H, G * N, d)

    grouped_bias = np.einsum("gk,hij->hgikj", np.eye(G, dtype=np.float32), bias).reshape(H, G * N, G * N)
    ungrouped = (q, k, v, np.ascontiguousarray(bias), np.array(shifted_window_mask(dims, window, shift)))
    grouped = (group(q), group(k), group(v), grouped_bias, np.array(grouped_window_mask(dims, window, shift, G)))
    return ungrouped, grouped, group


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_jax_xla_path(jax_ref, case):
    q, k, v, bias, mask = _inputs(*CASES[case])
    want = jax_ref.window_attention_xla(*_jax(q, k, v, bias, mask))
    got = window_attention_plain(*_torch(q, k, v, bias, mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


@pytest.mark.parametrize("case", CASES)
def test_plain_matches_pallas_interpret(jax_ref, case):
    q, k, v, bias, mask = _inputs(*CASES[case], seed=1)
    want = jax_ref.window_attention_pallas(*_jax(q, k, v, bias, mask), interpret=True)
    got = window_attention(*_torch(q, k, v, bias, mask))  # the CPU dispatch
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=ATOL, rtol=0)


def test_grouped_matches_jax_and_equals_ungrouped(jax_ref):
    """The grouped form (block-diagonal bias, -100 off-block) against the
    JAX XLA path and the Pallas kernel in interpret mode, and against the
    same windows attended one by one."""
    ungrouped, grouped, group = _grouped_inputs()
    got = window_attention(*_torch(*grouped))
    np.testing.assert_allclose(got.numpy(), np.asarray(jax_ref.window_attention_xla(*_jax(*grouped))),
                               atol=ATOL, rtol=0)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(jax_ref.window_attention_pallas(*_jax(*grouped), interpret=True)),
        atol=ATOL, rtol=0,
    )
    one_by_one = window_attention(*_torch(*ungrouped)).numpy()
    np.testing.assert_allclose(got.numpy(), group(one_by_one), atol=ATOL, rtol=0)


def test_cpu_path_keeps_autograd(jax_ref):
    """On the CPU the plain version runs under autograd; its gradients match
    jax.grad of the XLA path."""
    import jax
    import jax.numpy as jnp

    q, k, v, bias, mask = _inputs(*CASES["masked"], seed=2)

    def loss_jax(q, k, v, bias):
        out = jax_ref.window_attention_xla(q, k, v, bias, jnp.asarray(mask))
        return jnp.sum(out * jnp.cos(out))

    want = jax.grad(loss_jax, argnums=(0, 1, 2, 3))(*_jax(q, k, v, bias))
    leaves = [t.requires_grad_() for t in _torch(q, k, v, bias)]
    out = window_attention(*leaves, torch.from_numpy(mask))
    (out * torch.cos(out)).sum().backward()
    for t, w, name in zip(leaves, want, ("q", "k", "v", "bias")):
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(w), atol=ATOL, err_msg=f"d{name}")


def test_cpu_dispatch_launches_no_kernel(monkeypatch):
    monkeypatch.setattr(window_attention, "launches", 0)
    window_attention(*_torch(*_inputs(*CASES["masked"])))
    assert window_attention.launches == 0


def _fake_launch(q, k, v, bias, mask, out, handed=None):
    """The kernel's launch, replaced by its plain version (CPU tensors): q/k/v
    as views with a unit stride on d, bias, mask and the output contiguous."""
    assert all(t.stride(-1) == 1 for t in (q, k, v))
    assert all(t.is_contiguous() for t in (bias, out))
    assert mask is None or mask.is_contiguous()
    if handed is not None:
        handed.append((q, k, v))
    out.copy_(window_attention_plain(q, k, v, bias, mask))


def _qkv_views(q, k, v):
    """q, k, v as the model hands them over: views of one fused [Bn, N, 3, H, d]
    projection, (batch, head, row) strides (N*3*H*d, d, 3*H*d)."""
    qkv = torch.stack([q, k, v]).permute(1, 3, 0, 2, 4).contiguous()  # [Bn, N, 3, H, d]
    return qkv.permute(2, 0, 3, 1, 4)


def test_kernel_path_wiring_with_the_launch_replaced(monkeypatch):
    """The CUDA branch (``_launch``) on CPU tensors with the launch replaced
    by the plain version: strided q/k/v (views of a fused qkv projection)
    reach it as they are, not copied, the result is the plain one, and each
    call counts one launch."""
    handed = []
    monkeypatch.setattr(wa._kernels, "window_attention_fwd",
                        lambda *args: _fake_launch(*args, handed=handed))
    monkeypatch.setattr(window_attention, "launches", 0)
    Bn, H, N, d, nW = CASES["n120_d32_masked"]
    q, k, v, bias, mask = _torch(*_inputs(Bn, H, N, d, nW, seed=3))
    views = _qkv_views(q, k, v)
    assert not views[0].is_contiguous()
    got = wa._launch(views[0], views[1], views[2], bias.transpose(1, 2).transpose(1, 2), mask)
    torch.testing.assert_close(got, window_attention_plain(q, k, v, bias, mask), atol=0, rtol=0)
    assert window_attention.launches == 1
    for seen, view in zip(handed[0], views):
        assert seen.data_ptr() == view.data_ptr() and seen.stride() == view.stride()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_kernel_path_takes_the_model_views_in_both_dtypes(monkeypatch, dtype):
    """The fused-qkv views of the LF-VILA stage-3 layout (H=16, d=32: row
    stride 1536, head stride 32 elements, 16-byte aligned in bf16) pass the
    kernel's checks in both dtypes and come out as the plain version of the
    same data."""
    monkeypatch.setattr(wa._kernels, "window_attention_fwd", _fake_launch)
    monkeypatch.setattr(window_attention, "launches", 0)
    dt = getattr(torch, dtype)
    q, k, v, bias, mask = _torch(*_inputs(4, 16, 24, 32, 2, seed=5))
    views = _qkv_views(*(t.to(dt) for t in (q, k, v)))
    assert views[1].stride() == (24 * 3 * 16 * 32, 32, 3 * 16 * 32, 1)
    got = wa._launch(views[0], views[1], views[2], bias, mask)
    assert got.dtype == dt and got.is_contiguous()
    torch.testing.assert_close(got, window_attention_plain(*(t.contiguous() for t in views), bias, mask),
                               atol=0, rtol=0)


def _misaligned(shape, dtype=torch.bfloat16):
    """A contiguous tensor whose data starts one element past a 16-byte boundary."""
    n = int(np.prod(shape))
    return torch.zeros(n + 8, dtype=dtype)[1:n + 1].view(shape)


@pytest.mark.parametrize(
    "make,match",
    [
        (lambda: _misaligned((6, 2, 30, 16)), "16-byte aligned"),
        # a [Bn, H, N, d] view whose rows are 20 elements apart
        (lambda: torch.zeros(6, 2, 30, 20, dtype=torch.bfloat16)[..., :16], "multiples of 8"),
        (lambda: torch.zeros(6, 2, 30, 20, dtype=torch.bfloat16)[..., 4:], "16-byte aligned|multiples of 8"),
        # d not contiguous
        (lambda: torch.zeros(6, 2, 16, 30, dtype=torch.bfloat16).transpose(2, 3), "unit stride"),
        (lambda: torch.zeros(6, 2, 16, 30).transpose(2, 3), "unit stride"),
    ],
)
def test_kernel_path_refuses_views_the_kernel_cannot_read(monkeypatch, make, match):
    """The bf16 kernel stages q/k/v with 16-byte ``cp.async``: a view that is
    not 16-byte aligned or whose strides are not multiples of 8 elements
    raises before any launch, as does a view (either dtype) whose d is not
    contiguous; nothing is copied to make it fit."""
    monkeypatch.setattr(wa._kernels, "window_attention_fwd", _fake_launch)
    monkeypatch.setattr(window_attention, "launches", 0)
    bad = make()
    good = torch.zeros(bad.shape, dtype=bad.dtype)
    bias = torch.zeros(2, 30, 30)
    for args in ((bad, good, good), (good, good, bad)):
        with pytest.raises(ValueError, match=match):
            wa._launch(*args, bias, None)
    assert window_attention.launches == 0


def test_fp32_kernel_path_takes_unaligned_views(monkeypatch):
    """fp32 views are read element by element by the CUDA-core kernel: an
    unaligned one is taken as it is."""
    monkeypatch.setattr(wa._kernels, "window_attention_fwd", _fake_launch)
    monkeypatch.setattr(window_attention, "launches", 0)
    q = _misaligned((6, 2, 30, 16), torch.float32)
    assert q.data_ptr() % 16
    wa._launch(q, q, q, torch.zeros(2, 30, 30), None)
    assert window_attention.launches == 1


def test_kernel_path_raises_when_a_gradient_is_needed(monkeypatch):
    """The kernel has no backward yet: under autograd the CUDA branch raises,
    naming the training slice, and launches nothing; without a gradient it
    runs."""
    monkeypatch.setattr(wa._kernels, "window_attention_fwd", _fake_launch)
    monkeypatch.setattr(window_attention, "launches", 0)
    q, k, v, bias, mask = _torch(*_inputs(*CASES["masked"], seed=4))
    for leaf in (q, bias):
        args = [q, k, v, bias, mask]
        args[[0, 3][leaf is bias]] = leaf.clone().requires_grad_()
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            wa._launch(*args)
        with torch.no_grad():
            wa._launch(*args)
    assert window_attention.launches == 2


@pytest.mark.parametrize(
    "mutate,error",
    [
        (lambda q, k, v, b, m: (q, k, v, b[:, :-1], m), ValueError),  # bias not [H, N, N]
        (lambda q, k, v, b, m: (q, k, v, b, torch.cat([m, m[:1]])), ValueError),  # nW=4 does not divide Bn=6
        (lambda q, k, v, b, m: (q, k[:1], v, b, m), ValueError),  # shapes differ
        (lambda q, k, v, b, m: (q, k.double(), v, b, m), TypeError),  # dtypes differ
    ],
)
def test_wrapper_rejects_bad_inputs(mutate, error):
    args = mutate(*_torch(*_inputs(*CASES["masked"])))
    with pytest.raises(error):
        window_attention(*args)


def _card_inputs(Bn, H, N, d, nW, dtype, seed=0):
    q, k, v, bias, mask = _inputs(Bn, H, N, d, nW, seed=seed)
    dev = [torch.from_numpy(x).to("cuda", dtype) for x in (q, k, v)]
    return dev + [torch.from_numpy(bias).cuda(), None if mask is None else torch.from_numpy(mask).cuda()]


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5), ("bfloat16", 2e-2)])
@pytest.mark.parametrize(
    "shape",
    list(CASES.values()) + [(64, 16, 240, 32, 8), (8, 32, 480, 32, 0), (32, 4, 120, 32, 16), (5, 2, 200, 128, 5),
                            (6, 3, 77, 16, 3), (4, 2, 96, 48, 2), (4, 2, 64, 80, 0), (3, 2, 70, 96, 1),
                            (2, 2, 48, 112, 2)],
)
def test_kernel_matches_plain_on_card(dtype, atol, shape):
    """The LF-VILA stage shapes (N=240 masked, 480, grouped 120), tails of a
    64-row tile (N = 77 at d = 16) and d = 16..128; bf16 also within one ulp
    of the fp32 plain version of the same inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, k, v, bias, mask = _card_inputs(*shape, dt)
    before = window_attention.launches
    got = window_attention(q, k, v, bias, mask)
    torch.cuda.synchronize()
    assert window_attention.launches == before + 1
    want = window_attention_plain(q, k, v, bias, mask)
    assert got.dtype == dt and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= atol
    if dt == torch.bfloat16:
        exact = window_attention_plain(q.float(), k.float(), v.float(), bias, mask)
        ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2.0**-8))) - 7)
        assert ((got.float() - exact) / ulp).abs().max().item() <= 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape", [(8, 16, 240, 32, 8), (8, 4, 120, 32, 4), (6, 3, 77, 16, 3)])
def test_kernel_reads_the_model_views_on_card(dtype, shape):
    """q/k/v as views of one fused qkv projection (what the model passes):
    read in place, bit-equal to the call on contiguous copies, within the
    bars of the plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    dt = getattr(torch, dtype)
    q, k, v, bias, mask = _card_inputs(*shape, dt, seed=6)
    views = _qkv_views(q, k, v)
    assert not views[0].is_contiguous()
    got = window_attention(*views, bias, mask)
    assert torch.equal(got, window_attention(q, k, v, bias, mask))
    exact = window_attention_plain(q.float(), k.float(), v.float(), bias, mask)
    if dt == torch.float32:
        assert (got - exact).abs().max().item() <= 2e-5
    else:
        ulp = torch.exp2(torch.floor(torch.log2(exact.abs().clamp_min(2.0**-8))) - 7)
        assert ((got.float() - exact) / ulp).abs().max().item() <= 1.0


@pytest.mark.cuda
def test_kernel_path_raises_instead_of_falling_back_on_card():
    """A gradient on the card raises (no backward kernel yet); inputs the
    kernel does not take raise."""
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")
    q, k, v, bias, mask = _card_inputs(*CASES["masked"], torch.float32)
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        window_attention(q.clone().requires_grad_(), k, v, bias, mask)
    with pytest.raises(TypeError):
        window_attention(q.half(), k.half(), v.half(), bias, mask)
    with pytest.raises(ValueError, match="head dim"):
        window_attention(q[..., :8], k[..., :8], v[..., :8], bias, mask)
    with pytest.raises(ValueError, match="16-byte aligned|multiples of 8"):
        wide = torch.zeros(*q.shape[:3], 20, device="cuda", dtype=torch.bfloat16)[..., :16]
        window_attention(wide, wide, wide, bias, mask)


# -- the bf16 tensor-core kernel's numerics -----------------------------------

LOG2E = np.float32(1.4426950408889634)


def _split(x):
    """fp32 x as the two bf16 terms the kernel feeds a product: hi = bf16(x),
    lo = bf16(x - hi), each returned as fp32."""
    hi = x.to(torch.bfloat16).float()
    return hi, (x - hi).to(torch.bfloat16).float()


def _emulate_window(q, k, v, bm, split=True):
    """The bf16 window kernel's rounding points for one (window, head), q/k/v
    [N, d] fp32 holding bf16 values and bm [N, N] = bias + mask (fp32): fp32
    scores that start as bm / scale, plus Q K^T, times scale (so
    Q K^T scale + bm) in the log2 domain; an online softmax over the kernel's
    64-key tiles in key order; P entering PV as hi + lo bf16 terms (or
    rounded once, ``split=False``); fp32 sums and one bf16 rounding at the
    store. Returns the output as fp32."""
    N, d = q.shape
    scale = np.float32(d**-0.5)
    m = torch.full((N,), -float("inf"))
    l, acc = torch.zeros(N), torch.zeros(N, d)
    for keys in torch.arange(N).split(64):
        s = (bm[:, keys] * (np.float32(1) / scale) + q @ k[keys].T) * (scale * LOG2E)
        mn = torch.maximum(m, s.max(dim=1).values)
        corr = torch.exp2(m - mn)
        p = torch.exp2(s - mn[:, None])
        l = l * corr + p.sum(dim=1)
        if split:
            hi, lo = _split(p)
            pv = hi @ v[keys] + lo @ v[keys]
        else:
            pv = p.to(torch.bfloat16).float() @ v[keys]
        acc = acc * corr[:, None] + pv
        m = mn
    return (acc * (1 / l)[:, None]).to(torch.bfloat16).float()


def _s3_shifted_head(seed, window):
    """bf16-exact q, k, v [240, 32] of one (window, head) of LF-VILA's stage-3
    shifted block at b=8 (``chip_smoke.py``'s ``s3_shifted``), a random bias
    [240, 240] and that window's shifted-window mask, as fp32."""
    from xpretrain_tpu_torch.models.lf_vila.swin3d import shifted_window_mask

    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.normal(size=(240, 32)).astype(np.float32)).to(torch.bfloat16).float()
               for _ in range(3))
    bias = torch.from_numpy(rng.normal(size=(240, 240)).astype(np.float32))
    mask = torch.from_numpy(np.array(shifted_window_mask((32, 6, 10), (16, 3, 5), (0, 1, 2)))[window])
    return q, k, v, bias, mask


def _ulps(got, want):
    """``chip_smoke.bf16_ulps``: largest |got - want| in bf16 ulps of want;
    |want| below 2^-8 counts as 2^-8."""
    ulp = torch.exp2(torch.floor(torch.log2(want.abs().clamp_min(2.0**-8))) - 7)
    return ((got - want) / ulp).abs().max().item()


@pytest.mark.parametrize("seed,window", [(30, 0), (31, 5), (32, 7)])
def test_kernel_rounding_points_meet_the_chip_bar(seed, window):
    """With the bf16 kernel's rounding points at the ``s3_shifted`` shape (a
    few (window, head) pairs, the shifted-window mask of their window): <= 1
    bf16 ulp (``BF16_MAX_ULP``) of the fp32 plain version."""
    q, k, v, bias, mask = _s3_shifted_head(seed, window)
    got = _emulate_window(q, k, v, bias + mask)
    want = window_attention_plain(q[None, None], k[None, None], v[None, None], bias[None], mask[None])[0, 0]
    assert _ulps(got, want) <= 1.0


def test_one_bf16_rounding_of_p_misses_the_window_bar():
    """The emulation can fail: P rounded once to bf16 before PV (what the
    plain bf16 path and SDPA do) lands beyond 1 ulp of the fp32 plain version
    at the ``s3_shifted`` shape, which is why the kernel splits it."""
    q, k, v, bias, mask = _s3_shifted_head(30, 0)
    got = _emulate_window(q, k, v, bias + mask, split=False)
    want = window_attention_plain(q[None, None], k[None, None], v[None, None], bias[None], mask[None])[0, 0]
    assert _ulps(got, want) > 8.0
