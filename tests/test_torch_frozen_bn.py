"""HD-VILA's frozen batch norm with its ReLU and residual add
(``xpretrain_tpu_torch/ops/frozen_bn.py``): the plain version against the
module's formula on the CPU, the CUDA branch's autograd wiring on the CPU
with the launches replaced by the plain versions, and the kernels
(``csrc/frozen_bn_act.cu``) against the plain versions on the card.

No JAX here (the module's JAX parity is ``test_torch_hdvila.py``'s), so the
CUDA cases run on the card with
``python -m pytest tests/test_torch_frozen_bn.py -m cuda --noconftest``.
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")
import torch.nn.functional as F  # noqa: E402

from _xpt_ops import xpt_ops_on_cpu  # noqa: E402

from xpretrain_tpu_torch.models.hd_vila.resnet import Bottleneck, FrozenBatchNorm  # noqa: E402
from xpretrain_tpu_torch.ops import _kernels  # noqa: E402
from xpretrain_tpu_torch.ops import frozen_bn as fb  # noqa: E402
from xpretrain_tpu_torch.utils.profiling import counts  # noqa: E402

FORMS = {"affine": (False, False), "relu": (True, False), "relu_identity": (True, True)}
PARAMS = ("scale", "bias", "mean", "var")
CL = torch.channels_last


def _bn(c: int, seed: int, device="cpu") -> FrozenBatchNorm:
    """A FrozenBatchNorm with seeded statistics: scales and shifts of both
    signs, so a ReLU zeroes part of every channel."""
    rng = np.random.default_rng(seed)
    bn = FrozenBatchNorm(c, device=device)
    with torch.no_grad():
        bn.scale.copy_(torch.from_numpy(rng.normal(1.0, 0.5, c).astype(np.float32)))
        bn.bias.copy_(torch.from_numpy(rng.normal(0.0, 0.5, c).astype(np.float32)))
        bn.mean.copy_(torch.from_numpy(rng.normal(0.0, 0.3, c).astype(np.float32)))
        bn.var.copy_(torch.from_numpy(rng.uniform(0.5, 2.0, c).astype(np.float32)))
    return bn


def _maps(shape, seed: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    g = torch.Generator().manual_seed(seed)
    return torch.randn(shape, generator=g).to(device=device, dtype=dtype)


def _formula(bn: FrozenBatchNorm, x, relu: bool, identity):
    """The module's formula before the fusion, then the residual add and
    ``F.relu`` as the blocks applied them."""
    inv = torch.rsqrt(bn.var + bn.eps) * bn.scale
    shift = bn.bias - bn.mean * inv
    out = x * inv.to(x.dtype)[:, None, None] + shift.to(x.dtype)[:, None, None]
    if identity is not None:
        out = out + identity
    return F.relu(out) if relu else out


def _grads(bn: FrozenBatchNorm, leaves, out, g) -> list[torch.Tensor]:
    params = [getattr(bn, name) for name in PARAMS]
    return list(torch.autograd.grad(out, [*leaves, *params], g))


# -- the plain version on the CPU ----------------------------------------------


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("form", FORMS)
def test_plain_with_act_and_identity_is_the_module_formula_then_relu_and_add(form, dtype):
    """On the CPU, ``FrozenBatchNorm(x, relu, identity)`` gives the bits of
    the module's formula followed by the add and ``F.relu``, and the same
    gradients for x, the identity and the four parameters."""
    relu, with_identity = FORMS[form]
    bn = _bn(6, seed=1)
    x = _maps((2, 6, 5, 7), 2, dtype).requires_grad_()
    identity = _maps((2, 6, 5, 7), 3, dtype).requires_grad_() if with_identity else None
    g = _maps((2, 6, 5, 7), 4, dtype)
    leaves = [x] + ([identity] if with_identity else [])
    got = bn(x, relu=relu, identity=identity)
    want = _formula(bn, x, relu, identity)
    assert got.dtype == dtype and torch.equal(got, want)
    for a, b in zip(_grads(bn, leaves, got, g), _grads(bn, leaves, want, g)):
        assert torch.equal(a, b)


def test_wrapper_takes_the_plain_path_on_cpu_and_counts_it():
    """A CPU call computes the plain version, counts one
    ``xpt.frozen_bn.plain`` and no kernel call or launch; a bottleneck makes
    one call per BN (its three and the downsample's)."""
    before, launches = counts(), fb.frozen_bn_act.launches
    x = _maps((1, 4, 3, 3), 0)
    inv, shift = torch.full((4,), 2.0), torch.full((4,), -1.0)
    assert torch.equal(fb.frozen_bn_act(x, inv, shift, relu=True), F.relu(x * 2.0 - 1.0))
    after = counts()
    assert after.get("xpt.frozen_bn.plain", 0) == before.get("xpt.frozen_bn.plain", 0) + 1
    assert after.get("xpt.frozen_bn.kernel", 0) == before.get("xpt.frozen_bn.kernel", 0)
    assert fb.frozen_bn_act.launches == launches
    block = Bottleneck(4, 2, stride=2, downsample=True)
    block(_maps((1, 4, 6, 6), 1))
    assert counts()["xpt.frozen_bn.plain"] == after["xpt.frozen_bn.plain"] + 4


def test_wrapper_refuses_what_the_kernel_does_not_take():
    x = _maps((2, 3, 4, 4), 0)
    with pytest.raises(ValueError, match=r"\[3\]"):
        fb.frozen_bn_act(x, torch.ones(4), torch.zeros(3))
    with pytest.raises(ValueError, match="identity"):
        fb.frozen_bn_act(x, torch.ones(3), torch.zeros(3), identity=x[:1])
    with pytest.raises(ValueError, match="N, C, H, W"):
        fb.frozen_bn_act(x[0], torch.ones(3), torch.zeros(3))
    with pytest.raises(ValueError, match="cpu or cuda"):
        fb.frozen_bn_act(x.to("meta"), torch.ones(3, device="meta"), torch.zeros(3, device="meta"))


@pytest.mark.parametrize("form", FORMS)
def test_bwd_plain_is_autograd_of_the_plain_forward(form):
    """fp32: the backward kernel's reference gives autograd's gradients of
    the plain forward for x, the identity, inv and shift."""
    relu, with_identity = FORMS[form]
    x = _maps((3, 5, 4, 6), 5).requires_grad_()
    identity = _maps((3, 5, 4, 6), 6).requires_grad_() if with_identity else None
    inv, shift = _maps((5,), 7).requires_grad_(), _maps((5,), 8).requires_grad_()
    g = _maps((3, 5, 4, 6), 9)
    y = fb.frozen_bn_act_plain(x, inv, shift, relu, identity)
    leaves = [x, inv, shift] + ([identity] if with_identity else [])
    want = torch.autograd.grad(y, leaves, g)
    dx, d_identity, sums = fb.frozen_bn_act_bwd_plain(g, y.detach() if relu else None, x.detach(), inv.detach(),
                                                      with_identity)
    got = [dx, sums[0], sums[1]] + ([d_identity] if with_identity else [])
    for a, b in zip(got, want):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)
    assert (d_identity is None) == (not with_identity)


# -- the CUDA branch's wiring, on the CPU -------------------------------------------


@pytest.fixture()
def plain_launches(monkeypatch):
    """The ``xpt::frozen_bn_act_*`` ops on CPU tensors, their launches
    replaced by the plain versions writing into the ops' outputs."""

    def fwd(x, identity, inv, shift, y, relu):
        y.copy_(fb.frozen_bn_act_plain(x, inv, shift, relu, identity))

    def bwd(g, y, x, inv, dx, d_identity, sums):
        got = fb.frozen_bn_act_bwd_plain(g, y, x, inv, d_identity is not None)
        for out, value in zip((dx, d_identity, sums), got):
            if out is not None:
                out.copy_(value)

    monkeypatch.setattr(_kernels, "frozen_bn_act_fwd", fwd)
    monkeypatch.setattr(_kernels, "frozen_bn_act_bwd", bwd)
    with xpt_ops_on_cpu():
        yield


@pytest.mark.parametrize("form", FORMS)
def test_kernel_wiring_gives_autograds_gradients(plain_launches, form):
    """fp32 on the CPU, through ``_FrozenBnActFn`` and the two ops: the
    output and the gradients of x, the identity and the four parameters
    equal autograd's through the plain forward (to summation order); the
    forward launches once, the backward twice (with the parameters' sums)."""
    relu, with_identity = FORMS[form]
    bn = _bn(8, seed=11)
    x = _maps((2, 8, 3, 5), 12).contiguous(memory_format=CL).requires_grad_()
    identity = _maps((2, 8, 3, 5), 13).contiguous(memory_format=CL).requires_grad_() if with_identity else None
    g = _maps((2, 8, 3, 5), 14)
    leaves = [x] + ([identity] if with_identity else [])
    inv = torch.rsqrt(bn.var + bn.eps) * bn.scale
    launches = fb.frozen_bn_act.launches
    got = fb._FrozenBnActFn.apply(x, inv, bn.bias - bn.mean * inv, identity, relu)
    assert fb.frozen_bn_act.launches == launches + 1 and got.is_contiguous(memory_format=CL)
    got_grads = _grads(bn, leaves, got, g)
    assert fb.frozen_bn_act.launches == launches + 3
    want = _formula(bn, x, relu, identity)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    for a, b in zip(got_grads, _grads(bn, leaves, want, g)):
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-6)


def test_kernel_wiring_skips_the_sums_of_frozen_parameters(plain_launches):
    """With the parameters frozen, the backward saves no x, launches once
    (no sums, no second pass) and still gives x and the identity their
    gradients; with nothing that takes a gradient, the forward op alone."""
    x = _maps((2, 4, 3, 3), 1).contiguous(memory_format=CL).requires_grad_()
    identity = _maps((2, 4, 3, 3), 2).contiguous(memory_format=CL).requires_grad_()
    inv, shift = torch.full((4,), 0.5), torch.full((4,), 0.25)
    launches = fb.frozen_bn_act.launches
    y = fb._FrozenBnActFn.apply(x, inv, shift, identity, True)
    assert y.grad_fn.saved_tensors[1] is None
    dx, d_identity = torch.autograd.grad(y, [x, identity], torch.ones_like(y))
    assert fb.frozen_bn_act.launches == launches + 2
    mask = (x.detach() * 0.5 + 0.25 + identity.detach() > 0).float()
    assert torch.equal(dx, mask * 0.5) and torch.equal(d_identity, mask)


# -- on the card -------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


def _bf16_ulps(got: torch.Tensor, want: torch.Tensor) -> float:
    """Largest |got - want| in bf16 ulps of ``want`` (fp32); values below
    2^-8 of max|want| counted at that floor."""
    mag = want.abs().clamp_min(2.0**-8 * want.abs().max().item())
    ulp = torch.exp2(torch.floor(torch.log2(mag)) - 7)
    return ((got.float() - want) / ulp).abs().max().item()


def _rounded_vectors(bn: FrozenBatchNorm, dtype):
    """(inv, shift) in fp32 through autograd, as the module computes them,
    and the same rounded to ``dtype`` and back (what the kernel multiplies
    and adds): a float32 reference then meets the maps with the kernel's
    own per-channel values, so a ReLU mask flips only within fp32
    rounding."""
    inv = torch.rsqrt(bn.var + bn.eps) * bn.scale
    shift = bn.bias - bn.mean * inv
    return inv, shift, inv.to(dtype).float(), shift.to(dtype).float()


# (N, C, H, W): C at both ends of the ResNets' widths, an odd H*W, N = 1,
# and a C that is no multiple of a 16-byte vector (the one-channel kernels)
CARD_SHAPES = [(4, 64, 9, 13), (1, 2048, 5, 7), (3, 256, 20, 33), (2, 6, 7, 3)]


@pytest.mark.cuda
@pytest.mark.parametrize("shape", CARD_SHAPES)
@pytest.mark.parametrize("form", FORMS)
def test_kernel_matches_plain_on_card(shape, form):
    """Forward: bf16 within one bf16 ulp of the float32 reference, fp32
    within 1e-6 of the terms' size. Backward through autograd: dx and the
    identity's gradient within one bf16 ulp of the reference computed in
    float32 and then rounded (fp32: 1e-6 of the largest); each of the four
    parameters' gradients within 1e-3 of its norm, as the sums over N*H*W
    are taken in another order (per block, then across blocks) than the
    reference's. A map that is not channels_last is made so first."""
    _card()
    relu, with_identity = FORMS[form]
    N, C, H, W = shape
    for dtype in (torch.bfloat16, torch.float32):
        for layout in (CL, torch.contiguous_format):
            bn = _bn(C, seed=C + H, device="cuda")
            x = _maps(shape, 1, dtype, "cuda").contiguous(memory_format=layout).requires_grad_()
            identity = (_maps(shape, 2, dtype, "cuda").contiguous(memory_format=layout).requires_grad_()
                        if with_identity else None)
            g = _maps(shape, 3, dtype, "cuda")
            leaves = [x] + ([identity] if with_identity else [])
            before, launches = counts().get("xpt.frozen_bn.kernel", 0), fb.frozen_bn_act.launches
            got = bn(x, relu=relu, identity=identity)
            got_grads = _grads(bn, leaves, got, g)
            torch.cuda.synchronize()
            assert counts()["xpt.frozen_bn.kernel"] == before + 1 and fb.frozen_bn_act.launches == launches + 3
            assert got.dtype == dtype and got.is_contiguous(memory_format=CL)

            # the float32 reference on the kernel's per-channel values
            ref = _bn(C, seed=C + H, device="cuda")
            inv, shift, inv_r, shift_r = _rounded_vectors(ref, dtype)
            inv_r = inv + (inv_r - inv).detach()  # the rounded value, autograd's gradient of inv
            shift_r = shift + (shift_r - shift).detach()
            xf = x.detach().float().requires_grad_()
            idf = identity.detach().float().requires_grad_() if with_identity else None
            want = fb.frozen_bn_act_plain(xf, inv_r, shift_r, relu, idf)
            want_grads = torch.autograd.grad(want, [xf] + ([idf] if with_identity else [])
                                             + [getattr(ref, n) for n in PARAMS], g.float())
            if dtype == torch.bfloat16:
                assert _bf16_ulps(got, want) <= 1.0
                for a, b in zip(got_grads[:len(leaves)], want_grads):
                    assert _bf16_ulps(a, b) <= 1.0
            else:
                terms = (xf * inv_r[:, None, None]).abs() + shift_r.abs()[:, None, None]
                terms = terms + (idf.abs() if with_identity else 0)
                assert ((got - want).abs() <= 1e-6 * terms).all()
                for a, b in zip(got_grads[:len(leaves)], want_grads):
                    assert (a - b).abs().max().item() <= 1e-6 * b.abs().max().item()
            for name, a, b in zip(PARAMS, got_grads[len(leaves):], want_grads[len(leaves):]):
                assert (a - b).norm().item() <= 1e-3 * b.norm().item(), (dtype, layout, name)


@pytest.mark.cuda
@pytest.mark.parametrize("form", FORMS)
def test_kernel_backward_is_its_plain_version_on_card(form):
    """The backward op on the forward op's own output: dx and the identity's
    gradient equal ``frozen_bn_act_bwd_plain`` (fp32 math, one rounding) bit
    for bit; the sums within 1e-5 of their norm (another order)."""
    _card()
    relu, with_identity = FORMS[form]
    shape = (8, 256, 40, 64)
    x = _maps(shape, 1, torch.bfloat16, "cuda").contiguous(memory_format=CL)
    identity = _maps(shape, 2, torch.bfloat16, "cuda").contiguous(memory_format=CL) if with_identity else None
    g = _maps(shape, 3, torch.bfloat16, "cuda").contiguous(memory_format=CL)
    inv, shift = _maps((256,), 4, device="cuda"), _maps((256,), 5, device="cuda")
    y = torch.ops.xpt.frozen_bn_act_fwd(x, inv, shift, identity, relu)
    dx, d_identity, sums = torch.ops.xpt.frozen_bn_act_bwd(g, y if relu else None, x, inv, with_identity)
    want = fb.frozen_bn_act_bwd_plain(g, y if relu else None, x, inv, with_identity)
    assert torch.equal(dx, want[0])
    assert torch.equal(d_identity, want[1]) if with_identity else d_identity.numel() == 0
    assert ((sums - want[2]).norm(dim=1) <= 1e-5 * want[2].norm(dim=1)).all()
    _, _, none = torch.ops.xpt.frozen_bn_act_bwd(g, y if relu else None, None, inv, with_identity)
    assert none.numel() == 0


@pytest.mark.cuda
def test_kernel_sums_are_the_same_in_two_runs_on_card():
    """The parameters' sums are reduced in a fixed order (per-block partials,
    then a fixed walk over them, no atomics): two runs give the same bits."""
    _card()
    shape = (16, 512, 40, 64)
    x, g = (_maps(shape, s, torch.bfloat16, "cuda").contiguous(memory_format=CL) for s in (1, 2))
    inv, shift = _maps((512,), 3, device="cuda"), _maps((512,), 4, device="cuda")
    y = torch.ops.xpt.frozen_bn_act_fwd(x, inv, shift, x, True)
    runs = [torch.ops.xpt.frozen_bn_act_bwd(g, y, x, inv, True) for _ in range(2)]
    for a, b in zip(*runs):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_kernels_capture_and_replay_on_card():
    """Forward and backward captured in one CUDA graph (the backward's
    scratch from the graph's pool) and replayed on new inputs equal the eager
    calls on those inputs."""
    _card()
    shape = (4, 128, 24, 40)
    static = [_maps(shape, s, torch.bfloat16, "cuda").contiguous(memory_format=CL) for s in (1, 2, 3)]
    inv, shift = _maps((128,), 4, device="cuda"), _maps((128,), 5, device="cuda")

    def run(x, identity, g):
        y = torch.ops.xpt.frozen_bn_act_fwd(x, inv, shift, identity, True)
        return (y, *torch.ops.xpt.frozen_bn_act_bwd(g, y, x, inv, True))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        run(*static)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        outs = run(*static)
    fresh = [_maps(shape, s, torch.bfloat16, "cuda").contiguous(memory_format=CL) for s in (6, 7, 8)]
    for buf, value in zip(static, fresh):
        buf.copy_(value)
    graph.replay()
    torch.cuda.synchronize()
    for a, b in zip(outs, run(*fresh)):
        assert torch.equal(a, b)
