"""The port's kernels as ``torch.library`` custom ops (``torch.ops.xpt.*``).

On the CPU: each op's fake gives the shape, dtype and strides of what its
real body allocates, on fake CUDA tensors; an op refuses a CPU tensor; and a
tiny CLIP-ViP and a kernel-gated tiny LF-VILA, exported on fake CUDA inputs,
hold exactly one op node for each attention the kernels take and no plain
attention in their place (with ``force_plain_attention`` the other way
round). On the card (``-m cuda``, skipped here): the ops against the plain
versions, and a tiny exported CLIP-ViP against the live towers, its launches
counted inside the loaded program.

This CPU build of torch takes a CUDA device guard in two Python bindings
before any dispatch (``Tensor.__getitem__`` and ``Tensor.contiguous``), so a
fake CUDA tensor cannot pass them here: :func:`_fake_cuda_bindings` gives
them the aten ops they dispatch to for the duration of a trace.
"""

from collections import Counter

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch._subclasses.fake_tensor import FakeTensorMode  # noqa: E402

from xpretrain_tpu_torch.ops import _kernels  # noqa: E402
from xpretrain_tpu_torch.ops import frozen_bn as fb  # noqa: E402
from xpretrain_tpu_torch.ops import patchify as pp  # noqa: E402
from xpretrain_tpu_torch.ops import proxy_attention as pa  # noqa: E402
from xpretrain_tpu_torch.ops import window_attention as wa  # noqa: E402
from xpretrain_tpu_torch.serving.artifact import _export_tower  # noqa: E402

CUDA = torch.device("cuda", 0)


@pytest.fixture(autouse=True, scope="module")
def _few_threads():
    """Two intra-op threads: beside the other test processes, torch's
    all-cores default oversubscribes the CPU many times over."""
    threads = torch.get_num_threads()
    torch.set_num_threads(min(2, threads))
    yield
    torch.set_num_threads(threads)


def _getitem(self, index):
    """``Tensor.__getitem__`` through aten ops: selects, slices and unsqueezes
    left to right, then one ``aten.index`` for the tensor indices at their
    dims, as the C++ binding does after its device guard."""
    index = index if isinstance(index, tuple) else (index,)
    if any(isinstance(i, bool) or (isinstance(i, torch.Tensor) and i.dtype == torch.bool) for i in index):
        raise NotImplementedError("boolean indexing")
    used = sum(1 for i in index if i is not None and i is not Ellipsis)
    out, dim, tensors = self, 0, []
    for i in index:
        if i is Ellipsis:
            dim += self.dim() - used
        elif i is None:
            out, dim = out.unsqueeze(dim), dim + 1
        elif isinstance(i, (int, torch.SymInt)):
            out = out.select(dim, i)
        elif isinstance(i, slice):
            out = torch.ops.aten.slice.Tensor(out, dim, i.start, i.stop, 1 if i.step is None else i.step)
            dim += 1
        else:
            tensors += [None] * (dim - len(tensors)) + [i]
            dim += 1
    return torch.ops.aten.index.Tensor(out, tensors) if tensors else out


def _contiguous(self, memory_format=torch.contiguous_format):
    return self if self.is_contiguous(memory_format=memory_format) else torch.ops.aten.clone.default(
        self, memory_format=memory_format)


@pytest.fixture()
def _fake_cuda_bindings(monkeypatch):
    monkeypatch.setattr(torch.Tensor, "__getitem__", _getitem)
    monkeypatch.setattr(torch.Tensor, "contiguous", _contiguous)


def _to_fake_cuda(model: torch.nn.Module, mode: FakeTensorMode) -> torch.nn.Module:
    """A model built on the meta device with fake CUDA parameters and
    buffers of ``mode`` (no data: nothing is initialized)."""
    convert = mode.fake_tensor_converter
    for module in model.modules():
        for store in (module._parameters, module._buffers):
            for name, t in list(store.items()):
                if t is not None:
                    fake = convert.from_meta_and_device(mode, t.to("meta"), CUDA)
                    store[name] = torch.nn.Parameter(fake, requires_grad=False) if name in module._parameters \
                        else fake
    return model


def _calls(program) -> Counter:
    return Counter(str(node.target) for node in program.graph.nodes if node.op == "call_function")


def _softmaxes(calls: Counter) -> int:
    return sum(n for target, n in calls.items() if "softmax" in target)


# -- each op's fake against its body -------------------------------------------


def _meta(t: torch.Tensor) -> tuple:
    return tuple(t.shape), t.dtype, t.stride(), t.device


def _proxy_cases():
    B, H, M, N, L, D = 2, 3, 4, 3, 7, 16
    S = M + N * L
    bhsd = lambda dt: torch.empty(B, H, S, D, dtype=dt, device=CUDA)  # noqa: E731
    packed = lambda dt: torch.empty(B, S, H * D, dtype=dt, device=CUDA)  # noqa: E731
    for dt in (torch.float32, torch.bfloat16):
        for make, head_dim in ((bhsd, 0), (packed, D)):
            q, k, v = make(dt), make(dt), make(dt)
            for with_lse in (False, True):
                yield ("proxy_attention_fwd", pa._fwd_launch, (q, k, v, M, N, L, D**-0.5, head_dim, with_lse))
            lse = torch.empty(B, H, S, device=CUDA)
            for given in (None, lse):
                yield ("proxy_attention_bwd", pa._bwd_launch, (q, k, v, make(dt), given, M, N, L, D**-0.5, head_dim))


def _window_cases():
    Bn, H, N, d, nW = 6, 2, 30, 16, 3
    for dt in (torch.float32, torch.bfloat16):
        # the model's q/k/v: views of one fused [Bn, N, 3, H, d] projection
        qkv = torch.empty(Bn, N, 3, H, d, dtype=dt, device=CUDA).permute(2, 0, 3, 1, 4)
        bias, mask = torch.empty(H, N, N, device=CUDA), torch.empty(nW, N, N, device=CUDA)
        for m in (None, mask):
            yield ("window_attention_fwd", wa._window_launch, (*qkv.unbind(0), bias, m))


def _patch_cases():
    frames = torch.empty(5, 64, 96, 3, dtype=torch.uint8, device=CUDA)
    w, bias = torch.empty(3 * 16 * 16, 200, device=CUDA), torch.empty(200, device=CUDA)
    for dt in (torch.float32, torch.bfloat16):
        yield ("patch_embed_u8", pp._patch_launch, (frames, w, bias, 16, dt))


def _frozen_bn_cases():
    for dt in (torch.float32, torch.bfloat16):
        x = torch.empty(2, 64, 5, 7, dtype=dt, device=CUDA, memory_format=torch.channels_last)
        inv, shift = torch.empty(64, device=CUDA), torch.empty(64, device=CUDA)
        for identity, relu in ((None, False), (None, True), (x, True)):
            yield ("frozen_bn_act_fwd", fb._fwd_launch, (x, inv, shift, identity, relu))
            for saved in (None, x):
                yield ("frozen_bn_act_bwd", fb._bwd_launch, (x, x if relu else None, saved, inv, identity is not None))


def test_each_fake_gives_what_the_body_allocates(monkeypatch):
    """On fake CUDA tensors, ``torch.ops.xpt.<op>`` (its registered fake)
    returns outputs of the shape, dtype, strides and device that the op's
    real body allocates (its launch and its pointer checks replaced by
    no-ops: a fake tensor has no data)."""
    for name in ("proxy_attention_fwd", "proxy_attention_bwd", "window_attention_fwd", "patch_embed_u8",
                 "frozen_bn_act_fwd", "frozen_bn_act_bwd"):
        monkeypatch.setattr(_kernels, name, lambda *args: None)
    monkeypatch.setattr(_kernels, "check_cp_async", lambda *args: None)
    for counter in _kernels.COUNTED:
        monkeypatch.setattr(counter, "launches", 0)
    seen = Counter()
    with FakeTensorMode():
        cases = [*_proxy_cases(), *_window_cases(), *_patch_cases(), *_frozen_bn_cases()]
        for name, body, args in cases:
            got = getattr(torch.ops.xpt, name)(*args)
            want = body(*args)
            got, want = ((x,) if isinstance(x, torch.Tensor) else x for x in (got, want))
            assert [_meta(t) for t in got] == [_meta(t) for t in want], (name, args[-1])
            seen[name] += 1
    assert seen == {"proxy_attention_fwd": 8, "proxy_attention_bwd": 8, "window_attention_fwd": 4,
                    "patch_embed_u8": 2, "frozen_bn_act_fwd": 6, "frozen_bn_act_bwd": 12}


def test_ops_refuse_cpu_tensors():
    """The ops are registered for CUDA: a CPU tensor reaching one raises (the
    public wrappers send CPU tensors to the plain versions before)."""
    q = torch.zeros(1, 1, 5, 16)
    with pytest.raises(NotImplementedError):
        torch.ops.xpt.proxy_attention_fwd(q, q, q, 1, 1, 4, 0.25, 0, False)
    with pytest.raises(NotImplementedError):
        torch.ops.xpt.window_attention_fwd(q, q, q, torch.zeros(1, 5, 5), None)
    with pytest.raises(NotImplementedError):
        torch.ops.xpt.patch_embed_u8(torch.zeros(1, 16, 16, 3, dtype=torch.uint8), torch.zeros(768, 8),
                                     torch.zeros(8), 16, torch.float32)
    x = torch.zeros(1, 4, 2, 2)
    with pytest.raises(NotImplementedError):
        torch.ops.xpt.frozen_bn_act_fwd(x, torch.ones(4), torch.zeros(4), None, True)
    with pytest.raises(NotImplementedError):
        torch.ops.xpt.frozen_bn_act_bwd(x, x, x, torch.ones(4), False)


# -- tiny models exported on fake CUDA inputs ------------------------------------


def test_clipvip_export_holds_one_proxy_op_per_video_layer(_fake_cuda_bindings):
    """The B/32 layout in small: each vision layer's attention is one
    ``xpt::proxy_attention_fwd`` node of the exported video tower, with no
    softmax (the plain attention's) left; ``force_plain_attention`` exports
    the plain attention in every layer instead. The text tower holds no op."""
    from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    model = _to_fake_cuda(CLIPViPModel(CLIPVipConfig.tiny_debug(image_size=32), device="meta"), mode)
    layers = model.config.vision.num_hidden_layers
    with mode:
        video = torch.empty(2, 4, 32, 32, 3, dtype=torch.uint8, device=CUDA)
        ids = torch.empty(2, 16, dtype=torch.long, device=CUDA)
    kernel = _calls(_export_tower(model, "forward_video", (video,)))
    assert kernel["xpt.proxy_attention_fwd.default"] == layers > 0
    assert _softmaxes(kernel) == 0 and not any("xpt" in t and "proxy" not in t for t in kernel)
    plain = _calls(_export_tower(model, "forward_video", (video,), pa.force_plain_attention))
    assert not any(t.startswith("xpt.") for t in plain) and _softmaxes(plain) == layers
    text = _calls(_export_tower(model, "forward_text", (ids, ids)))
    assert not any(t.startswith("xpt.") for t in text)


def test_kernel_gated_lfvila_export_holds_one_window_op_per_gated_block(_fake_cuda_bindings):
    """The tiny LF-VILA with ``use_pallas_attention``: each block whose window
    the gate takes (>= ``pallas_min_window`` tokens unclipped) is one
    ``xpt::window_attention_fwd`` node; the other blocks keep their plain
    attention (one softmax each)."""
    from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaConfig
    from xpretrain_tpu_torch.models.lf_vila.swin3d import Swin3DConfig, WindowAttention3D
    from xpretrain_tpu_torch.models.lf_vila.tasks import LfVilaRetrieval

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    config = LfVilaConfig.tiny(video=Swin3DConfig.tiny(use_pallas_attention=True), sample_frame=8)
    model = _to_fake_cuda(LfVilaRetrieval(config, device="meta"), mode)
    blocks = [m for m in model.modules() if isinstance(m, WindowAttention3D)]
    gated = sum(m.use_pallas for m in blocks)
    with mode:
        video = torch.empty(2, 3, 8, 96, 160, device=CUDA)
    calls = _calls(_export_tower(model, "forward_video", (video,)))
    assert calls["xpt.window_attention_fwd.default"] == gated == 3
    assert _softmaxes(calls) == len(blocks) - gated


def test_hdvila_resnet_export_holds_one_frozen_bn_op_per_bn(_fake_cuda_bindings):
    """HD-VILA's ResNet-50 (the low-resolution one: three stages) exported on
    fake CUDA inputs: each of its 43 FrozenBatchNorms is one
    ``xpt::frozen_bn_act_fwd`` node, with its ReLU and residual add inside
    (no relu left; the one add a BN keeps is its ``var + eps``), and each
    call counted on
    ``xpt.frozen_bn.kernel``."""
    from xpretrain_tpu_torch.models.hd_vila.resnet import FrozenBatchNorm, ResNet
    from xpretrain_tpu_torch.utils.profiling import counts

    mode = FakeTensorMode(allow_non_fake_inputs=True)
    model = _to_fake_cuda(ResNet(50, dtype=torch.bfloat16, num_stages=3, device="meta"), mode)
    bns = sum(isinstance(m, FrozenBatchNorm) for m in model.modules())
    with mode:
        frames = torch.empty(2, 3, 64, 96, device=CUDA)
    before = counts().get("xpt.frozen_bn.kernel", 0)
    calls = _calls(_export_tower(model, "forward_to_stage", (frames,)))
    assert calls["xpt.frozen_bn_act_fwd.default"] == bns == 43
    assert counts()["xpt.frozen_bn.kernel"] - before == bns
    assert not any("relu" in target for target in calls)
    assert calls["aten.add.Tensor"] == bns  # each BN's var + eps, none over the maps


# -- on the card -------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernels have no CPU mode")


@pytest.mark.cuda
def test_ops_match_the_plain_versions_on_card():
    """Each op, called directly, against its plain version (fp32: the
    kernels' CPU-test bars), and its launch counted on its wrapper."""
    _card()
    g = torch.Generator(device="cuda").manual_seed(0)
    M, N, L, D = 4, 3, 13, 16
    q, k, v, d_out = (torch.randn(2, 2, M + N * L, D, device="cuda", generator=g) for _ in range(4))
    before = pa.proxy_attention.launches
    out, lse = torch.ops.xpt.proxy_attention_fwd(q, k, v, M, N, L, D**-0.5, 0, True)
    assert pa.proxy_attention.launches == before + 1
    assert (out - pa.proxy_attention_plain(q, k, v, M, L, D**-0.5)).abs().max().item() <= 2e-5
    assert (lse - pa.proxy_attention_lse_plain(q, k, M, L, D**-0.5)).abs().max().item() <= 1e-5
    grads = torch.ops.xpt.proxy_attention_bwd(q, k, v, d_out, lse, M, N, L, D**-0.5, 0)
    for got, want in zip(grads, pa.proxy_attention_bwd_plain(q, k, v, d_out, M, L, D**-0.5)):
        assert (got - want).abs().max().item() <= 1e-4
    wq, wk, wv = (torch.randn(6, 2, 30, 16, device="cuda", generator=g) for _ in range(3))
    bias = torch.randn(2, 30, 30, device="cuda", generator=g)
    got = torch.ops.xpt.window_attention_fwd(wq, wk, wv, bias, None)
    assert (got - wa.window_attention_plain(wq, wk, wv, bias)).abs().max().item() <= 2e-5
    frames = torch.randint(0, 256, (3, 64, 96, 3), dtype=torch.uint8, device="cuda", generator=g)
    kernel = torch.randn(16, 16, 3, 64, device="cuda", generator=g) * 0.02
    folded, b = pp.fold_normalization(kernel, np.full(3, 0.5), np.full(3, 0.25))
    got = torch.ops.xpt.patch_embed_u8(frames, folded, b, 16, torch.float32)
    want = pp.patch_embed_plain(frames, folded, b, 16, torch.float32)
    assert (got - want).abs().max().item() <= 3e-5 * want.abs().max().item()


@pytest.mark.cuda
def test_exported_clipvip_runs_its_kernels_on_card(tmp_path):
    """A tiny CLIP-ViP exported on the card with kernel attention: the loaded
    artifact equals the live towers and launches one proxy forward per video
    layer inside the program, at two batch sizes."""
    _card()
    from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel
    from xpretrain_tpu_torch.serving import export_retrieval_towers, load_artifact, save_artifact

    model = CLIPViPModel(CLIPVipConfig.tiny_debug(image_size=32), device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0)).eval()
    path = str(tmp_path / "tiny.xpsa")
    save_artifact(path, export_retrieval_towers(model, frames=4, image_size=32, seq_len=16))
    art = load_artifact(path)
    assert art.meta["attention"] == "kernel"
    layers = model.config.vision.num_hidden_layers
    for b in (3, 17):
        video = torch.randint(0, 256, (b, 4, 32, 32, 3), dtype=torch.uint8, device="cuda")
        before = pa.proxy_attention.launches
        got = art.encode_video(video)
        torch.cuda.synchronize()
        assert pa.proxy_attention.launches == before + layers
        with torch.no_grad():
            want = model.forward_video(video)
        assert (got - want).abs().max().item() <= 1e-5
