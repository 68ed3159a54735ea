"""GroupedAdamW's multi-tensor kernel (``xpretrain_tpu_torch/optim/adamw_kernel.py``,
``csrc/adamw_multi_tensor.cu``): the plain per-leaf version of the kernel's
arithmetic against the ``_foreach`` path on the CPU, the optimizer's CUDA
branch on the CPU with the launch replaced by that plain version over the
tensors its address table points at (the leaf and chunk table, strided
targets and gradients, the counters, accumulation, masters, ZeRO-2 blocks),
and the kernel against the ``_foreach`` path on the card.

No JAX here (the update's JAX parity is ``test_torch_optim.py``'s), so the
CUDA cases run on the card with
``python -m pytest tests/test_torch_adamw_kernel.py -m cuda --noconftest``.
"""

import ctypes
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.ops import _kernels  # noqa: E402
from xpretrain_tpu_torch.optim import adamw_kernel as ak  # noqa: E402
from xpretrain_tpu_torch.optim import optimizer as opt  # noqa: E402
from xpretrain_tpu_torch.optim import schedules  # noqa: E402
from xpretrain_tpu_torch.utils.profiling import counts  # noqa: E402

SHAPES = {
    "vision.kernel": (96, 100),  # three chunks, the last one partial
    "vision.bias": (96,),
    "cnn.conv.kernel": (3, 8),
    "text.embed": (4097, 2),
    "layer_norm.scale": (7,),
    "logit_scale": (),
    "pos_embed": (3, 4),
}

# optimizer settings; the groups: {top_, base_} x {decay, no_decay} (and frozen)
CASES = {
    "clip_on_groups": dict(max_grad_norm=2.0, lr_mul=2.0, lr_mul_prefix="vision", frozen_patterns=("cnn",)),
    "clip_off": dict(max_grad_norm=None, lr_mul=3.0, lr_mul_prefix="text"),
    "moment_bf16": dict(max_grad_norm=2.0, moment_dtype=torch.bfloat16, lr_mul=2.0, lr_mul_prefix="vision"),
    "accum_2": dict(max_grad_norm=2.0, grad_accum_steps=2, frozen_patterns=("pos_embed",)),
    "masters": dict(max_grad_norm=1.0, frozen_patterns=("cnn",), param_dtype=torch.bfloat16),
}
PLAIN_CASES = ("clip_on_groups", "clip_off", "moment_bf16")


def _params(seed: int = 0) -> dict[str, torch.Tensor]:
    g = torch.Generator().manual_seed(seed)
    return {name: torch.randn(shape, generator=g) for name, shape in SHAPES.items()}


def _optimizer(case: str, named: dict[str, torch.Tensor]) -> opt.GroupedAdamW:
    kwargs = dict(CASES[case])
    storage = kwargs.pop("param_dtype", None)
    port, _ = opt.build_optimizer(named, schedules.get_schedule("cosine", 1e-2, 20, warmup_ratio=0.1),
                                  weight_decay=0.1, **kwargs)
    if storage is not None:
        opt.cast_params_for_storage(named, storage)
        opt.master_weights(port)
    return port


def _grads(port: opt.GroupedAdamW, call: int, seed: int = 1) -> list[torch.Tensor]:
    """One gradient per parameter, in the update's dtype; the second call's
    are large enough to trip the norm clip."""
    g = torch.Generator().manual_seed(seed + call)
    scale = 100.0 if call == 1 else 0.05
    return port.upcast([(torch.randn(p.shape, generator=g) * scale).to(p.dtype) for p in port.params])


def _state(port: opt.GroupedAdamW) -> list[torch.Tensor]:
    return [*port.params, *port.targets, *port.mu, *port.nu, *port.acc]


def _group_of(port: opt.GroupedAdamW) -> dict[int, tuple[int, float]]:
    """Leaf index -> (its scalar index, its decay)."""
    return {i: (2 + group, wd) for group, ((_, wd), idx) in enumerate(port.groups.items()) for i in idx}


def _at(address: int, n: int, dtype: torch.dtype) -> torch.Tensor:
    """The ``n`` elements of ``dtype`` at a CPU address, as a tensor over
    that memory."""
    ctype = {torch.float32: ctypes.c_float, torch.bfloat16: ctypes.c_uint16}[dtype]
    t = torch.from_numpy(np.ctypeslib.as_array((ctype * n).from_address(address)))
    return t.view(dtype)


def _through_kernel(port: opt.GroupedAdamW) -> opt.GroupedAdamW:
    """``port``'s CPU updates through the kernel's branch, the one a card takes."""
    port._update_plain = port._update_kernel
    return port


@pytest.fixture()
def plain_launches(monkeypatch):
    """The launch replaced by the plain version over the leaves its address
    table points at (CPU memory): checks the table's form and yields each
    launch's leaves."""
    launches = []

    def launch(ptrs, numel, first_chunk, scalar_index, wd, moment_bf16, scalars, gnorm, h):
        n = len(numel)
        assert 1 <= n <= ak.MAX_LEAVES and ptrs.dtype == np.uint64 and ptrs.shape == (n, 4)
        assert ptrs.flags.c_contiguous and scalar_index.dtype == np.int32 and wd.dtype == np.float32
        np.testing.assert_array_equal(first_chunk, ak.chunk_table(numel))
        moments = torch.bfloat16 if moment_bf16 else torch.float32
        leaves = [ak.Leaf(_at(int(p), int(k), torch.float32), _at(int(g), int(k), torch.float32),
                          _at(int(m), int(k), moments), _at(int(v), int(k), moments), int(s), float(w))
                  for (p, g, m, v), k, s, w in zip(ptrs, numel, scalar_index, wd)]
        launches.append(leaves)
        for leaf in leaves:
            ak.adamw_update_plain(leaf, scalars, gnorm, h)

    monkeypatch.setattr(_kernels, "adamw_multi_tensor", launch)
    yield launches


# -- the plain version on the CPU --------------------------------------------------


@pytest.mark.parametrize("case", PLAIN_CASES)
def test_plain_per_leaf_is_the_foreach_path(case):
    """Over three updates (the second clipped when the clip is on), the
    kernel's arithmetic applied leaf by leaf with the optimizer's scalars and
    norm gives the bits of the ``_foreach`` path: parameters and both
    moments, in several groups with and without decay, fp32 and bf16
    moments."""
    named = _params()
    port = _optimizer(case, named)
    p = [t.clone() for t in port.params]
    m = [t.clone() for t in port.mu]
    v = [t.clone() for t in port.nu]
    for call in range(3):
        grads = _grads(port, call)
        port.prepare()
        gnorm = opt.global_norm(grads) if port.max_grad_norm is not None else None
        for i, (scalar, wd) in _group_of(port).items():
            ak.adamw_update_plain(ak.Leaf(p[i], grads[i], m[i], v[i], scalar, wd), port.scalars, gnorm, port.hyper)
        port.apply(grads)
        port.advance()
        for a, b in zip([*p, *m, *v], [*port.params, *port.mu, *port.nu]):
            assert a.dtype == b.dtype and torch.equal(a, b), f"call {call}"
    if CASES[case].get("moment_dtype") is not None:
        assert all(t.dtype == torch.bfloat16 for t in port.mu)


def test_hyper_rounds_as_the_foreach_scalars():
    """``1 - b`` in float64, then each constant rounded to fp32; no norm, no clip."""
    h = ak.hyper(0.9, 0.98, 1e-6, None)
    assert h.one_minus_b1 == float(np.float32(1 - 0.9)) and h.b2 == float(np.float32(0.98))
    assert h.eps == float(np.float32(1e-6)) and h.max_norm is None
    assert ak.hyper(0.9, 0.98, 1e-6, 2.0).max_norm == 2.0


def test_chunk_table_and_launches():
    """Each leaf's first chunk of 4096 elements, the total last; a table
    whose moments mix fp32 and bf16, or whose target is not fp32, is refused
    when it is built (the kernel reads one table's moments in one dtype, and
    fp32 targets), before any launch."""
    assert ak.chunk_table([1, 4096, 4097, 10000]).tolist() == [0, 1, 2, 4, 7]
    assert ak.chunk_table([]).tolist() == [0]
    t, cpu = torch.zeros(4), torch.device("cpu")
    launches = ak.adamw_multi_tensor.launches
    with pytest.raises(ValueError, match="one dtype"):
        ak.LeafTable([t, t], [t, t.bfloat16()], [t, t.bfloat16()], [2, 2], [0.0, 0.0], cpu)
    with pytest.raises(ValueError, match="fp32 targets"):
        ak.LeafTable([t.bfloat16()], [t], [t], [2], [0.0], cpu)
    with pytest.raises(ValueError, match="contiguous"):
        ak.LeafTable([t], [torch.zeros(2, 2).t()], [t], [2], [0.0], cpu)
    assert ak.adamw_multi_tensor.launches == launches


def test_cpu_leaves_take_the_foreach_path_and_count_it():
    """On the CPU no leaf takes the kernel: every trained leaf of an update
    counts ``xpt.adamw.plain``, none ``xpt.adamw.kernel``, no launch."""
    port = _optimizer("clip_on_groups", _params())
    before, launches = counts(), ak.adamw_multi_tensor.launches
    port.step(_grads(port, 0))
    after = counts()
    trained = sum(len(idx) for idx in port.groups.values())
    assert after["xpt.adamw.plain"] - before.get("xpt.adamw.plain", 0) == trained == len(SHAPES) - 1
    assert after.get("xpt.adamw.kernel", 0) == before.get("xpt.adamw.kernel", 0)
    assert ak.adamw_multi_tensor.launches == launches and port._table is None


# -- the CUDA branch's wiring, on the CPU ---------------------------------------------


@pytest.mark.parametrize("case", sorted(CASES))
def test_kernel_wiring_is_the_foreach_path(plain_launches, case):
    """Through the kernel's branch (the launch replaced by the plain version),
    three updates give the bits of the ``_foreach`` path on the same
    gradients: stored parameters, masters, moments and accumulators. Each
    update makes one launch over every trained leaf, each with its group's
    scalar index and decay, no frozen leaf; the calls that only accumulate
    launch nothing; ``xpt.adamw.kernel`` counts the trained leaves of each
    update and ``xpt.adamw.plain`` nothing. The table is built once."""
    accum = CASES[case].get("grad_accum_steps", 1)
    want, got = _optimizer(case, _params()), _through_kernel(_optimizer(case, _params()))
    groups = _group_of(got)
    frozen = {i for i, label in enumerate(got.labels) if label == "frozen"}
    assert bool(frozen) == ("frozen_patterns" in CASES[case])
    at = {t.data_ptr(): i for i, t in enumerate(got.targets)}
    tables = set()
    for call in range(3 * accum):
        want.step(_grads(want, call))
        before, launches = counts(), ak.adamw_multi_tensor.launches
        plain_launches.clear()
        got.step(_grads(got, call))
        for a, b in zip(_state(want), _state(got)):
            assert a.dtype == b.dtype and torch.equal(a, b), f"call {call}"
        after = counts()
        updated = (call + 1) % accum == 0
        assert after.get("xpt.adamw.kernel", 0) - before.get("xpt.adamw.kernel", 0) == (len(groups) if updated else 0)
        assert after.get("xpt.adamw.plain", 0) - before.get("xpt.adamw.plain", 0) == 0
        assert ak.adamw_multi_tensor.launches - launches == len(plain_launches) == int(updated)
        if updated:
            (leaves,) = plain_launches
            table = {at[leaf.p.data_ptr()]: (leaf.scalar, leaf.wd) for leaf in leaves}
            assert table == {i: (s, float(np.float32(wd))) for i, (s, wd) in groups.items()} and not frozen & set(table) and len(leaves) == len(groups)
            tables.add(id(got._table))
    assert len(tables) == 1 and not got._table.staged
    assert {wd for _, wd in groups.values()} == {0.0, 0.1}
    if case == "masters":
        assert got.masters and all(torch.equal(got.params[i], got.targets[i].to(torch.bfloat16)) for i in got.masters)


def test_kernel_wiring_takes_what_is_not_contiguous_or_aligned(plain_launches):
    """A transposed parameter (its target staged in a contiguous copy of the
    table's own), a transposed gradient (read from a contiguous copy) and a
    gradient one element into its buffer (not 16-byte aligned) all take the
    kernel with the other leaves: the bits are the ``_foreach`` path's, every
    trained leaf counts ``xpt.adamw.kernel`` and none ``xpt.adamw.plain``."""
    names = list(SHAPES)
    kernel, bias, pos = (names.index(n) for n in ("vision.kernel", "vision.bias", "pos_embed"))

    def params():
        named = _params()
        named["vision.kernel"] = named["vision.kernel"].t()  # [100, 96], strides (1, 100)
        return named

    want, got = _optimizer("clip_on_groups", params()), _through_kernel(_optimizer("clip_on_groups", params()))
    trained = sum(len(idx) for idx in got.groups.values())
    for call in range(3):
        grads = _grads(got, call)
        buf = torch.empty(grads[bias].numel() + 1)
        buf[1:] = grads[bias]
        odd = list(grads)
        odd[bias] = buf[1:]
        odd[pos] = grads[pos].t().contiguous().t()  # [3, 4], strides (1, 3)
        assert not odd[pos].is_contiguous() and odd[bias].data_ptr() % 16
        want.step(grads)
        before = counts()
        plain_launches.clear()
        got.step(odd)
        after = counts()
        for a, b in zip(_state(want), _state(got)):
            assert torch.equal(a, b), f"call {call}"
        assert after.get("xpt.adamw.plain", 0) - before.get("xpt.adamw.plain", 0) == 0
        assert after["xpt.adamw.kernel"] - before.get("xpt.adamw.kernel", 0) == trained
        (leaves,) = plain_launches
        assert len(leaves) == trained
    (view, copy), = got._table.staged
    assert view.data_ptr() == got.params[kernel].data_ptr() and copy.is_contiguous()


def test_kernel_wiring_takes_several_launches_past_max_leaves(plain_launches, monkeypatch):
    """With room for two leaves a launch, an update of six trained leaves
    makes three launches, one per pair in order, with the same bits."""
    monkeypatch.setattr(ak, "MAX_LEAVES", 2)
    want, got = _optimizer("clip_on_groups", _params()), _through_kernel(_optimizer("clip_on_groups", _params()))
    launches = ak.adamw_multi_tensor.launches
    for call in range(2):
        want.step(_grads(want, call))
        got.step(_grads(got, call))
    assert ak.adamw_multi_tensor.launches - launches == 2 * 3 and [len(run) for run in plain_launches] == [2] * 6
    for a, b in zip(_state(want), _state(got)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("moments", ["fp32", "bf16"])
def test_kernel_wiring_zero2_blocks_of_two_ranks(plain_launches, monkeypatch, moments):
    """ZeRO-2 over two ranks, each rank's optimizer in this process (the
    parameters' gather stubbed out): every trained leaf's block, along its
    first dimension the ranks divide, takes the kernel, strided blocks
    (``[3, 8]``, ``[4097, 2]`` and ``[3, 4]`` split along dim 1) through
    staged targets and gradient copies. Each rank's block of the parameters and moments is
    bit-equal to that block of the unsharded ``_foreach`` run."""
    monkeypatch.setattr(opt, "all_gather_shards_", lambda leaves, mesh: None)
    case = dict(max_grad_norm=2.0, lr_mul=2.0, lr_mul_prefix="vision")
    if moments == "bf16":
        case["moment_dtype"] = torch.bfloat16
    monkeypatch.setitem(CASES, "zero2", case)
    want = _optimizer("zero2", _params())
    ranks = [_through_kernel(opt.zero2_shard(_optimizer("zero2", _params()),
                                             types.SimpleNamespace(world_size=2, rank=r), min_size=1))
             for r in range(2)]
    names = list(SHAPES)
    dims = {names[i]: dim for i, (dim, _, _) in ranks[0].shards.items()}
    assert dims == {"vision.kernel": 0, "vision.bias": 0, "cnn.conv.kernel": 1, "text.embed": 1,
                    "pos_embed": 1}
    for call in range(3):
        grads = _grads(want, call)
        want.step(grads)
        for port in ranks:
            port.step(grads)
    for r, port in enumerate(ranks):
        staged = {names[j] for view, _ in port._table.staged for j, p in enumerate(port.params) if p is view._base}
        assert staged == {"cnn.conv.kernel", "text.embed", "pos_embed"}, staged
        for i in range(len(names)):
            whole = (want.params[i], want.mu[i], want.nu[i])
            if i in port.shards:
                dim = port.shards[i][0]
                assert torch.equal(port._block(port.params[i], i), whole[0].chunk(2, dim)[r]), names[i]
                assert torch.equal(port.mu[i], whole[1].chunk(2, dim)[r]), names[i]
                assert torch.equal(port.nu[i], whole[2].chunk(2, dim)[r]), names[i]
            else:
                assert all(torch.equal(a, b) for a, b in zip((port.params[i], port.mu[i], port.nu[i]), whole))


# -- on the card -------------------------------------------------------------------


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the CUDA kernel has no CPU mode")


def _ulps(a: torch.Tensor, b: torch.Tensor) -> int:
    """Largest distance between two fp32 tensors in units in the last place
    (their bit patterns as ordered integers)."""
    def ordered(t):
        i = t.contiguous().view(torch.int32).long()
        return torch.where(i < 0, -(i & 0x7FFFFFFF), i)

    return int((ordered(a) - ordered(b)).abs().max().item()) if a.numel() else 0


def _b32_optimizer(moment_dtype=None) -> opt.GroupedAdamW:
    """The B/32 fine-tune's leaf list on the card (151 M fp32 parameters),
    in four groups (top_/base_ x decay/no_decay) at lr 1e-4."""
    from xpretrain_tpu_torch.models.clip_vip.convert import flax_param_paths
    from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel

    cfg = CLIPVipConfig.base_patch32(dtype=torch.bfloat16)
    model = CLIPViPModel(cfg, device="cuda")
    model.init_weights(torch.Generator(device="cuda").manual_seed(0))
    named = {n: p.detach().clone() for n, p in model.named_parameters()}
    port, _ = opt.build_optimizer(named, schedules.get_schedule("constant", 1e-4, 10), weight_decay=0.2,
                                  lr_mul=10.0, lr_mul_prefix="text_model", moment_dtype=moment_dtype,
                                  paths=flax_param_paths(cfg))
    return port


def _card_grads(port: opt.GroupedAdamW, call: int) -> list[torch.Tensor]:
    g = torch.Generator(device="cuda").manual_seed(10 + call)
    scale = 1.0 if call == 1 else 1e-4  # the B/32 norm at 1e-4 is below 2, at 1 far above
    return [torch.randn(p.shape, generator=g, device="cuda") * scale for p in port.params]


def _foreach_step(port: opt.GroupedAdamW, grads: list[torch.Tensor]) -> None:
    """One update of ``port`` (no accumulation) through its ``_foreach``
    chain, on the card."""
    port.prepare()
    grads = port.upcast(grads)
    port._update_plain(grads, port.grad_norm(grads) if port.max_grad_norm is not None else None)
    port._store()
    port.advance()


def _held_to_foreach(want: opt.GroupedAdamW, got: opt.GroupedAdamW, what: str) -> int:
    """m and v bit-equal, p within 2 fp32 ulps; returns the largest p distance."""
    for a, b in zip(want.mu + want.nu, got.mu + got.nu):
        assert torch.equal(a, b), what
    worst = max(_ulps(a, b) for a, b in zip(want.params, got.params))
    print(f"{what}: largest parameter distance {worst} ulp")
    assert worst <= 2, what
    return worst


@pytest.mark.cuda
@pytest.mark.parametrize("moments", ["fp32", "bf16"])
def test_kernel_matches_foreach_at_b32_on_card(moments):
    """Three updates of the B/32 leaf list (the second clipped) through the
    kernel and through the ``_foreach`` path on the same gradients: moments
    bit-equal, parameters within 2 fp32 ulps; every trained leaf takes the
    kernel, in one launch an update."""
    _card()
    moment_dtype = torch.bfloat16 if moments == "bf16" else None
    want, got = _b32_optimizer(moment_dtype), _b32_optimizer(moment_dtype)
    trained = sum(len(idx) for idx in got.groups.values())
    for call in range(3):
        grads = _card_grads(got, call)
        _foreach_step(want, grads)
        before, launches = counts(), ak.adamw_multi_tensor.launches
        got.step(grads)
        torch.cuda.synchronize()
        after = counts()
        assert after["xpt.adamw.kernel"] - before.get("xpt.adamw.kernel", 0) == trained
        assert after.get("xpt.adamw.plain", 0) == before.get("xpt.adamw.plain", 0)
        assert ak.adamw_multi_tensor.launches - launches == -(-trained // ak.MAX_LEAVES)
        _held_to_foreach(want, got, f"{moments} moments, update {call}")


@pytest.mark.cuda
def test_kernel_in_a_cuda_graph_matches_foreach_on_card():
    """The update captured in a CUDA graph (static gradients, the scalars and
    the norm read on the device) and replayed for three updates on new
    gradients equals the ``_foreach`` path's eager updates: moments
    bit-equal, parameters within 2 fp32 ulps; each replay adds the
    capture's launches to the counter."""
    _card()
    want, got = _b32_optimizer(), _b32_optimizer()
    static = [torch.zeros_like(p) for p in got.params]

    def apply():
        got.apply(static, opt.global_norm(static))

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm-up on the leaves' lists, then undo it
        saved = [t.clone() for t in _state(got)]
        got.prepare()
        apply()
        for t, s in zip(_state(got), saved):
            t.copy_(s)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    launches = ak.adamw_multi_tensor.launches
    with torch.cuda.graph(graph):
        apply()
    captured = ak.adamw_multi_tensor.launches - launches
    ak.adamw_multi_tensor.launches = launches
    assert captured == -(-sum(len(idx) for idx in got.groups.values()) // ak.MAX_LEAVES)
    for call in range(3):
        grads = _card_grads(got, call)
        _foreach_step(want, grads)
        for buf, g in zip(static, grads):
            buf.copy_(g)
        got.prepare()
        graph.replay()
        ak.adamw_multi_tensor.launches += captured
        got.advance()
        torch.cuda.synchronize()
        _held_to_foreach(want, got, f"graph replay {call}")
    assert ak.adamw_multi_tensor.launches - launches == 3 * captured


# leaf -> (size, element offsets of target, gradient, m and v from a vector
# boundary): a scalar head then vectors and a tail, a head longer than the
# leaf, offsets that differ (element by element), and none
OFFSETS = {
    "a.kernel": ((64, 128 + 7), (1, 1, 1, 1)),
    "b.bias": ((5001,), (2, 2, 2, 2)),
    "c.kernel": ((4099,), (1, 3, 0, 0)),
    "d.bias": ((3,), (1, 1, 1, 1)),
    "e.kernel": ((100, 100), (0, 0, 0, 0)),
    "f.bias": ((4097,), (0, 2, 0, 0)),
}


def _offset(t: torch.Tensor, k: int) -> torch.Tensor:
    """A copy of ``t`` that starts ``k`` elements into a buffer of its own."""
    buf = torch.zeros(t.numel() + 4, dtype=t.dtype, device=t.device)
    view = buf[k:k + t.numel()].view(t.shape)
    view.copy_(t)
    return view


@pytest.mark.cuda
@pytest.mark.parametrize("moments", ["fp32", "bf16"])
def test_kernel_takes_any_offset_on_card(moments):
    """Leaves whose target, gradient and moments start 0-3 elements past a
    vector boundary (16 bytes, 8 for bf16 moments), at one offset or at
    different ones, over three updates (the second clipped): the kernel
    takes each, moments bit-equal to the ``_foreach`` path, parameters
    within 2 fp32 ulps."""
    _card()
    moment_dtype = torch.bfloat16 if moments == "bf16" else None
    g = torch.Generator(device="cuda").manual_seed(0)
    start = {name: torch.randn(shape, generator=g, device="cuda") for name, (shape, _) in OFFSETS.items()}

    def build(offsets: bool) -> opt.GroupedAdamW:
        named = {n: _offset(t, OFFSETS[n][1][0]) if offsets else t.clone() for n, t in start.items()}
        port, _ = opt.build_optimizer(named, schedules.get_schedule("constant", 1e-3, 10), weight_decay=0.1,
                                      max_grad_norm=1.0, moment_dtype=moment_dtype)
        if offsets:
            for i, name in enumerate(port.names):
                port.mu[i] = _offset(port.mu[i], OFFSETS[name][1][2])
                port.nu[i] = _offset(port.nu[i], OFFSETS[name][1][3])
        return port

    want, got = build(False), build(True)
    assert {p.data_ptr() % 16 for p in got.params} == {0, 4, 8}
    for call in range(3):
        scale = 10.0 if call == 1 else 1e-3
        grads = [torch.randn(p.shape, generator=g, device="cuda") * scale for p in got.params]
        _foreach_step(want, grads)
        before = counts()
        got.step([_offset(t, OFFSETS[n][1][1]) for n, t in zip(got.names, grads)])
        torch.cuda.synchronize()
        assert counts()["xpt.adamw.kernel"] - before.get("xpt.adamw.kernel", 0) == len(OFFSETS)
        _held_to_foreach(want, got, f"{moments} moments at offsets, update {call}")
