"""The port's profile breakdown (``xpretrain_tpu_torch/train/profiling.py``):
device kernels by op class, and the runner's ``--profile_steps`` files; the
spans of ``xpretrain_tpu_torch/utils/profiling.py``: their records, their
host events under ``torch.profiler``, none under a graph tool, and where the
train step, the loop's ingest and the serving towers put them. The test
marked ``cuda`` needs a card: ``python -m pytest tests/test_torch_profiling.py
-m cuda --noconftest``."""

import contextlib
import json
import threading
import time

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.cli import run_retrieval_clipvip  # noqa: E402
from xpretrain_tpu_torch.models.clip_vip.convert import flax_param_paths  # noqa: E402
from xpretrain_tpu_torch.models.clip_vip.model import CLIPVipConfig, CLIPViPModel, VipConfig  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.pretrain import LfVilaConfig  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.swin3d import Swin3DConfig  # noqa: E402
from xpretrain_tpu_torch.models.lf_vila.tasks import LfVilaRetrieval  # noqa: E402
from xpretrain_tpu_torch.ops.losses import build_loss_fn  # noqa: E402
from xpretrain_tpu_torch.optim.optimizer import build_optimizer  # noqa: E402
from xpretrain_tpu_torch.optim.schedules import get_schedule  # noqa: E402
from xpretrain_tpu_torch.parallel.train_step import TrainState, batch_to_device, make_train_step  # noqa: E402
from xpretrain_tpu_torch.serving.towers import LfVilaTowers  # noqa: E402
from xpretrain_tpu_torch.train import profiling  # noqa: E402
from xpretrain_tpu_torch.train.loop import drive_train_loop, stack_batches  # noqa: E402
from xpretrain_tpu_torch.train.trainer import ClipVipTrainer  # noqa: E402
from xpretrain_tpu_torch.utils.profiling import RING, records, span  # noqa: E402

# device kernel names as torch.profiler reports them on an H100 (abridged)
KERNELS = {
    "void (anonymous namespace)::proxy_attention_fwd_kernel<__nv_bfloat16, 16>(...)":
        "proxy attention forward kernel",
    "void (anonymous namespace)::bwd_dq_kernel<__nv_bfloat16, 16>(...)":
        "proxy attention backward kernel, dq pass",
    "void (anonymous namespace)::bwd_dkv_kernel<__nv_bfloat16, 16>(...)":
        "proxy attention backward kernel, dk/dv pass",
    "void xpt_proxy::fwd_mma_kernel<64, true>(...)": "proxy attention forward kernel",
    "void (anonymous namespace)::dq_mma_kernel<64>(...)": "proxy attention backward kernel, dq pass",
    "void (anonymous namespace)::dkv_mma_kernel<64>(...)": "proxy attention backward kernel, dk/dv pass",
    "void (anonymous namespace)::window_attention_fwd_kernel<__nv_bfloat16, 8>(...)":
        "window attention forward kernel",
    "void (anonymous namespace)::window_attention_fwd_kernel<8>(float const*, ...)": "window attention forward kernel",
    "void (anonymous namespace)::window_mma_kernel<32>(__nv_bfloat16 const*, ...)": "window attention forward kernel",
    "void (anonymous namespace)::patch_embed_mma_kernel<true>(unsigned char const*, ...)": "patch embed kernel",
    "(anonymous namespace)::patch_weight_split_kernel(float const*, __nv_bfloat16*, int, int, int, int)":
        "patch embed kernel",
    "(anonymous namespace)::patch_embed_fp32_kernel(unsigned char const*, float const*, ...)": "patch embed kernel",
    "(anonymous namespace)::patch_bias_shift_kernel(float const*, float const*, float*, int, int, int)":
        "patch embed kernel",
    "nvjet_tst_192x192_64x3_2x1_v_bz_coopB_NNN": "GEMMs",
    "sm80_xmma_gemm_f32f32_f32f32_f32_nn_n_tilesize32x32x8_stage3": "GEMMs",
    "void cublasLt::splitKreduce_kernel<32, 16, int, float, __nv_bfloat16>(...)": "GEMMs",
    "void at::native::(anonymous namespace)::multi_tensor_apply_kernel<TensorListMetadata<2>>(...)":
        "AdamW and norms (_foreach)",
    "void at::native::(anonymous namespace)::vectorized_layer_norm_kernel<float, float, false>(...)":
        "LayerNorm forward and backward",
    "void at::native::(anonymous namespace)::GammaBetaBackwardCUDAKernelTemplate<float>(...)":
        "LayerNorm forward and backward",
    "void at::native::unrolled_elementwise_kernel<at::native::direct_copy_kernel_cuda(...)>(...)":
        "copies and casts",
    "void at::native::vectorized_elementwise_kernel<8, at::native::bfloat16_copy_kernel_cuda(...)>(...)":
        "copies and casts",
    "Memcpy HtoD (Pinned -> Device)": "copies and casts",
    "void at::native::reduce_kernel<128, 4, at::native::ReduceOp<c10::BFloat16>>(...)": "reductions",
    "void (anonymous namespace)::softmax_warp_forward<float, float, float, 7>(...)": "softmax",
    "void at::native::vectorized_elementwise_kernel<8, at::native::CUDAFunctor_add<c10::BFloat16>>(...)":
        "elementwise",
    "void at::native::index_elementwise_kernel<128, 4>(...)": "elementwise",
    "void at::native::(anonymous namespace)::embedding_backward_feature_kernel<float>(...)": "other",
}


@pytest.mark.parametrize("name", sorted(KERNELS))
def test_op_class(name):
    assert profiling.op_class(name) == KERNELS[name]


def test_op_class_table_counts_device_kernels_per_step():
    rows = [
        # host ops carry the device time of the kernels they launch: not counted
        {"name": "aten::mm", "device_type": "CPU", "count": 4, "self_device_us": 900.0},
        {"name": "nvjet_tst_a", "device_type": "CUDA", "count": 4, "self_device_us": 600.0},
        {"name": "sm80_xmma_gemm_b", "device_type": "CUDA", "count": 2, "self_device_us": 300.0},
        {"name": "bwd_dq_kernel<float, 16>", "device_type": "CUDA", "count": 2, "self_device_us": 300.0},
    ]
    table = profiling.op_class_table(rows, steps=2)
    assert [r["class"] for r in table] == ["GEMMs", "proxy attention backward kernel, dq pass"]
    assert table[0]["device_ms_per_step"] == pytest.approx(0.45)
    assert table[0]["launches_per_step"] == 3
    assert table[0]["share"] == pytest.approx(0.75)
    assert table[1]["device_ms_per_step"] == pytest.approx(0.15)


def test_device_us_sums_device_rows_once():
    """A call's device time: its kernels, copies and sets, not the host ops
    that launched them (``tools/profile_train_step.device_ms``)."""
    rows = [
        {"name": "aten::addmm", "device_type": "CPU", "count": 1, "self_device_us": 50.0},
        {"name": "patch_weight_split_kernel", "device_type": "CUDA", "count": 1, "self_device_us": 9.0},
        {"name": "patch_embed_mma_kernel<true>", "device_type": "CUDA", "count": 1, "self_device_us": 41.0},
        {"name": "Memset (Device)", "device_type": "CUDA", "count": 1, "self_device_us": 1.0},
    ]
    assert profiling.device_us(rows) == 51.0
    assert profiling.device_us(rows[:1]) == 0.0


def test_runner_profile_steps_writes_the_breakdown(tmp_path):
    run_retrieval_clipvip.main([
        "--dummy_data", "1", "--clip_size", "tiny", "--num_frm", "2", "--crop_img_size", "32",
        "--train_batch_size", "8", "--val_batch_size", "24", "--num_train_steps", "3",
        "--validate_at_start", "0", "--valid_steps", "100", "--save_steps", "100", "--bf16", "0",
        "--profile_start_step", "1", "--profile_steps", "2", "--device", "cpu",
        "--output_dir", str(tmp_path),
    ])
    profile = tmp_path / "profile"
    for name in ("trace.json", "key_averages.txt", "key_averages.json", "op_classes.json"):
        assert (profile / name).is_file(), name
    rows = json.loads((profile / "key_averages.json").read_text())
    assert any(r["name"] == "aten::mm" and r["device_type"] == "CPU" for r in rows)
    breakdown = json.loads((profile / "op_classes.json").read_text())
    # the two profiled steps; the CPU runs no device kernel
    assert breakdown == {"steps": 2, "classes": []}


def test_ab_tool_reads_the_proxy_kernels_registers(tmp_path):
    """``tools/ab_proxy_kernels.py`` picks the D=64 proxy kernels' register
    counts out of an ``nvcc -Xptxas -v`` log, by kernel and dtype."""
    from xpretrain_tpu_torch.tools import ab_proxy_kernels

    log = tmp_path / "lib.log"
    log.write_text(
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113bwd_dq_kernelIfLi16EEEvPKT_' for 'sm_90a'\n"
        "ptxas info    : Used 123 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN12_GLOBAL__N_126proxy_attention_fwd_kernelI13__nv_bfloat16Li16EEEvPKT_' for 'sm_90a'\n"
        "ptxas info    : Used 80 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114bwd_dkv_kernelIfLi32EEEvPKT_' for 'sm_90a'\n"
        "ptxas info    : Used 200 registers, used 1 barriers\n"
    )
    assert ab_proxy_kernels.registers(str(log)) == {"bwd_dq_kernel_fp32": 123, "proxy_attention_fwd_kernel_bf16": 80}


def test_ab_tool_reads_the_tensor_core_kernels_registers(tmp_path):
    """The bf16 tensor-core kernels' entries (the forward, its LSE-only form
    and the two backward passes, D=64) are read too; other head dims are not."""
    from xpretrain_tpu_torch.tools import ab_proxy_kernels

    log = tmp_path / "lib.log"
    log.write_text(
        "ptxas info    : Compiling entry function "
        "'_ZN9xpt_proxy14fwd_mma_kernelILi64ELb1EEEvPK13__nv_bfloat16' for 'sm_90a'\n"
        "ptxas info    : Used 94 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function "
        "'_ZN9xpt_proxy14fwd_mma_kernelILi64ELb0EEEvPK13__nv_bfloat16' for 'sm_90a'\n"
        "ptxas info    : Used 63 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_113dq_mma_kernelILi64EEEvPK13' for 'sm_90a'\n"
        "ptxas info    : Used 168 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114dkv_mma_kernelILi64EEEvPK13' for 'sm_90a'\n"
        "ptxas info    : Used 165 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_114dkv_mma_kernelILi128EEEvPK13' for 'sm_90a'\n"
        "ptxas info    : Used 255 registers, used 1 barriers\n"
    )
    assert ab_proxy_kernels.registers(str(log)) == {
        "fwd_mma_kernel": 94, "fwd_mma_kernel_lse_only": 63, "dq_mma_kernel": 168, "dkv_mma_kernel": 165,
    }


def test_ab_tool_reads_the_window_and_patch_kernels_registers(tmp_path):
    """The window-attention (d=32) and patch-embed kernels' entries are read
    under the names of both designs: the CUDA-core ones of either dtype, and
    the tensor-core ones with the fp32 CUDA-core kernels beside them."""
    from xpretrain_tpu_torch.tools import ab_proxy_kernels

    log = tmp_path / "lib.log"
    entries = {
        "_ZN12_GLOBAL__N_127window_attention_fwd_kernelI13__nv_bfloat16Li8EEEvPKT_": 56,
        "_ZN12_GLOBAL__N_121patch_embed_u8_kernelIfEEvPKhPKfS4_PT_": 122,
        "_ZN12_GLOBAL__N_127window_attention_fwd_kernelILi8EEEvPKfS2_": 59,
        "_ZN12_GLOBAL__N_117window_mma_kernelILi32EEEvPK13__nv_bfloat16": 64,
        "_ZN12_GLOBAL__N_117window_mma_kernelILi64EEEvPK13__nv_bfloat16": 90,
        "_ZN12_GLOBAL__N_122patch_embed_mma_kernelILb1EEEvPKhPK13__nv_bfloat16": 128,
        "_ZN12_GLOBAL__N_125patch_weight_split_kernelEPKfP13__nv_bfloat16iiii": 26,
        "_ZN12_GLOBAL__N_123patch_embed_fp32_kernelEPKhPKfS3_Pfiiiiiiii": 123,
        "_ZN12_GLOBAL__N_123patch_bias_shift_kernelEPKfS1_Pfiii": 18,
    }
    log.write_text("".join(f"ptxas info    : Compiling entry function '{e}' for 'sm_90a'\n"
                           f"ptxas info    : Used {n} registers, used 1 barriers\n" for e, n in entries.items()))
    assert ab_proxy_kernels.registers(str(log)) == {
        "window_attention_fwd_kernel_bf16": 56, "patch_embed_u8_kernel_fp32": 122, "window_attention_fwd_kernel": 59,
        "window_mma_kernel": 64, "patch_embed_mma_kernel": 128, "patch_weight_split_kernel": 26,
        "patch_embed_fp32_kernel": 123, "patch_bias_shift_kernel": 18,
    }


# -- spans (utils/profiling.py) -----------------------------------------------------------


def _since(name: str, t0: int) -> list:
    return [r for r in records(name) if r.start_ns >= t0]


def _cpu_profile():
    return torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])


def _xpt_events(prof) -> list:
    return [e for e in prof.profiler.kineto_results.events() if e.name().startswith("xpt.")]


@pytest.mark.parametrize("profiled", [False, True], ids=["profiler_off", "profiler_on"])
def test_span_records_its_interval_parent_and_profiled(profiled):
    t0 = time.time_ns()
    with _cpu_profile() if profiled else contextlib.nullcontext():
        with span("xpt.test.outer"):
            with span("xpt.test.inner"):
                time.sleep(0.002)
    t1 = time.time_ns()
    (outer,), (inner,) = _since("xpt.test.outer", t0), _since("xpt.test.inner", t0)
    assert t0 <= outer.start_ns <= inner.start_ns and inner.end_ns <= outer.end_ns <= t1
    assert inner.end_ns - inner.start_ns >= 2_000_000
    assert (outer.parent, inner.parent) == (None, "xpt.test.outer")
    assert outer.profiled is profiled and inner.profiled is profiled


def test_span_parent_is_the_innermost_open_span_of_its_own_thread():
    t0 = time.time_ns()

    def other():
        with span("xpt.test.thread"):
            pass

    with span("xpt.test.main"):
        worker = threading.Thread(target=other)
        worker.start()
        worker.join(timeout=30)
    assert not worker.is_alive()
    (rec,) = _since("xpt.test.thread", t0)
    assert rec.parent is None


def test_ring_keeps_the_newest_records():
    for i in range(RING + 3):
        with span("xpt.test.ring"):
            pass
    kept = records("xpt.test.ring")
    assert len(kept) == RING
    assert all(a.start_ns <= b.start_ns for a, b in zip(kept, kept[1:]))


def test_span_is_one_host_event_under_the_profiler():
    """Each span is one host event of its name, on the ring's clock (Unix
    ns, kineto's for host events), and no event on another device."""
    t0 = time.time_ns()
    with _cpu_profile() as prof:
        for _ in range(3):
            with span("xpt.test.event"):
                torch.ones(64) @ torch.ones(64)
    events = _xpt_events(prof)
    assert len(events) == 3 and all(e.name() == "xpt.test.event" for e in events)
    assert all("CPU" in str(e.device_type()) for e in events)
    recs = _since("xpt.test.event", t0)
    for e, r in zip(sorted(events, key=lambda e: e.start_ns()), recs):
        assert abs(e.start_ns() - r.start_ns) < 200_000
        assert abs(e.end_ns() - r.end_ns) < 200_000


class _Doubles(torch.nn.Module):
    def forward(self, x):
        with span("xpt.test.graph_tool"):
            return x * 2


@pytest.mark.parametrize("tool", ["export", "export_strict", "make_fx", "compile"])
def test_span_is_inert_under_graph_tools(tool):
    """Nothing recorded while a graph tool traces, and nothing of the span
    in the graph: the program is the one multiply."""
    before = len(records("xpt.test.graph_tool"))
    x = torch.ones(3)
    if tool.startswith("export"):
        graph = torch.export.export(_Doubles(), (x,), strict=tool == "export_strict").graph
    elif tool == "make_fx":
        from torch.fx.experimental.proxy_tensor import make_fx

        graph = make_fx(_Doubles())(x).graph
    else:
        torch._dynamo.reset()
        out = torch.compile(_Doubles(), fullgraph=True, backend="eager")(x)
        assert torch.equal(out, x * 2)
        graph = None
    assert len(records("xpt.test.graph_tool")) == before
    if graph is not None:
        calls = [n.target for n in graph.nodes if n.op == "call_function"]
        assert calls == [torch.ops.aten.mul.Tensor]


IMAGE, SEQ, TEMPORAL, BATCH = 32, 16, 2, 4


def _clipvip_state() -> TrainState:
    cfg = CLIPVipConfig.tiny_debug(image_size=IMAGE, vip=VipConfig(temporal_size=TEMPORAL), dtype=torch.float32)
    model = CLIPViPModel(cfg, device="cpu")
    model.init_weights(torch.Generator().manual_seed(0))
    opt, _ = build_optimizer(dict(model.named_parameters()), get_schedule("cosine", 1e-3, 10, warmup_ratio=0.2),
                             paths=flax_param_paths(cfg))
    return TrainState(step=0, model=model, optimizer=opt)


def _host_batch(seed: int) -> dict:
    rng = np.random.default_rng(seed)
    ids = np.zeros((BATCH, SEQ), np.int64)
    ids[:, 0], ids[:, 1:6], ids[:, 6] = 49406, rng.integers(10, 400, size=(BATCH, 5)), 49407
    return {"video": rng.integers(0, 256, size=(BATCH, TEMPORAL, IMAGE, IMAGE, 3), dtype=np.uint8),
            "text_input_ids": ids, "text_input_mask": (ids > 0).astype(np.int64)}


STEP_PARTS = ("xpt.step.forward", "xpt.step.backward", "xpt.step.optimizer")


@pytest.mark.parametrize("k", [1, 2])
def test_train_step_spans(k):
    """One call of the public step is one ``xpt.step``; each of its K eager
    steps holds a forward, a backward and an optimizer span."""
    step = make_train_step(ClipVipTrainer._apply_train, build_loss_fn("NCELearnableTempLoss"), "cpu",
                           steps_per_call=k)
    host = _host_batch(0) if k == 1 else stack_batches([_host_batch(i) for i in range(k)])
    batch = {key: torch.from_numpy(v) for key, v in host.items()}
    state = _clipvip_state()
    t0 = time.time_ns()
    step(state, batch, 7)
    (call,) = _since("xpt.step", t0)
    assert call.parent is None and state.step == k
    for name in STEP_PARTS:
        parts = _since(name, t0)
        assert len(parts) == k and all(p.parent == "xpt.step" for p in parts), name
        assert all(call.start_ns <= p.start_ns <= p.end_ns <= call.end_ns for p in parts)
    fwd, bwd, opt = (_since(name, t0) for name in STEP_PARTS)
    assert all(f.end_ns <= b.start_ns and b.end_ns <= o.start_ns for f, b, o in zip(fwd, bwd, opt))


def test_ingest_spans_stack_and_place():
    """``stack_batches`` is one ``xpt.ingest.stack`` a call and
    ``batch_to_device``'s placing one ``xpt.ingest.place`` a batch, whatever
    its leaves."""
    place = batch_to_device("cpu")
    t0 = time.time_ns()
    with span("xpt.test.ingest"):
        stacked = stack_batches([_host_batch(i) for i in range(3)])
        placed = place(stacked)
    place(_host_batch(0))
    assert placed["video"].shape == (3, BATCH, TEMPORAL, IMAGE, IMAGE, 3)
    stacks, places = _since("xpt.ingest.stack", t0), _since("xpt.ingest.place", t0)
    assert len(stacks) == 1 and len(places) == 2
    assert stacks[0].parent == places[0].parent == "xpt.test.ingest" and places[1].parent is None
    assert stacks[0].end_ns <= places[0].start_ns


def test_lfvila_towers_spans():
    """``encode_video`` holds one upload, ``encode_text`` two (ids and mask)."""
    towers = LfVilaTowers(LfVilaRetrieval(LfVilaConfig.tiny(video=Swin3DConfig.tiny(), sample_frame=8)), "cpu")
    rng = np.random.default_rng(0)
    t0 = time.time_ns()
    towers.encode_video(rng.integers(0, 256, size=(1, 8, 96, 160, 3), dtype=np.uint8))
    towers.encode_text(rng.integers(1, 1000, size=(1, 4, 8)), np.ones((1, 4, 8), np.int64))
    (video,), (text,) = _since("xpt.serve.encode_video", t0), _since("xpt.serve.encode_text", t0)
    uploads = _since("xpt.serve.upload", t0)
    assert [u.parent for u in uploads] == ["xpt.serve.encode_video"] + ["xpt.serve.encode_text"] * 2
    assert video.parent is None and text.parent is None and video.end_ns <= text.start_ns
    assert video.start_ns <= uploads[0].start_ns <= uploads[0].end_ns <= video.end_ns
    assert all(text.start_ns <= u.start_ns <= u.end_ns <= text.end_ns for u in uploads[1:])


def test_drive_train_loop_profile_holds_the_spans(tmp_path):
    """A ``profile_num_steps`` trace of the loop at K = 2 shows the loop's,
    the ingest's and the step's spans on its host rows."""
    state = _clipvip_state()
    step = make_train_step(ClipVipTrainer._apply_train, build_loss_fn("NCELearnableTempLoss"), "cpu",
                           steps_per_call=2)
    loader = (_host_batch(i) for i in range(4))
    drive_train_loop(train_step=step, loader=loader, state=state, place_batch=batch_to_device("cpu"), seed=0,
                     num_train_steps=4, steps_per_call=2, profile_dir=str(tmp_path), profile_start_step=2,
                     profile_num_steps=2)
    names = {e.get("name") for e in json.loads((tmp_path / "trace.json").read_text())["traceEvents"]}
    want = {"xpt.loop.next_batch", "xpt.ingest.stack", "xpt.ingest.place", "xpt.step", *STEP_PARTS}
    assert want <= names


@pytest.mark.cuda
def test_spans_add_no_device_event_on_a_card():
    """On a card the span is a host event only: no kineto event off the CPU
    carries an ``xpt.`` name, while the kernel it frames is traced."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    x = torch.ones(256, 256, device="cuda")
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU, torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with span("xpt.test.cuda"):
            y = x @ x
        torch.cuda.synchronize()
    assert float(y[0, 0]) == 256.0
    events = list(prof.profiler.kineto_results.events())
    named = [e for e in events if e.name().startswith("xpt.")]
    assert len(named) == 1 and "CPU" in str(named[0].device_type())
    assert any("CPU" not in str(e.device_type()) for e in events)
