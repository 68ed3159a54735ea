"""The port's profile breakdown (``xpretrain_tpu_torch/train/profiling.py``):
device kernels by op class, and the runner's ``--profile_steps`` files."""

import json

import pytest

torch = pytest.importorskip("torch")

from xpretrain_tpu_torch.cli import run_retrieval_clipvip  # noqa: E402
from xpretrain_tpu_torch.train import profiling  # noqa: E402

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
