// Fused uint8 patch embedding for Hopper (sm_90a), on the CUDA cores.
//
// Replaces the Pallas TPU kernel `_pallas_patch_embed` in
// xpretrain_tpu/ops/patchify.py. For frames [N, H, W, 3] uint8 and patch P,
// the L = (H/P)(W/P) patches of each frame, flattened channel-last over
// K = P*P*3 as `extract_patches_u8` does, times the folded fp32 weight [K, D]
// (the /255 + mean/std normalization is folded in, `fold_normalization`),
// plus the fp32 bias [D], rounded once to fp32 or bf16: out [N*L, D].
//
// The gather is folded into the load addresses: row m = (frame n, patch
// gy, gx) starts at byte ((n*H + gy*P)*W + gx*P)*3, and element k of the row
// is patch row py = k / (3P) at offset k % (3P) inside it, so the patches
// are read straight from the frames and never written out. Within one patch
// row the (px, c) run is 3P contiguous bytes (96 at P = 32). The uint8 values
// widen to fp32 in registers, which is exact.
//
// A plain shared-memory tiled GEMM: a block computes a 128 x 128 tile of
// out, stepping K in tiles of 16; each step stages the uint8 patch tile (as
// fp32, transposed) and the weight tile in shared memory, and each of the 256
// threads accumulates an 8 x 8 sub-tile with fp32 FMAs (rows ty*4 + {0..3,
// 64..67}, columns tx*4 + {0..3, 64..67}, so the float4 reads of a quarter
// warp are conflict-free). The ragged edges of rows, K and D are masked.
//
// What bounds it: at CLIP-ViP B/32 serving (288 frames of 224x224, P = 32,
// K = 3072, D = 768) the call does 66.6 GFLOP of fp32 multiply-adds (~1 ms at
// 67 TFLOP/s) and moves ~97 MB (~29 us at 3.35 TB/s): the fp32 FMAs and the
// shared-memory reads that feed them are the limit. Tensor cores, cp.async or
// TMA pipelining and a split bf16 weight are later work.
//
// C interface for ctypes: xpt_patch_embed_u8 returns cudaGetLastError() after
// the launch (0 on success). Launches on the caller's stream, does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kBM = 128;  // rows (patches) per block
constexpr int kBN = 128;  // output columns per block
constexpr int kBK = 16;   // K per step

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename OutT>
__global__ void __launch_bounds__(kThreads)
patch_embed_u8_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ w,
                      const float* __restrict__ bias, OutT* __restrict__ out, int rows, int L,
                      int gw, int P, int H, int W, int K, int D) {
  __shared__ __align__(16) float as[kBK][kBM];  // patch tile, transposed: [k][row]
  __shared__ __align__(16) float bs[kBK][kBN];  // weight tile: [k][col]

  const int tid = threadIdx.x;
  const int m0 = blockIdx.y * kBM;
  const int n0 = blockIdx.x * kBN;
  const int p3 = 3 * P;
  const long long img_row = 3LL * W;  // bytes of one image row

  // the patch tile: thread -> one row, 8 consecutive k
  const int a_row = tid >> 1;
  const int a_k = (tid & 1) * 8;
  const int m = m0 + a_row;
  const bool row_ok = m < rows;
  const uint8_t* patch = frames;
  if (row_ok) {
    const int n = m / L, l = m - (m / L) * L;
    const int gy = l / gw, gx = l - (l / gw) * gw;
    patch = frames + ((static_cast<long long>(n) * H + static_cast<long long>(gy) * P) * W +
                      static_cast<long long>(gx) * P) * 3;
  }
  // the weight tile: thread -> one k, 8 consecutive columns as two float4
  const int b_k = tid >> 4;
  const int b_n = (tid & 15) * 8;
  // the 8 x 8 sub-tile
  const int tx = tid & 15, ty = tid >> 4;

  float acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kBK) {
    {  // stage the patch tile: 8 bytes of one row, walked (py, offset)
      int k = k0 + a_k;
      int py = k / p3;
      int off = k - py * p3;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        float x = 0.f;
        if (row_ok && k + j < K) x = static_cast<float>(patch[py * img_row + off]);
        as[a_k + j][a_row] = x;
        if (++off == p3) {
          off = 0;
          ++py;
        }
      }
    }
    {  // stage the weight tile (D % 4 == 0, so a float4 is all in or all out)
      const int k = k0 + b_k;
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int c = n0 + b_n + 4 * h;
        float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < K && c < D) x = *reinterpret_cast<const float4*>(w + static_cast<long long>(k) * D + c);
        *reinterpret_cast<float4*>(&bs[b_k][b_n + 4 * h]) = x;
      }
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kBK; ++kk) {
      const float4 a0 = *reinterpret_cast<const float4*>(&as[kk][ty * 4]);
      const float4 a1 = *reinterpret_cast<const float4*>(&as[kk][ty * 4 + 64]);
      const float4 b0 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4]);
      const float4 b1 = *reinterpret_cast<const float4*>(&bs[kk][tx * 4 + 64]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float b[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
    __syncthreads();
  }

  // epilogue: + bias, one rounding at the store
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = m0 + ty * 4 + (i & 3) + (i >> 2) * 64;
    if (r >= rows) continue;
    OutT* orow = out + static_cast<long long>(r) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + tx * 4 + (j & 3) + (j >> 2) * 64;
      if (c < D) orow[c] = from_float<OutT>(acc[i][j] + bias[c]);
    }
  }
}

}  // namespace

extern "C" int xpt_patch_embed_u8(const void* frames, const void* w, const void* bias, void* out,
                                  int N, int H, int W, int P, int D, int out_bf16,
                                  void* stream) {
  if (N < 1 || P < 1 || H < P || W < P || H % P || W % P || D < 1 || D % 4) {
    return cudaErrorInvalidValue;
  }
  const int gh = H / P, gw = W / P;
  const long long rows = static_cast<long long>(N) * gh * gw;
  const long long K = 3LL * P * P;
  const long long row_tiles = (rows + kBM - 1) / kBM;
  if (row_tiles > 65535 || K > (1LL << 30)) return cudaErrorInvalidValue;
  const dim3 grid((D + kBN - 1) / kBN, static_cast<unsigned>(row_tiles));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  if (out_bf16) {
    patch_embed_u8_kernel<__nv_bfloat16><<<grid, kThreads, 0, st>>>(
        f, wf, bf, static_cast<__nv_bfloat16*>(out), static_cast<int>(rows), gh * gw, gw, P, H, W,
        static_cast<int>(K), D);
  } else {
    patch_embed_u8_kernel<float><<<grid, kThreads, 0, st>>>(
        f, wf, bf, static_cast<float*>(out), static_cast<int>(rows), gh * gw, gw, P, H, W,
        static_cast<int>(K), D);
  }
  return cudaGetLastError();
}
