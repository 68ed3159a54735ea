// Fused uint8 patch embedding for Hopper (sm_90a): bf16 out on the tensor
// cores, fp32 out on the CUDA cores.
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
// row the (px, c) run is 3P contiguous bytes (96 at P = 32).
//
// What bounds it: at CLIP-ViP B/32 serving (288 frames of 224x224, P = 32,
// K = 3072, D = 768) the function is 66.6 GFLOP of multiply-adds, 0.067 ms
// at the tensor cores' bf16 rate (989 TFLOP/s), and moves ~74 MB, 0.022 ms
// at 3.35 TB/s: operations bound it. The fp32 weight cannot enter the
// tensor cores as one bf16 term and keep the bf16 output within one ulp of
// the fp32 GEMM, so the bf16 kernel does the work twice (hi and lo terms):
// at best half the function's bf16 bound.
//
// bf16 out (`patch_embed_mma_kernel`): mma.sync m16n8k16, bf16 in, fp32
// accumulate. The uint8 values widen to bf16 exactly, centred: b - 128
// (-128..127 fit in bf16's 8 significant bits); the fp32 weight enters as
// hi = bf16(w) and lo = bf16(w - hi), both products summed into one fp32
// accumulator; the bias is shifted by 128 sum_k w. The result is the same
// function with only the output's one rounding left. Centring keeps the
// partial sums near the output's size: on raw 0..255 values the folded
// normalization's bias cancels a large sum, and the tensor cores' fp32
// accumulation, which does not round to nearest, left errors of that sum's
// size in the small outputs.
//
// Two prologue kernels write, once per call, into a scratch that the caller
// allocates: the two weight terms (`patch_weight_split_kernel`, [2, Kp, Dp]
// bf16, K and D padded with zeros to the tile sizes so no weight load is
// masked) and the shifted bias (`patch_bias_shift_kernel`). Then a block of
// 8 warps computes a 128 x 128 output tile (a warp 32 rows x 64 columns)
// over 32-deep K steps in a 3-stage cp.async pipeline: the patch tile is
// staged as uint8 in 16-byte cp.async runs (a run never crosses a patch row
// when 3P and 3W are multiples of 16; otherwise the rows are gathered byte
// by byte), the two weight tiles as bf16. Each thread widens the runs it
// staged once, into a bf16 patch tile (two of them, so one barrier a step
// suffices), from which ldmatrix feeds the A fragments of the warps that
// share those rows. Epilogue: + the shifted bias in fp32, one rounding at
// the store.
//
// fp32 out (`patch_embed_fp32_kernel`): a shared-memory tiled GEMM on the
// CUDA cores (TF32 would miss the 3e-5 relative bar), 128 x 128 tiles over
// K steps of 16; each of the 256 threads accumulates an 8 x 8 sub-tile with
// fp32 FMAs. The ragged edges of rows, K and D are masked.
//
// C interface for ctypes: xpt_patch_embed_u8 returns cudaGetLastError() after
// the launches (0 on success). Launches on the caller's stream, does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "mma_bf16.cuh"

namespace {

using xpt_mma::bf16;

constexpr int kThreads = 256;
constexpr int kBM = 128;  // rows (patches) per block
constexpr int kBN = 128;  // output columns per block

// ---------------------------------------------------------------- fp32

constexpr int kBK = 16;  // K per step

__global__ void __launch_bounds__(kThreads)
patch_embed_fp32_kernel(const uint8_t* __restrict__ frames, const float* __restrict__ w,
                        const float* __restrict__ bias, float* __restrict__ out, int rows, int L,
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
    float* orow = out + static_cast<long long>(r) * D;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = n0 + tx * 4 + (j & 3) + (j >> 2) * 64;
      if (c < D) orow[c] = acc[i][j] + bias[c];
    }
  }
}

// ---------------------------------------------------------------- bf16

constexpr int kMK = 32;                    // K per pipeline step
constexpr int kStages = 3;                 // cp.async pipeline depth
constexpr int kAStride = kMK + 16;         // bytes per staged patch row (16 bytes of padding)
constexpr int kBStride = kBN + 8;          // bf16 per staged weight row (16 bytes of padding)
constexpr int kACPR = kMK / 16;             // 16-byte runs of a staged patch row
constexpr int kAPasses = kBM * kACPR / kThreads;  // staged patch rows per thread
constexpr int kAStageBytes = kBM * kAStride;
constexpr int kStageBytes = kAStageBytes + 2 * kMK * kBStride * 2;  // + the hi and lo weight tiles
constexpr int kWideStride = kMK + 8;       // bf16 per widened patch row (16 bytes of padding)
constexpr int kWideBytes = kBM * kWideStride * 2;
constexpr int kMmaSmem = kStages * kStageBytes + 2 * kWideBytes;  // + two widened patch tiles

constexpr int pad_to(int x, int m) { return (x + m - 1) / m * m; }

// The bf16 kernel's scratch, `scratch_bytes`: the hi and lo bf16 terms of
// the fp32 weight, each [Kp, Dp], then the shifted fp32 bias [Dp].
constexpr long long scratch_bytes(int K, int D) {
  return 2LL * pad_to(K, kMK) * pad_to(D, kBN) * 2 + pad_to(D, kBN) * 4LL;
}

// The hi and lo bf16 terms of the fp32 weight [K, D], zero-padded to
// [Kp, Dp]: split[0] = bf16(w), split[1] = bf16(w - split[0]).
__global__ void __launch_bounds__(kThreads)
patch_weight_split_kernel(const float* __restrict__ w, bf16* __restrict__ split, int K, int D, int Kp,
                          int Dp) {
  const long long n = static_cast<long long>(Kp) * Dp;
  for (long long i = blockIdx.x * static_cast<long long>(kThreads) + threadIdx.x; i < n;
       i += static_cast<long long>(gridDim.x) * kThreads) {
    const int k = static_cast<int>(i / Dp), d = static_cast<int>(i % Dp);
    const float x = k < K && d < D ? w[static_cast<long long>(k) * D + d] : 0.f;
    const bf16 hi = __float2bfloat16(x);
    split[i] = hi;
    split[n + i] = __float2bfloat16(x - __bfloat162float(hi));
  }
}

// The bias the centred patches need: shifted[d] = bias[d] + 128 sum_k w[k, d]
// (zero past D). A block of 32 x 32 threads takes 32 columns: warp j sums
// rows k = j mod 32 of the lane's column, then one warp adds the 32 partial
// sums in order (deterministic, no atomics).
constexpr int kShiftWarps = 32;

__global__ void __launch_bounds__(32 * kShiftWarps)
patch_bias_shift_kernel(const float* __restrict__ w, const float* __restrict__ bias,
                        float* __restrict__ shifted, int K, int D) {
  __shared__ float part[kShiftWarps][33];
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int d = blockIdx.x * 32 + lane;
  float sum = 0.f;
  if (d < D)
    for (int k = warp; k < K; k += kShiftWarps) sum += w[static_cast<long long>(k) * D + d];
  part[warp][lane] = sum;
  __syncthreads();
  if (warp == 0) {
    float total = 0.f;
    for (int j = 0; j < kShiftWarps; ++j) total += part[j][lane];
    shifted[d] = d < D ? fmaf(128.f, total, bias[d]) : 0.f;
  }
}

// Bytes 2i and 2i + 1 of x (uint8 values b) as the exact bf16 pair b - 128
// (the patches centred, see below), byte 2i in the low half: each byte
// becomes the float 2^23 + b, minus 2^23 + 128.
__device__ __forceinline__ unsigned widen_u8x2(unsigned x, int i) {
  const float lo = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u | (2 * i))) - 8388736.f;
  const float hi = __uint_as_float(__byte_perm(x, 0x4B000000u, 0x7440u | (2 * i + 1))) - 8388736.f;
  const __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const unsigned*>(&h);
}

// kVec: the patch tile is staged with 16-byte cp.async (3P and 3W multiples
// of 16 and the frames 16-byte aligned); otherwise byte by byte.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 2)
patch_embed_mma_kernel(const uint8_t* __restrict__ frames, const bf16* __restrict__ split,
                       const float* __restrict__ shifted, bf16* __restrict__ out, int rows, int L, int gw,
                       int P, int H, int W, int K, int D, int Kp, int Dp) {
  using namespace xpt_mma;
  extern __shared__ __align__(16) unsigned char pe_smem[];

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int wm = warp & 3, wn = warp >> 2;  // the warp's 32 rows and 64 columns of the tile
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;
  const int p3 = 3 * P;
  const long long img_row = 3LL * W;
  const long long term = static_cast<long long>(Kp) * Dp;  // the lo terms follow the hi

  // the patch rows this thread stages (one 16-byte run of each per step):
  // tile rows tid / kACPR + i * (kThreads / kACPR), run tid % kACPR
  const int a_run = tid % kACPR;
  const uint8_t* patch[kAPasses];
  bool row_ok[kAPasses];
#pragma unroll
  for (int i = 0; i < kAPasses; ++i) {
    const int m = m0 + tid / kACPR + i * (kThreads / kACPR);
    row_ok[i] = m < rows;
    patch[i] = frames;
    if (row_ok[i]) {
      const int n = m / L, l = m - (m / L) * L;
      const int gy = l / gw, gx = l - (l / gw) * gw;
      patch[i] = frames + ((static_cast<long long>(n) * H + static_cast<long long>(gy) * P) * W +
                           static_cast<long long>(gx) * P) * 3;
    }
  }

  auto tile_a = [&](int s) { return pe_smem + s * kStageBytes; };
  auto tile_b = [&](int s) { return reinterpret_cast<bf16*>(pe_smem + s * kStageBytes + kAStageBytes); };
  auto tile_wide = [&](int i) { return reinterpret_cast<bf16*>(pe_smem + kStages * kStageBytes + i * kWideBytes); };

  auto load = [&](int s, int k0) {
    const int k = k0 + a_run * 16;
    const int py0 = k / p3, off0 = k - py0 * p3;
#pragma unroll
    for (int i = 0; i < kAPasses; ++i) {
      unsigned char* a = tile_a(s) + (tid / kACPR + i * (kThreads / kACPR)) * kAStride + a_run * 16;
      if (kVec) {
        const bool ok = row_ok[i] && k < K;  // K % 16 == 0 here: a run is all in or all out
        cp_async_16(a, ok ? patch[i] + py0 * img_row + off0 : frames, ok);
      } else {
        int py = py0, off = off0;
        alignas(16) unsigned char bytes[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          bytes[j] = row_ok[i] && k + j < K ? patch[i][py * img_row + off] : 0;
          if (++off == p3) {
            off = 0;
            ++py;
          }
        }
        *reinterpret_cast<uint4*>(a) = *reinterpret_cast<const uint4*>(bytes);
      }
    }
    // the hi and lo weight tiles: 2 x kMK rows x 16 runs of 16 bytes
    bf16* b = tile_b(s);
#pragma unroll
    for (int i = tid; i < 2 * kMK * (kBN / 8); i += kThreads) {
      const int c = i % (kBN / 8), r = (i / (kBN / 8)) % kMK, hl = i / (kMK * (kBN / 8));
      cp_async_16(b + (hl * kMK + r) * kBStride + c * 8,
                  split + hl * term + static_cast<long long>(k0 + r) * Dp + n0 + c * 8, true);
    }
  };

  float acc[2][8][4];
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.f;

  const int steps = Kp / kMK;
#pragma unroll
  for (int s = 0; s < kStages - 1; ++s) {
    if (s < steps) load(s, s * kMK);
    cp_async_commit();
  }
  for (int kt = 0; kt < steps; ++kt) {
    cp_async_wait<kStages - 2>();  // this thread's runs of step kt have landed
    // widen the runs this thread staged (its own, so visible to it) into the
    // bf16 tile of step kt; the other buffer may still be read for step kt - 1
    bf16* wide = tile_wide(kt & 1);
#pragma unroll
    for (int i = 0; i < kAPasses; ++i) {
      const int row = tid / kACPR + i * (kThreads / kACPR);
      const uint4 x = *reinterpret_cast<const uint4*>(tile_a(kt % kStages) + row * kAStride + a_run * 16);
      const uint4 lo = make_uint4(widen_u8x2(x.x, 0), widen_u8x2(x.x, 1), widen_u8x2(x.y, 0), widen_u8x2(x.y, 1));
      const uint4 hi = make_uint4(widen_u8x2(x.z, 0), widen_u8x2(x.z, 1), widen_u8x2(x.w, 0), widen_u8x2(x.w, 1));
      bf16* dst = wide + row * kWideStride + a_run * 16;
      *reinterpret_cast<uint4*>(dst) = lo;
      *reinterpret_cast<uint4*>(dst + 8) = hi;
    }
    __syncthreads();  // step kt is widened and its weights are in; step kt - 1 is consumed
    const int next = kt + kStages - 1;
    if (next < steps) load(next % kStages, next * kMK);
    cp_async_commit();
    const bf16* b = tile_b(kt % kStages);
#pragma unroll
    for (int kk = 0; kk < kMK / 16; ++kk) {
      const int frow = (lane & 7) + ((lane >> 3) & 1) * 8, fcol = kk * 16 + (lane >> 4) * 8;
      unsigned af[2][4];
#pragma unroll
      for (int mt = 0; mt < 2; ++mt) ldsm_x4(af[mt], wide + (wm * 32 + mt * 16 + frow) * kWideStride + fcol);
      const int brow = kk * 16 + frow;
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        const int col = wn * 64 + np * 16 + (lane >> 4) * 8;
        unsigned bh[4], bl[4];
        ldsm_x4_t(bh, b + brow * kBStride + col);
        ldsm_x4_t(bl, b + (kMK + brow) * kBStride + col);
#pragma unroll
        for (int mt = 0; mt < 2; ++mt) {
          mma(acc[mt][2 * np], af[mt], bh[0], bh[1]);
          mma(acc[mt][2 * np + 1], af[mt], bh[2], bh[3]);
          mma(acc[mt][2 * np], af[mt], bl[0], bl[1]);
          mma(acc[mt][2 * np + 1], af[mt], bl[2], bl[3]);
        }
      }
    }
  }

  // epilogue: + the shifted bias in fp32, one rounding at the store (D is even)
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int c = n0 + wn * 64 + nt * 8 + 2 * t4;
    if (c >= D) continue;
    const float b0 = shifted[c], b1 = shifted[c + 1];
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const int row = m0 + wm * 32 + mt * 16 + g + 8 * r;
        if (row < rows)
          *reinterpret_cast<__nv_bfloat162*>(out + static_cast<long long>(row) * D + c) =
              __floats2bfloat162_rn(acc[mt][nt][2 * r] + b0, acc[mt][nt][2 * r + 1] + b1);
      }
  }
}

}  // namespace

// `scratch` (bf16 out only): `xpt_patch_embed_scratch_bytes(P, D)` bytes,
// 16-byte aligned, for the weight's hi and lo terms and the shifted bias.
extern "C" int xpt_patch_embed_u8(const void* frames, const void* w, const void* bias, void* out,
                                  void* scratch, int N, int H, int W, int P, int D, int out_bf16,
                                  void* stream) {
  if (N < 1 || P < 1 || H < P || W < P || H % P || W % P || D < 1 || D % 4) {
    return cudaErrorInvalidValue;
  }
  const int gh = H / P, gw = W / P;
  const long long rows = static_cast<long long>(N) * gh * gw;
  const long long K = 3LL * P * P;
  const long long row_tiles = (rows + kBM - 1) / kBM;
  if (row_tiles > 65535 || K > (1LL << 30) || rows > 0x7fffffffLL) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* f = static_cast<const uint8_t*>(frames);
  const float* wf = static_cast<const float*>(w);
  const float* bf = static_cast<const float*>(bias);
  if (!out_bf16) {
    const dim3 grid((D + kBN - 1) / kBN, static_cast<unsigned>(row_tiles));
    patch_embed_fp32_kernel<<<grid, kThreads, 0, st>>>(f, wf, bf, static_cast<float*>(out),
                                                       static_cast<int>(rows), gh * gw, gw, P, H, W,
                                                       static_cast<int>(K), D);
    return cudaGetLastError();
  }
  if (scratch == nullptr || reinterpret_cast<unsigned long long>(scratch) % 16) return cudaErrorInvalidValue;
  const int Kp = pad_to(static_cast<int>(K), kMK), Dp = pad_to(D, kBN);
  bf16* sp = static_cast<bf16*>(scratch);
  const long long n = static_cast<long long>(Kp) * Dp;
  float* shifted = reinterpret_cast<float*>(sp + 2 * n);
  const long long blocks = (n + kThreads - 1) / kThreads;
  patch_weight_split_kernel<<<static_cast<int>(blocks < 2048 ? blocks : 2048), kThreads, 0, st>>>(
      wf, sp, static_cast<int>(K), D, Kp, Dp);
  patch_bias_shift_kernel<<<Dp / 32, 32 * kShiftWarps, 0, st>>>(wf, bf, shifted, static_cast<int>(K), D);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const bool vec = (3 * P) % 16 == 0 && (3LL * W) % 16 == 0 &&
                   reinterpret_cast<unsigned long long>(frames) % 16 == 0;
  const dim3 grid(Dp / kBN, static_cast<unsigned>(row_tiles));
  return xpt_mma::launch_block(vec ? &patch_embed_mma_kernel<true> : &patch_embed_mma_kernel<false>, grid,
                               kThreads, kMmaSmem, st, f, static_cast<const bf16*>(sp), shifted,
                               static_cast<bf16*>(out), static_cast<int>(rows), gh * gw, gw, P, H, W,
                               static_cast<int>(K), D, Kp, Dp);
}

// Bytes of the scratch of a bf16 call (`scratch_bytes`).
extern "C" long long xpt_patch_embed_scratch_bytes(int P, int D) { return scratch_bytes(3 * P * P, D); }

// Dynamic shared memory, in bytes, of the bf16 kernel.
extern "C" int xpt_patch_embed_smem_bytes() { return kMmaSmem; }
