// Swin3D/HTWA window-attention forward for Hopper (sm_90a), on the CUDA cores.
//
// Replaces the Pallas TPU kernel `window_attention_pallas` in
// xpretrain_tpu/ops/window_attention.py. For each window bn and head h of
// contiguous q/k/v/o [Bn, H, N, d]:
//
//   O = softmax(Q K^T d^-1/2 + bias[h] + mask[bn % nW]) V
//
// with the relative-position bias [H, N, N] and the optional shifted- or
// grouped-window mask [nW, N, N] both fp32 and additive (the masks hold -100,
// not -inf, and are added as given). Everything is computed in fp32, as the
// Pallas cell does, and stored once in q's dtype.
//
// Grid (Bn, H, ceil(N / kRows)): one block holds kRows query rows of one
// (window, head). Four lanes share one query row, each holding d/4 of q and
// of the fp32 accumulator; a row keeps a running max and sum (online
// softmax), so one pass over the keys gives the output. Keys and values are
// staged in shared memory in tiles of kKeyTile rows (converted to fp32), and
// with them the tile's [kRows, kKeyTile] slice of bias + mask, read with
// coalesced loads; so any N fits in static shared memory (< 48 KB for
// d <= 128), rows past N idle, and the last key tile may be partial. The
// TPU kernel's window grouping and mask tiling are grid choices of the TPU
// and have no counterpart: the mask is indexed by bn % nW directly.
//
// What bounds it: at the LF-VILA stage-3 shape (Bn=64, H=16, N=240, d=32,
// bf16) the call moves q/k/v/o once, ~31 MB, plus the bias and mask out of
// L2; it does ~7.5 GFLOP of QK^T + PV. Scalar fp32 FMAs, and the shared-memory
// reads that feed them, are the limit, not memory. mma.sync / wgmma, TMA
// and reading the strided q/k/v in place are later work.
//
// C interface for ctypes: xpt_window_attention_fwd returns cudaGetLastError()
// after the launch (0 on success). Launches on the caller's stream, does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;               // threads per block
constexpr int kLanes = 4;                   // lanes sharing one query row
constexpr int kRows = kThreads / kLanes;    // query rows per block
constexpr int kKeyTile = 32;                // keys staged per tile
constexpr int kPad = 4;                     // floats of K/V row padding
constexpr int kBmStride = kKeyTile + 1;     // bias+mask tile row stride: the 8 rows a
                                            // warp reads at one key hit 8 banks

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T, int DPT>  // DPT = head dim / kLanes
__global__ void __launch_bounds__(kThreads)
window_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                            const T* __restrict__ v, const float* __restrict__ bias,
                            const float* __restrict__ mask, T* __restrict__ o, int H, int N,
                            int nW, float scale) {
  constexpr int D = DPT * kLanes;
  constexpr int RS = D + kPad;  // shared-memory K/V row stride (floats)
  __shared__ float ks[kKeyTile * RS];
  __shared__ float vs[kKeyTile * RS];
  __shared__ float bm[kRows * kBmStride];  // bias + mask of the tile's rows and keys

  const int bn = blockIdx.x;
  const int h = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const size_t head = ((size_t)bn * H + h) * (size_t)N * D;
  const T* qh = q + head;
  const T* kh = k + head;
  const T* vh = v + head;
  T* oh = o + head;
  const float* bh = bias + (size_t)h * N * N;
  const float* mh = mask == nullptr ? nullptr : mask + (size_t)(bn % nW) * N * N;

  const int g = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const unsigned gmask = 0xFu << ((threadIdx.x % 32) & ~(kLanes - 1));
  const int r = row0 + g;
  const bool active = r < N;  // uniform within a group

  float qr[DPT], acc[DPT];
  float m = -INFINITY, l = 0.f;
#pragma unroll
  for (int e = 0; e < DPT; ++e) {
    qr[e] = active ? to_float(qh[(size_t)r * D + e * kLanes + lane]) : 0.f;
    acc[e] = 0.f;
  }
  const int rows = min(kRows, N - row0);

  for (int t0 = 0; t0 < N; t0 += kKeyTile) {
    const int nt = min(kKeyTile, N - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < nt * D; i += kThreads) {
      const int t = i / D, d = i % D;
      ks[t * RS + d] = to_float(kh[(size_t)t0 * D + i]);
      vs[t * RS + d] = to_float(vh[(size_t)t0 * D + i]);
    }
    for (int i = threadIdx.x; i < rows * nt; i += kThreads) {
      const int rr = i / nt, j = i % nt;
      const size_t at = (size_t)(row0 + rr) * N + t0 + j;
      bm[rr * kBmStride + j] = mh == nullptr ? bh[at] : bh[at] + mh[at];
    }
    __syncthreads();
    if (active) {
      const float* bmr = bm + g * kBmStride;
      for (int j = 0; j < nt; ++j) {
        const float* kr = ks + j * RS;
        float s = 0.f;
#pragma unroll
        for (int e = 0; e < DPT; ++e) s = fmaf(qr[e], kr[e * kLanes + lane], s);
        s += __shfl_xor_sync(gmask, s, 1);
        s += __shfl_xor_sync(gmask, s, 2);
        s = s * scale + bmr[j];
        float p;
        if (s > m) {  // new running max: rescale what was summed so far
          const float corr = __expf(m - s);
          l *= corr;
#pragma unroll
          for (int e = 0; e < DPT; ++e) acc[e] *= corr;
          m = s;
          p = 1.f;
        } else {
          p = __expf(s - m);
        }
        l += p;
        const float* vr = vs + j * RS;
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[e] = fmaf(p, vr[e * kLanes + lane], acc[e]);
      }
    }
  }

  if (active) {
    const float inv = 1.f / l;
#pragma unroll
    for (int e = 0; e < DPT; ++e)
      oh[(size_t)r * D + e * kLanes + lane] = from_float<T>(acc[e] * inv);
  }
}

template <typename T, int DPT>
cudaError_t launch(const void* q, const void* k, const void* v, const float* bias,
                   const float* mask, void* o, int Bn, int H, int N, int nW, float scale,
                   cudaStream_t stream) {
  const dim3 grid(Bn, H, (N + kRows - 1) / kRows);
  window_attention_fwd_kernel<T, DPT><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), bias, mask,
      static_cast<T*>(o), H, N, nW, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, const float* bias,
                              const float* mask, void* o, int Bn, int H, int N, int D, int nW,
                              float scale, cudaStream_t stream) {
  switch (D) {
    case 16: return launch<T, 4>(q, k, v, bias, mask, o, Bn, H, N, nW, scale, stream);
    case 32: return launch<T, 8>(q, k, v, bias, mask, o, Bn, H, N, nW, scale, stream);
    case 48: return launch<T, 12>(q, k, v, bias, mask, o, Bn, H, N, nW, scale, stream);
    case 64: return launch<T, 16>(q, k, v, bias, mask, o, Bn, H, N, nW, scale, stream);
    case 80: return launch<T, 20>(q, k, v, bias, mask, o, Bn, H, N, nW, scale, stream);
    case 96: return launch<T, 24>(q, k, v, bias, mask, o, Bn, H, N, nW, scale, stream);
    case 112: return launch<T, 28>(q, k, v, bias, mask, o, Bn, H, N, nW, scale, stream);
    case 128: return launch<T, 32>(q, k, v, bias, mask, o, Bn, H, N, nW, scale, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// mask may be null (no shifted-window mask); then nW is ignored.
extern "C" int xpt_window_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* bias, const void* mask, void* o, int Bn,
                                        int H, int N, int D, int nW, float scale, int is_bf16,
                                        void* stream) {
  if (Bn < 1 || H < 1 || H > 65535 || N < 1 || (N + kRows - 1) / kRows > 65535 ||
      (mask != nullptr && (nW < 1 || Bn % nW != 0)))
    return cudaErrorInvalidValue;
  const float* b = static_cast<const float*>(bias);
  const float* m = static_cast<const float*>(mask);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? dispatch_head_dim<__nv_bfloat16>(q, k, v, b, m, o, Bn, H, N, D, nW, scale, st)
             : dispatch_head_dim<float>(q, k, v, b, m, o, Bn, H, N, D, nW, scale, st);
}
