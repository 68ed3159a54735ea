// Proxy-attention forward for Hopper (sm_90a): bf16 on the tensor cores,
// fp32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel `_attention_pallas` (cell body `_cell_fwd`)
// in xpretrain_tpu/ops/proxy_attention.py, and `_attention_pallas_packed`
// through the stride arguments. The sequence is
// [M proxy tokens | N frames x L patches], S = M + N*L. Each of q/k/v/o is
// indexed [B, H, S, D] through its own (batch, head, row) strides, with D
// contiguous: a contiguous [B, H, S, D] tensor has strides (H*S*D, S*D, D);
// the raw [B, S, H*D] projection layout of `_attention_pallas_packed` has
// (S*H*D, D, H*D), so the head split happens in the load addresses and no
// transpose is ever written. The M proxy rows take one softmax over all
// S keys; each frame's L rows take one joint softmax over
// [M proxies | own L patches]. Masked columns are never loaded, scored or
// exponentiated, and no mask exists anywhere. Optionally each row's LSE
// (natural log, fp32 [B, H, S]) is written for the backward.
//
// bf16 (`xpt_proxy::fwd_mma_kernel`, proxy_attention_mma.cuh): 4 warps, a
// frame block holds 64 rows of one frame (one 16-row m-tile per warp) and
// streams its keys [M proxies | own L] in 64-key tiles staged with cp.async;
// S = QK^T on mma.sync m16n8k16, an online softmax in registers, and PV with
// P entering as hi + lo bf16 terms (what the 1-ulp bar needs). The proxy
// block gives each warp its own 16-key chunk of every tile and merges the
// four (max, sum, acc) through shared memory.
//
// fp32 (`proxy_attention_fwd_kernel` below, the CUDA cores; TF32 would break
// the 2e-5 bar): grid (1 + N, H, B), block 0 holds the M proxy rows against
// all S keys, block f + 1 holds frame f's L rows against its M + L allowed
// keys. Keys are staged in shared memory in tiles of kKeyTile rows, so any L
// fits. Four lanes share one query row, each holding D/4 of q and of the
// fp32 accumulator; a row keeps a running max and sum (online softmax), so
// one pass over its keys gives the output. A pass with fewer rows than row
// groups (the proxy block: M = 4 rows) gives each row several groups, each
// over its own slice of the keys, and merges their (max, sum, acc) through
// shared memory at the end.
//
// What bounds it: at B/32 serving shapes (B=24, H=12, S=592, D=64, bf16) the
// call moves q/k/v/o once, ~87 MB (~26 us at 3.35 TB/s), and does ~2.5 GFLOP
// of useful QK^T + PV work (~2.5 us at 989 TFLOP/s; ~6 us with the hi/lo
// split and the 49-row/53-key frames padded to 64): memory bounds it.
// Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3 at 700 W: 0.0593 ms
// in bf16 (SDPA with the proxy mask: 0.1357 ms; the CUDA-core bf16 code
// this replaced: 0.2847 ms), 0.2966 ms in fp32.
//
// C interface for ctypes: xpt_proxy_attention_fwd returns cudaGetLastError()
// after the launch (0 on success). Launches on the caller's stream, does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "proxy_attention_mma.cuh"

namespace {

constexpr int kThreads = 256;               // threads per block
constexpr int kLanes = 4;                   // lanes sharing one query row
constexpr int kGroups = kThreads / kLanes;  // row groups per block
constexpr int kKeyTile = 32;                // keys staged per tile
constexpr int kPad = 4;                     // floats of row padding: a warp's groups
                                            // reading 8 different keys hit 8 banks

using xpt_proxy::Layout;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

template <typename T, int DPT>  // DPT = head dim / kLanes
__global__ void __launch_bounds__(kThreads)
proxy_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, float* __restrict__ lse,
                           Layout lq, Layout lk, Layout lv, Layout lo, int S, int M, int L,
                           float scale) {
  constexpr int D = DPT * kLanes;
  constexpr int RS = D + kPad;  // shared-memory row stride (floats)
  extern __shared__ float smem[];
  float* ks = smem;                  // [kKeyTile][RS]
  float* vs = smem + kKeyTile * RS;  // [kKeyTile][RS]
  // merge scratch, aliasing the tiles once they are consumed
  float* red_acc = smem;                   // [kGroups][D]
  float* red_m = smem + kGroups * D;       // [kGroups]
  float* red_l = red_m + kGroups;          // [kGroups]

  const long long bz = blockIdx.z, hy = blockIdx.y;
  const T* qh = q + bz * lq.b + hy * lq.h;
  const T* kh = k + bz * lk.b + hy * lk.h;
  const T* vh = v + bz * lv.b + hy * lv.h;
  T* oh = o + bz * lo.b + hy * lo.h;
  float* lseh = lse == nullptr ? nullptr : lse + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * S;

  const bool proxy = blockIdx.x == 0;
  const int row0 = proxy ? 0 : M + (blockIdx.x - 1) * L;  // first query row
  const int nrows = proxy ? M : L;
  const int nkeys = proxy ? S : M + L;  // logical keys: proxies, then own frame

  const int g = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const unsigned gmask = 0xFu << ((threadIdx.x % 32) & ~(kLanes - 1));

  for (int p0 = 0; p0 < nrows;) {
    const int rows = min(kGroups, nrows - p0);
    const int nsplit = kGroups / rows;  // groups per row in this pass
    const int r = p0 + g / nsplit;
    const int split = g % nsplit;
    const bool active = g < rows * nsplit;  // uniform within a group

    float qr[DPT], acc[DPT];
    float m = -INFINITY, l = 0.f;
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      qr[e] = active ? to_float(qh[(row0 + r) * lq.r + e * kLanes + lane]) : 0.f;
      acc[e] = 0.f;
    }

    for (int t0 = 0; t0 < nkeys; t0 += kKeyTile) {
      const int nt = min(kKeyTile, nkeys - t0);
      __syncthreads();  // the previous tile (or merge scratch) is consumed
      for (int i = threadIdx.x; i < nt * D; i += kThreads) {
        const int t = i / D, d = i % D;
        const int lt = t0 + t;
        const int srow = (proxy || lt < M) ? lt : row0 + (lt - M);
        ks[t * RS + d] = to_float(kh[srow * lk.r + d]);
        vs[t * RS + d] = to_float(vh[srow * lv.r + d]);
      }
      __syncthreads();
      if (active) {
        for (int j = split; j < nt; j += nsplit) {
          const float* kr = ks + j * RS;
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < DPT; ++e) s = fmaf(qr[e], kr[e * kLanes + lane], s);
          s += __shfl_xor_sync(gmask, s, 1);
          s += __shfl_xor_sync(gmask, s, 2);
          s *= scale;
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

    if (nsplit > 1) {  // merge the key slices of each row
      __syncthreads();  // tiles no longer read: reuse them as scratch
      if (active) {
#pragma unroll
        for (int e = 0; e < DPT; ++e) red_acc[g * D + e * kLanes + lane] = acc[e];
        if (lane == 0) {
          red_m[g] = m;
          red_l[g] = l;
        }
      }
      __syncthreads();
      if (active && split == 0) {
        float mx = -INFINITY;
        for (int s2 = 0; s2 < nsplit; ++s2) mx = fmaxf(mx, red_m[g + s2]);
        m = mx;
        l = 0.f;
#pragma unroll
        for (int e = 0; e < DPT; ++e) acc[e] = 0.f;
        for (int s2 = 0; s2 < nsplit; ++s2) {
          const float w = __expf(red_m[g + s2] - mx);  // 0 for a slice with no keys
          l = fmaf(red_l[g + s2], w, l);
#pragma unroll
          for (int e = 0; e < DPT; ++e)
            acc[e] = fmaf(w, red_acc[(g + s2) * D + e * kLanes + lane], acc[e]);
        }
      }
    }

    if (active && split == 0) {
      const float inv = 1.f / l;
#pragma unroll
      for (int e = 0; e < DPT; ++e)
        oh[(row0 + r) * lo.r + e * kLanes + lane] = from_float<T>(acc[e] * inv);
      if (lseh != nullptr && lane == 0) lseh[row0 + r] = m + logf(l);
    }
    p0 += rows;
  }
}

template <int DPT>
cudaError_t launch_fp32(const void* q, const void* k, const void* v, void* o, float* lse,
                        const Layout* lay, int B, int H, int S, int M, int N, int L, float scale,
                        cudaStream_t stream) {
  constexpr int D = DPT * kLanes;
  const size_t tiles = 2 * kKeyTile * (D + kPad) * sizeof(float);
  const size_t merge = (kGroups * D + 2 * kGroups) * sizeof(float);
  const size_t smem = tiles > merge ? tiles : merge;  // < 48 KB for D <= 128
  const dim3 grid(1 + N, H, B);
  proxy_attention_fwd_kernel<float, DPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), lse, lay[0], lay[1], lay[2], lay[3], S, M, L, scale);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, void* o, float* lse,
                        const Layout* lay, int B, int H, int S, int M, int N, int L, float scale,
                        cudaStream_t stream) {
  using xpt_proxy::bf16;
  return xpt_proxy::launch_with_smem(
      xpt_proxy::fwd_mma_kernel<D, true>, xpt_proxy::proxy_grid(B, H, N, L),
      xpt_proxy::fwd_smem_bytes(D, true), stream, static_cast<const bf16*>(q),
      static_cast<const bf16*>(k), static_cast<const bf16*>(v), static_cast<bf16*>(o), lse,
      lay[0], lay[1], lay[2], lay[3], S, M, L, (L + xpt_proxy::kMmaRows - 1) / xpt_proxy::kMmaRows,
      static_cast<float>(static_cast<double>(scale) * 1.4426950408889634));
}

cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, void* o, float* lse,
                              const Layout* lay, int B, int H, int S, int D, int M, int N, int L,
                              float scale, bool is_bf16, cudaStream_t stream) {
  switch (D) {
#define XPT_CASE(DIM)                                                                      \
  case DIM:                                                                                \
    return is_bf16 ? launch_bf16<DIM>(q, k, v, o, lse, lay, B, H, S, M, N, L, scale, stream) \
                   : launch_fp32<DIM / kLanes>(q, k, v, o, lse, lay, B, H, S, M, N, L, scale, stream);
    XPT_CASE(16)
    XPT_CASE(32)
    XPT_CASE(48)
    XPT_CASE(64)
    XPT_CASE(80)
    XPT_CASE(96)
    XPT_CASE(112)
    XPT_CASE(128)
#undef XPT_CASE
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// `strides` holds 12 element strides: (batch, head, row) of q, k, v and o.
// `lse` is null or a contiguous fp32 [B, H, S] buffer that receives each
// row's log-sum-exp. bf16 runs on the tensor cores and needs what 16-byte
// cp.async needs (16-byte aligned pointers, strides multiples of 8); fp32
// runs on the CUDA cores.
extern "C" int xpt_proxy_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       void* lse, const long long* strides, int B, int H, int S,
                                       int D, int M, int N, int L, float scale, int is_bf16,
                                       void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || M < 1 || N < 1 || L < 1 ||
      S != M + N * L)
    return cudaErrorInvalidValue;
  Layout lay[4];
  if (!xpt_proxy::make_layouts(strides, 4, S, D, lay)) return cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  if (is_bf16 && !xpt_proxy::cp_async_ok(ptrs, strides, 4)) return cudaErrorInvalidValue;
  return dispatch_head_dim(q, k, v, o, static_cast<float*>(lse), lay, B, H, S, D, M, N, L, scale,
                           is_bf16 != 0, static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory, in bytes, that a bf16 launch at head dim D asks for:
// `kernel` 0 is the forward, 1 its LSE-only form, 2 and 3 the backward's
// passes (-1 for another kernel).
extern "C" int xpt_proxy_attention_smem_bytes(int D, int kernel) {
  switch (kernel) {
    case 0: return xpt_proxy::fwd_smem_bytes(D, true);
    case 1: return xpt_proxy::fwd_smem_bytes(D, false);
    case 2:
    case 3: return xpt_proxy::bwd_smem_bytes(D);
    default: return -1;
  }
}

extern "C" const char* xpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
