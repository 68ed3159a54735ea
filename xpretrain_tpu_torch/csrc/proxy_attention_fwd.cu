// Proxy-attention forward for Hopper (sm_90a), on the CUDA cores.
//
// Replaces the Pallas TPU kernel `_attention_pallas` (cell body `_cell_fwd`)
// in xpretrain_tpu/ops/proxy_attention.py. The sequence is
// [M proxy tokens | N frames x L patches], S = M + N*L. Each of q/k/v/o is
// indexed [B, H, S, D] through its own (batch, head, row) strides, with D
// contiguous: a contiguous [B, H, S, D] tensor has strides (H*S*D, S*D, D);
// the raw [B, S, H*D] projection layout of `_attention_pallas_packed` has
// (S*H*D, D, H*D), so the head split happens in the load addresses and no
// transpose is ever written. The M proxy rows take one softmax over all
// S keys; each frame's L rows take one joint softmax over
// [M proxies | own L patches]. Masked columns are never loaded, scored or
// exponentiated, and no mask exists anywhere.
//
// Grid (1 + N, H, B): block 0 holds the M proxy rows against all S keys,
// block f + 1 holds frame f's L rows against its M + L allowed keys. Keys are
// staged in shared memory in tiles of kKeyTile rows (converted to fp32), so
// any L fits. Four lanes share one query row, each holding D/4 of q and of the
// fp32 accumulator; a row keeps a running max and sum (online softmax), so
// one pass over its keys gives the output. A pass with fewer rows than row
// groups (the proxy block: M = 4 rows) gives each row several groups, each
// over its own slice of the keys, and merges their (max, sum, acc) through
// shared memory at the end.
//
// What bounds it: at B/32 serving shapes (B=24, H=12, S=592, D=64, bf16) the
// call moves q/k/v/o once, ~87 MB (~26 us at 3.35 TB/s), and does ~2.5 GFLOP
// of useful QK^T + PV work; scalar fp32 FMAs plus the shared-memory reads
// that feed them are the limit here, not memory. mma.sync / wgmma and TMA
// are later work.
//
// C interface for ctypes: xpt_proxy_attention_fwd returns cudaGetLastError()
// after the launch (0 on success). Launches on the caller's stream, does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;               // threads per block
constexpr int kLanes = 4;                   // lanes sharing one query row
constexpr int kGroups = kThreads / kLanes;  // row groups per block
constexpr int kKeyTile = 32;                // keys staged per tile
constexpr int kPad = 4;                     // floats of row padding: a warp's groups
                                            // reading 8 different keys hit 8 banks

// Element strides of one tensor indexed [B, H, S, D] (D has stride 1). The
// batch and head strides place a block's (b, h) once, in 64 bits; the row
// stride addresses the rows inside it in 32 bits (the C entry checks that
// S rows fit), as cheap as the contiguous layout's constant D.
struct Layout {
  long long b, h;
  int r;
};

// Layouts from the caller's (batch, head, row) element strides; false when a
// row offset inside one head would not fit in 32 bits.
inline bool make_layouts(const long long* strides, int n, int S, int D, Layout* lay) {
  for (int i = 0; i < n; ++i) {
    const long long r = strides[3 * i + 2];
    if (r < D || (S - 1) * r + D > 0x7fffffffLL) return false;
    lay[i] = {strides[3 * i], strides[3 * i + 1], static_cast<int>(r)};
  }
  return true;
}

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
proxy_attention_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                           const T* __restrict__ v, T* __restrict__ o, Layout lq,
                           Layout lk, Layout lv, Layout lo, int S, int M, int L,
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
    }
    p0 += rows;
  }
}

template <typename T, int DPT>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Layout* lay,
                   int B, int H, int S, int M, int N, int L, float scale, cudaStream_t stream) {
  constexpr int D = DPT * kLanes;
  const size_t tiles = 2 * kKeyTile * (D + kPad) * sizeof(float);
  const size_t merge = (kGroups * D + 2 * kGroups) * sizeof(float);
  const size_t smem = tiles > merge ? tiles : merge;  // < 48 KB for D <= 128
  const dim3 grid(1 + N, H, B);
  proxy_attention_fwd_kernel<T, DPT><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), lay[0], lay[1], lay[2], lay[3], S, M, L, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, void* o,
                              const Layout* lay, int B, int H, int S, int D, int M, int N,
                              int L, float scale, cudaStream_t stream) {
  switch (D) {
#define XPT_CASE(DIM) \
  case DIM:           \
    return launch<T, DIM / kLanes>(q, k, v, o, lay, B, H, S, M, N, L, scale, stream);
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
extern "C" int xpt_proxy_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                       const long long* strides, int B, int H, int S, int D,
                                       int M, int N, int L, float scale, int is_bf16,
                                       void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || M < 1 || N < 1 || L < 1 ||
      S != M + N * L)
    return cudaErrorInvalidValue;
  Layout lay[4];
  if (!make_layouts(strides, 4, S, D, lay)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  return is_bf16
             ? dispatch_head_dim<__nv_bfloat16>(q, k, v, o, lay, B, H, S, D, M, N, L, scale, st)
             : dispatch_head_dim<float>(q, k, v, o, lay, B, H, S, D, M, N, L, scale, st);
}

extern "C" const char* xpt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
