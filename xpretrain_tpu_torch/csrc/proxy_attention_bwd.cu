// Proxy-attention backward for Hopper (sm_90a), on the CUDA cores.
//
// Replaces the Pallas TPU kernel `_attention_pallas_bwd` (cell body
// `_cell_bwd`) in xpretrain_tpu/ops/proxy_attention.py. The sequence is
// [M proxy tokens | N frames x L patches], S = M + N*L. Each of
// q/k/v/dO/dq/dk/dv is indexed [B, H, S, D] through its own (batch, head,
// row) strides with D contiguous, as in the forward kernel: a contiguous
// [B, H, S, D] tensor, or the raw [B, S, H*D] projection layout of
// `_attention_pallas_bwd_packed` (strides (S*H*D, D, H*D)), whose head split
// happens in the addresses. The M proxy rows attend all S
// keys; each frame's L rows attend [M proxies | own L patches]. With
// P = softmax(s * QK^T) over each row's allowed keys:
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(P * dP),
//   dQ = s * dS K,  dK = s * dS^T Q.
// All math is fp32 on fp32 or bf16 inputs; each output is rounded once, at
// the store. Masked pairs are never loaded or scored.
//
// On the TPU one cell holds a whole (b, head group) and sums the proxy keys'
// gradient across its unrolled frame loop. Here blocks run in parallel in no
// order, and the proxy keys take gradient from every query row, so the work
// is split in two passes that need no atomics and give the same bits on
// every run:
//
// Pass 1, query-centric (`bwd_dq_kernel`), grid (1 + N, H, B) as the
// forward's: block 0 holds the M proxy rows against all S keys, block f + 1
// holds frame f's L rows against its M + L keys. A first sweep over the keys
// gives each row's max and sum (its log-sum-exp, LSE); a second gives
// delta_i = sum_j P_ij dP_ij and dQ_i = s (sum_j P_ij dP_ij k_j -
// delta_i sum_j P_ij k_j). It writes dQ, and LSE and delta as fp32 [B, H, S]
// scratch for pass 2.
//
// Pass 2, key-centric (`bwd_dkv_kernel`), grid (1 + N, H, B): block 0 holds
// the M proxy keys against all S query rows, block f + 1 holds frame f's L
// keys against [M proxy rows | frame f's L rows]. With P_ij = exp(s_ij -
// LSE_i) it sums dV_j = sum_i P_ij dO_i and dK_j = s sum_i P_ij (dP_ij -
// delta_i) q_i, and writes each once.
//
// Both passes use the forward kernel's layout: four lanes share one register-
// resident row (pass 1: a query row; pass 2: a key row), each lane holding
// D/4 of it and of the fp32 accumulators, while the other side streams
// through shared memory in tiles of kTile rows converted to fp32. A block
// with fewer items than row groups (the proxy block: M = 4 items) gives each
// item several groups, each over its own slice of the stream, and merges
// their partial sums through shared memory; pass 1 first merges the slices'
// (max, sum) so that every slice uses the row's full LSE.
//
// What bounds it: at the B/32 train shape (B=32, H=12, S=592, D=64, bf16)
// the call reads q, k, v, dO and writes dq, dk, dv, ~204 MB (~61 us at
// 3.35 TB/s). Per allowed (row, key) pair pass 1 does 5 length-D dot
// products or axpys and pass 2 does 4, about 4.5x the forward's 2, as scalar
// fp32 FMAs fed from shared memory; those, not memory, are the limit.
// mma.sync / wgmma and TMA are later work.
//
// C interface for ctypes: xpt_proxy_attention_bwd launches both passes on
// the caller's stream and returns cudaGetLastError() after each launch (0 on
// success). It does not synchronise and allocates nothing: LSE and delta are
// contiguous [B, H, S] fp32 buffers the caller provides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kThreads = 256;               // threads per block
constexpr int kLanes = 4;                   // lanes sharing one register-resident row
constexpr int kGroups = kThreads / kLanes;  // row groups per block
constexpr int kTile = 32;                   // streamed rows staged per tile
constexpr int kPad = 4;                     // floats of row padding (bank spread)

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

// Sum of a value over the four lanes of a row group.
__device__ __forceinline__ float group_sum(float x, unsigned gmask) {
  x += __shfl_xor_sync(gmask, x, 1);
  x += __shfl_xor_sync(gmask, x, 2);
  return x;
}

// Stage `nt` streamed rows, starting at logical row t0, into fp32 tiles.
// Logical row t maps to sequence row t when `all_rows`, else proxies first
// (t < M) and then the frame that starts at `frame0`; `ar` and `br` are the
// row strides of `a` and `b`.
template <typename T, int D>
__device__ __forceinline__ void stage_rows(float* a_s, float* b_s, const T* a, const T* b,
                                           int ar, int br, int t0, int nt,
                                           bool all_rows, int M, int frame0) {
  constexpr int RS = D + kPad;
  for (int i = threadIdx.x; i < nt * D; i += kThreads) {
    const int t = i / D, d = i % D;
    const int lt = t0 + t;
    const int srow = (all_rows || lt < M) ? lt : frame0 + (lt - M);
    a_s[t * RS + d] = to_float(a[srow * ar + d]);
    if (b_s != nullptr) b_s[t * RS + d] = to_float(b[srow * br + d]);
  }
}

// Pass 1: dQ, LSE and delta of every query row.
template <typename T, int DPT>  // DPT = head dim / kLanes
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ lse,
              float* __restrict__ delta, Layout lq, Layout lk, Layout lv, Layout ldo,
              Layout ldq, int S, int M, int L, float scale) {
  constexpr int D = DPT * kLanes;
  constexpr int RS = D + kPad;
  extern __shared__ float smem[];
  float* ks = smem;                    // [kTile][RS]
  float* vs = smem + kTile * RS;       // [kTile][RS]
  // merge scratch, aliasing the tiles once they are consumed
  float* red_acc = smem;               // [kGroups][D]
  float* red_m = smem + kGroups * D;   // [kGroups]
  float* red_l = red_m + kGroups;      // [kGroups]

  const long long bz = blockIdx.z, hy = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const T* qh = q + bz * lq.b + hy * lq.h;
  const T* kh = k + bz * lk.b + hy * lk.h;
  const T* vh = v + bz * lv.b + hy * lv.h;
  const T* doh = dout + bz * ldo.b + hy * ldo.h;
  T* dqh = dq + bz * ldq.b + hy * ldq.h;
  float* lseh = lse + bh * S;
  float* deltah = delta + bh * S;

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
    const int base = g - split;  // first group of this row
    const bool active = g < rows * nsplit;  // uniform within a group
    const int qrow = row0 + r;

    float qr[DPT], dor[DPT];
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      qr[e] = active ? to_float(qh[qrow * lq.r + e * kLanes + lane]) : 0.f;
      dor[e] = active ? to_float(doh[qrow * ldo.r + e * kLanes + lane]) : 0.f;
    }

    // ---- sweep 1: the row's running max and sum over its keys ----
    float m = -INFINITY, l = 0.f;
    for (int t0 = 0; t0 < nkeys; t0 += kTile) {
      const int nt = min(kTile, nkeys - t0);
      __syncthreads();  // the previous tile (or merge scratch) is consumed
      stage_rows<T, D>(ks, nullptr, kh, nullptr, lk.r, 0, t0, nt, proxy, M, row0);
      __syncthreads();
      if (active) {
        for (int j = split; j < nt; j += nsplit) {
          const float* kr = ks + j * RS;
          float s = 0.f;
#pragma unroll
          for (int e = 0; e < DPT; ++e) s = fmaf(qr[e], kr[e * kLanes + lane], s);
          s = group_sum(s, gmask) * scale;
          if (s > m) {
            l = fmaf(l, __expf(m - s), 1.f);
            m = s;
          } else {
            l += __expf(s - m);
          }
        }
      }
    }
    float row_lse;
    if (nsplit > 1) {  // merge the key slices' (max, sum)
      __syncthreads();
      if (active && lane == 0) {
        red_m[g] = m;
        red_l[g] = l;
      }
      __syncthreads();
      float mx = -INFINITY, sum = 0.f;
      if (active) {  // an idle group's `base` may point past the scratch
        for (int s2 = 0; s2 < nsplit; ++s2) mx = fmaxf(mx, red_m[base + s2]);
        for (int s2 = 0; s2 < nsplit; ++s2)
          sum = fmaf(red_l[base + s2], __expf(red_m[base + s2] - mx), sum);
      }
      row_lse = mx + logf(sum);
    } else {
      row_lse = m + logf(l);
    }

    // ---- sweep 2: delta, sum_j P dP k_j and sum_j P k_j ----
    float dsum = 0.f, apk[DPT], ak[DPT];
#pragma unroll
    for (int e = 0; e < DPT; ++e) apk[e] = ak[e] = 0.f;
    for (int t0 = 0; t0 < nkeys; t0 += kTile) {
      const int nt = min(kTile, nkeys - t0);
      __syncthreads();
      stage_rows<T, D>(ks, vs, kh, vh, lk.r, lv.r, t0, nt, proxy, M, row0);
      __syncthreads();
      if (active) {
        for (int j = split; j < nt; j += nsplit) {
          const float* kr = ks + j * RS;
          const float* vr = vs + j * RS;
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int e = 0; e < DPT; ++e) {
            s = fmaf(qr[e], kr[e * kLanes + lane], s);
            dp = fmaf(dor[e], vr[e * kLanes + lane], dp);
          }
          s = group_sum(s, gmask) * scale;
          dp = group_sum(dp, gmask);
          const float p = __expf(s - row_lse);
          const float pdp = p * dp;
          dsum += pdp;
#pragma unroll
          for (int e = 0; e < DPT; ++e) {
            const float kv = kr[e * kLanes + lane];
            apk[e] = fmaf(pdp, kv, apk[e]);
            ak[e] = fmaf(p, kv, ak[e]);
          }
        }
      }
    }
    if (nsplit > 1) {  // merge delta over the slices
      __syncthreads();
      if (active && lane == 0) red_l[g] = dsum;
      __syncthreads();
      dsum = 0.f;
      if (active)
        for (int s2 = 0; s2 < nsplit; ++s2) dsum += red_l[base + s2];
    }
    float part[DPT];  // this slice's share of dQ / scale
#pragma unroll
    for (int e = 0; e < DPT; ++e) part[e] = fmaf(-dsum, ak[e], apk[e]);
    if (nsplit > 1) {  // merge dQ over the slices
      if (active) {
#pragma unroll
        for (int e = 0; e < DPT; ++e) red_acc[g * D + e * kLanes + lane] = part[e];
      }
      __syncthreads();
      if (active && split == 0) {
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          float acc = 0.f;
          for (int s2 = 0; s2 < nsplit; ++s2) acc += red_acc[(g + s2) * D + e * kLanes + lane];
          part[e] = acc;
        }
      }
    }
    if (active && split == 0) {
#pragma unroll
      for (int e = 0; e < DPT; ++e)
        dqh[qrow * ldq.r + e * kLanes + lane] = from_float<T>(part[e] * scale);
      if (lane == 0) {
        lseh[qrow] = row_lse;
        deltah[qrow] = dsum;
      }
    }
    p0 += rows;
  }
}

// Pass 2: dK and dV of every key row.
template <typename T, int DPT>
__global__ void __launch_bounds__(kThreads)
bwd_dkv_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
               const T* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, T* __restrict__ dk, T* __restrict__ dv,
               Layout lq, Layout lk, Layout lv, Layout ldo, Layout ldk, Layout ldv, int S,
               int M, int L, float scale) {
  constexpr int D = DPT * kLanes;
  constexpr int RS = D + kPad;
  extern __shared__ float smem[];
  float* qs = smem;                  // [kTile][RS]
  float* dos = smem + kTile * RS;    // [kTile][RS]
  float* ls = dos + kTile * RS;      // [kTile] LSE of the staged rows
  float* dls = ls + kTile;           // [kTile] delta of the staged rows
  float* red_acc = smem;             // [kGroups][D], aliasing the tiles

  const long long bz = blockIdx.z, hy = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const T* qh = q + bz * lq.b + hy * lq.h;
  const T* kh = k + bz * lk.b + hy * lk.h;
  const T* vh = v + bz * lv.b + hy * lv.h;
  const T* doh = dout + bz * ldo.b + hy * ldo.h;
  T* dkh = dk + bz * ldk.b + hy * ldk.h;
  T* dvh = dv + bz * ldv.b + hy * ldv.h;
  const float* lseh = lse + bh * S;
  const float* deltah = delta + bh * S;

  const bool proxy = blockIdx.x == 0;
  const int key0 = proxy ? 0 : M + (blockIdx.x - 1) * L;  // first key row
  const int nitems = proxy ? M : L;
  const int nrows = proxy ? S : M + L;  // logical query rows: proxies, then own frame

  const int g = threadIdx.x / kLanes;
  const int lane = threadIdx.x % kLanes;
  const unsigned gmask = 0xFu << ((threadIdx.x % 32) & ~(kLanes - 1));

  for (int p0 = 0; p0 < nitems;) {
    const int items = min(kGroups, nitems - p0);
    const int nsplit = kGroups / items;  // groups per key in this pass
    const int r = p0 + g / nsplit;
    const int split = g % nsplit;
    const bool active = g < items * nsplit;
    const int krow = key0 + r;

    float kr[DPT], vr[DPT], dka[DPT], dva[DPT];
#pragma unroll
    for (int e = 0; e < DPT; ++e) {
      kr[e] = active ? to_float(kh[krow * lk.r + e * kLanes + lane]) : 0.f;
      vr[e] = active ? to_float(vh[krow * lv.r + e * kLanes + lane]) : 0.f;
      dka[e] = dva[e] = 0.f;
    }

    for (int t0 = 0; t0 < nrows; t0 += kTile) {
      const int nt = min(kTile, nrows - t0);
      __syncthreads();  // the previous tile (or merge scratch) is consumed
      stage_rows<T, D>(qs, dos, qh, doh, lq.r, ldo.r, t0, nt, proxy, M, key0);
      for (int t = threadIdx.x; t < nt; t += kThreads) {
        const int lt = t0 + t;
        const int srow = (proxy || lt < M) ? lt : key0 + (lt - M);
        ls[t] = lseh[srow];
        dls[t] = deltah[srow];
      }
      __syncthreads();
      if (active) {
        for (int i = split; i < nt; i += nsplit) {
          const float* qr = qs + i * RS;
          const float* dr = dos + i * RS;
          float s = 0.f, dp = 0.f;
#pragma unroll
          for (int e = 0; e < DPT; ++e) {
            s = fmaf(qr[e * kLanes + lane], kr[e], s);
            dp = fmaf(dr[e * kLanes + lane], vr[e], dp);
          }
          s = group_sum(s, gmask) * scale;
          dp = group_sum(dp, gmask);
          const float p = __expf(s - ls[i]);
          const float ds = p * (dp - dls[i]);
#pragma unroll
          for (int e = 0; e < DPT; ++e) {
            dva[e] = fmaf(p, dr[e * kLanes + lane], dva[e]);
            dka[e] = fmaf(ds, qr[e * kLanes + lane], dka[e]);
          }
        }
      }
    }

    if (nsplit > 1) {  // merge the row slices of each key: dV, then dK
      __syncthreads();  // tiles no longer read: reuse them as scratch
      if (active) {
#pragma unroll
        for (int e = 0; e < DPT; ++e) red_acc[g * D + e * kLanes + lane] = dva[e];
      }
      __syncthreads();
      if (active && split == 0) {
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          float acc = 0.f;
          for (int s2 = 0; s2 < nsplit; ++s2) acc += red_acc[(g + s2) * D + e * kLanes + lane];
          dva[e] = acc;
        }
      }
      __syncthreads();
      if (active) {
#pragma unroll
        for (int e = 0; e < DPT; ++e) red_acc[g * D + e * kLanes + lane] = dka[e];
      }
      __syncthreads();
      if (active && split == 0) {
#pragma unroll
        for (int e = 0; e < DPT; ++e) {
          float acc = 0.f;
          for (int s2 = 0; s2 < nsplit; ++s2) acc += red_acc[(g + s2) * D + e * kLanes + lane];
          dka[e] = acc;
        }
      }
    }

    if (active && split == 0) {
#pragma unroll
      for (int e = 0; e < DPT; ++e) {
        dkh[krow * ldk.r + e * kLanes + lane] = from_float<T>(dka[e] * scale);
        dvh[krow * ldv.r + e * kLanes + lane] = from_float<T>(dva[e]);
      }
    }
    p0 += items;
  }
}

template <typename T, int DPT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, float* lse, float* delta, const Layout* lay, int B,
                   int H, int S, int M, int N, int L, float scale, cudaStream_t stream) {
  constexpr int D = DPT * kLanes;
  const size_t merge = (kGroups * D + 2 * kGroups) * sizeof(float);
  const size_t tiles_dq = 2 * kTile * (D + kPad) * sizeof(float);
  const size_t tiles_dkv = (2 * kTile * (D + kPad) + 2 * kTile) * sizeof(float);
  // all < 48 KB for D <= 128, so no opt-in to larger dynamic shared memory
  const size_t smem_dq = tiles_dq > merge ? tiles_dq : merge;
  const size_t smem_dkv = tiles_dkv > merge ? tiles_dkv : merge;
  const dim3 grid(1 + N, H, B);
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  bwd_dq_kernel<T, DPT><<<grid, kThreads, smem_dq, stream>>>(
      qt, kt, vt, dot, static_cast<T*>(dq), lse, delta, lay[0], lay[1], lay[2], lay[3], lay[4],
      S, M, L, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkv_kernel<T, DPT><<<grid, kThreads, smem_dkv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), lay[0], lay[1],
      lay[2], lay[3], lay[5], lay[6], S, M, L, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, const void* dout,
                              void* dq, void* dk, void* dv, float* lse, float* delta,
                              const Layout* lay, int B, int H, int S, int D, int M, int N,
                              int L, float scale, cudaStream_t stream) {
  switch (D) {
#define XPT_CASE(DIM)                                                                       \
  case DIM:                                                                                 \
    return launch<T, DIM / kLanes>(q, k, v, dout, dq, dk, dv, lse, delta, lay, B, H, S, M, N, \
                                   L, scale, stream);
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

// `strides` holds 21 element strides: (batch, head, row) of q, k, v, dO, dq,
// dk and dv.
extern "C" int xpt_proxy_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv,
                                       void* lse, void* delta, const long long* strides, int B,
                                       int H, int S, int D, int M, int N, int L, float scale,
                                       int is_bf16, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || M < 1 || N < 1 || L < 1 ||
      S != M + N * L)
    return cudaErrorInvalidValue;
  Layout lay[7];
  if (!make_layouts(strides, 7, S, D, lay)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  float* lse_f = static_cast<float*>(lse);
  float* delta_f = static_cast<float*>(delta);
  return is_bf16 ? dispatch_head_dim<__nv_bfloat16>(q, k, v, dout, dq, dk, dv, lse_f, delta_f,
                                                    lay, B, H, S, D, M, N, L, scale, st)
                 : dispatch_head_dim<float>(q, k, v, dout, dq, dk, dv, lse_f, delta_f, lay, B,
                                            H, S, D, M, N, L, scale, st);
}
