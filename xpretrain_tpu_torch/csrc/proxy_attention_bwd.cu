// Proxy-attention backward for Hopper (sm_90a): bf16 on the tensor cores,
// fp32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel `_attention_pallas_bwd` (cell body
// `_cell_bwd`) in xpretrain_tpu/ops/proxy_attention.py, and
// `_attention_pallas_bwd_packed` through the stride arguments. The sequence
// is [M proxy tokens | N frames x L patches], S = M + N*L. Each of
// q/k/v/dO/dq/dk/dv is indexed [B, H, S, D] through its own (batch, head,
// row) strides with D contiguous, as in the forward kernel: a contiguous
// [B, H, S, D] tensor, or the raw [B, S, H*D] projection layout of
// `_attention_pallas_bwd_packed` (strides (S*H*D, D, H*D)), whose head split
// happens in the addresses. The M proxy rows attend all S
// keys; each frame's L rows attend [M proxies | own L patches]. With
// P = softmax(s * QK^T) over each row's allowed keys:
//   dV = P^T dO,  dP = dO V^T,  dS = P * (dP - delta),  delta = rowsum(P * dP),
//   dQ = s * dS K,  dK = s * dS^T Q.
// All math is fp32 (or bf16 products summed in fp32); each output is rounded
// once, at the store. Masked pairs are never loaded or scored.
//
// On the TPU one cell holds a whole (b, head group) and sums the proxy keys'
// gradient across its unrolled frame loop. Here blocks run in parallel in no
// order, and the proxy keys take gradient from every query row, so the work
// is split in two passes that need no atomics and give the same bits on
// every run. Both take each row's LSE (fp32 [B, H, S], natural log): the
// forward's when the caller hands it over (`lse_given`), else the entry
// first computes it (bf16: the forward kernel without its output; fp32: a
// first sweep of pass 1).
//
// Pass 1, query-centric: the proxy rows against all S keys, and each frame's
// rows against its M + L keys. One sweep over the keys gives
// delta_i = sum_j P_ij dP_ij and dQ_i = s (sum_j P_ij dP_ij k_j -
// delta_i sum_j P_ij k_j). It writes dQ and delta (fp32 [B, H, S] scratch).
//
// Pass 2, key-centric: the M proxy keys against all S query rows, and each
// frame's keys against [M proxy rows | the frame's L rows]. With P_ij =
// exp(s_ij - LSE_i) it sums dV_j = sum_i P_ij dO_i and dK_j = s sum_i P_ij
// (dP_ij - delta_i) q_i, and writes each once.
//
// bf16 (`dq_mma_kernel`, `dkv_mma_kernel`; blocks, tiles and fragments of
// proxy_attention_mma.cuh): 4 warps; a frame block holds 64 of a frame's
// rows (pass 1) or keys (pass 2), one 16-row m-tile per warp kept as A
// fragments in registers, and streams the other side in 64-row cp.async
// tiles. Pass 1 scores S = QK^T and dP = dO V^T on mma.sync, forms P from the
// LSE and accumulates (P*dP) K and P K, each left operand as hi + lo bf16
// terms; pass 2 scores S^T = K Q^T and dP^T = V dO^T, so that P^T and dS^T
// are A fragments straight away, and accumulates P^T dO and dS^T Q the same
// way. The proxy block splits the stream across its warps and merges their
// sums through shared memory in warp order.
//
// fp32 (`bwd_dq_kernel`, `bwd_dkv_kernel`, the CUDA cores; TF32 would break
// the 1e-4 bar): grid (1 + N, H, B). Four lanes share one register-resident
// row (pass 1: a query row; pass 2: a key row), each lane holding D/4 of it
// and of the fp32 accumulators, while the other side streams through shared
// memory in tiles of kTile rows converted to fp32. A block with fewer items
// than row groups (the proxy block: M = 4 items) gives each item several
// groups, each over its own slice of the stream, and merges their partial
// sums through shared memory; without a given LSE pass 1 first merges the
// slices' (max, sum) so that every slice uses the row's full LSE.
//
// What bounds it: at the B/32 train shape (B=32, H=12, S=592, D=64, bf16)
// the call reads q, k, v, dO and writes dq, dk, dv, ~204 MB (~61 us at
// 3.35 TB/s); its ~8.2 GFLOP of useful products take ~8.3 us at 989 TFLOP/s
// (~32 us with the hi/lo terms and the 64-row padding of 49/53-row frames),
// so memory bounds it. Measured by chip_smoke.py on an NVIDIA H100 80GB HBM3
// at 700 W: 0.2169 ms in bf16 on the forward's LSE, 0.2599 ms with its own
// LSE pass (SDPA's backward: 0.5205 ms; the CUDA-core bf16 code this
// replaced: 1.3378 ms), 1.0718 ms in fp32 on the forward's LSE.
//
// C interface for ctypes: xpt_proxy_attention_bwd launches its passes on the
// caller's stream and returns cudaGetLastError() after each launch (0 on
// success). It does not synchronise and allocates nothing: LSE and delta are
// contiguous [B, H, S] fp32 buffers the caller provides.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "proxy_attention_mma.cuh"

namespace {

constexpr int kThreads = 256;               // threads per block
constexpr int kLanes = 4;                   // lanes sharing one register-resident row
constexpr int kGroups = kThreads / kLanes;  // row groups per block
constexpr int kTile = 32;                   // streamed rows staged per tile
constexpr int kPad = 4;                     // floats of row padding (bank spread)

using xpt_proxy::Layout;

__device__ __forceinline__ float to_float(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_float(float x);
template <>
__device__ __forceinline__ float from_float<float>(float x) { return x; }

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

// Pass 1: dQ and delta of every query row, and its LSE unless `lse_given`.
template <typename T, int DPT>  // DPT = head dim / kLanes
__global__ void __launch_bounds__(kThreads)
bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
              const T* __restrict__ dout, T* __restrict__ dq, float* __restrict__ lse,
              float* __restrict__ delta, bool lse_given, Layout lq, Layout lk, Layout lv,
              Layout ldo, Layout ldq, int S, int M, int L, float scale) {
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

    float row_lse;
    if (lse_given) {
      row_lse = active ? lseh[qrow] : 0.f;
    } else {
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
        if (!lse_given) lseh[qrow] = row_lse;
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

// ---------------------------------------------------------------- bf16

using xpt_proxy::bf16;
using xpt_proxy::Dims;

// Pass 1 on the tensor cores: dQ and delta of every query row, from its LSE.
template <int D>
__global__ void __launch_bounds__(xpt_proxy::kMmaThreads)
dq_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
              const bf16* __restrict__ dout, bf16* __restrict__ dq, const float* __restrict__ lse,
              float* __restrict__ delta, Layout lq, Layout lk, Layout lv, Layout ldo, Layout ldq,
              int S, int M, int L, int RT, float scale, float scale_log2) {
  using namespace xpt_proxy;
  using Dm = Dims<D>;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* qs = reinterpret_cast<bf16*>(mma_smem);  // [kMmaRows][RS]: the fixed rows' q
  bf16* dos = qs + kMmaRows * Dm::RS;        // [kMmaRows][RS]: their dO
  bf16* ks = dos + kMmaRows * Dm::RS;        // [kMmaRows][RS]: streamed keys
  bf16* vs = ks + kMmaRows * Dm::RS;         // [kMmaRows][RS]: their values
  // proxy merge scratch, aliasing the tiles once they are consumed
  float* red_d = reinterpret_cast<float*>(mma_smem);  // [4][16]
  float* red_a1 = red_d + 64;                     // [4][16][D]
  float* red_a2 = red_a1 + 64 * D;                // [4][16][D]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const long long bz = blockIdx.z, hy = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const bf16* qh = q + bz * lq.b + hy * lq.h;
  const bf16* kh = k + bz * lk.b + hy * lk.h;
  const bf16* vh = v + bz * lv.b + hy * lv.h;
  const bf16* doh = dout + bz * ldo.b + hy * ldo.h;
  bf16* dqh = dq + bz * ldq.b + hy * ldq.h;
  const float* lseh = lse + bh * S;
  float* deltah = delta + bh * S;
  const Block blk(S, M, L, RT);

  for (int pass = 0; pass < blk.passes; ++pass) {
    const int r0 = blk.row0(pass), nr = blk.nrows(pass), wrow = blk.warp_row(warp);
    __syncthreads();  // the previous pass's merge scratch is consumed
    load_rows<D>(qs, qh, lq.r, blk.staged(), 0, nr, 0, r0);
    load_rows<D>(dos, doh, ldo.r, blk.staged(), 0, nr, 0, r0);
    cp_async_wait_all();
    __syncthreads();
    unsigned qa[Dm::KS][4], da[Dm::KS][4];
    load_a<D>(qa, qs, wrow, lane);
    load_a<D>(da, dos, wrow, lane);
    float lse2[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int row = wrow + g + 8 * r;
      lse2[r] = row < nr ? lseh[r0 + row] * kLog2e : 0.f;
    }

    // a1 = sum_j P dP k_j, a2 = sum_j P k_j, dsum = sum_j P dP (this lane's keys)
    float a1[Dm::NT][4], a2[Dm::NT][4], dsum[2] = {0.f, 0.f};
    zero<D>(a1);
    zero<D>(a2);
    for (int t0 = 0; t0 < blk.nstream; t0 += kMmaRows) {
      const int nt = min(kMmaRows, blk.nstream - t0);
      __syncthreads();  // the previous tile is consumed
      load_rows<D>(ks, kh, lk.r, kMmaRows, t0, nt, M, blk.frame0);
      load_rows<D>(vs, vh, lv.r, kMmaRows, t0, nt, M, blk.frame0);
      cp_async_wait_all();
      __syncthreads();
      for (int c = blk.chunk0(warp); c * 16 < nt; c += blk.chunk_step()) {
        float p[2][4], pdp[2][4];
        scores<D>(p, qa, ks, c * 16, lane);
        scores<D>(pdp, da, vs, c * 16, lane);  // dP
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = c * 16 + j * 8 + 2 * t4 + (e & 1);
            p[j][e] = key < nt ? exp2f(p[j][e] * scale_log2 - lse2[e >> 1]) : 0.f;
            pdp[j][e] *= p[j][e];
            dsum[e >> 1] += pdp[j][e];
          }
        unsigned hi[4], lo[4];
        split_a(pdp, hi, lo);
        accumulate<D>(a1, hi, lo, ks, c * 16, lane);
        split_a(p, hi, lo);
        accumulate<D>(a2, hi, lo, ks, c * 16, lane);
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) dsum[r] = quad_sum(dsum[r]);

    if (!blk.proxy) {
#pragma unroll
      for (int n = 0; n < Dm::NT; ++n)
#pragma unroll
        for (int e = 0; e < 4; ++e) a1[n][e] = fmaf(-dsum[e >> 1], a2[n][e], a1[n][e]);
      const float mul[2] = {scale, scale};
      store_rows<D>(dqh, ldq.r, r0 + wrow, nr - wrow, a1, mul, lane);
      if (t4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (wrow + g + 8 * r < nr) deltah[r0 + wrow + g + 8 * r] = dsum[r];
      }
      continue;
    }
    // the proxy block: sum the four warps' key slices, in warp order
    __syncthreads();  // the tiles are no longer read
    if (t4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) red_d[warp * 16 + g + 8 * r] = dsum[r];
    }
    frag_to_smem<D>(red_a1 + warp * 16 * D, a1, lane);
    frag_to_smem<D>(red_a2 + warp * 16 * D, a2, lane);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * D; i += kMmaThreads) {
      const int row = i / D, d = i % D;
      float ds = 0.f, s1 = 0.f, s2 = 0.f;
      for (int w = 0; w < 4; ++w) {
        ds += red_d[w * 16 + row];
        s1 += red_a1[(w * 16 + row) * D + d];
        s2 += red_a2[(w * 16 + row) * D + d];
      }
      dqh[(r0 + row) * ldq.r + d] = __float2bfloat16(fmaf(-ds, s2, s1) * scale);
      if (d == 0) deltah[r0 + row] = ds;
    }
  }
}

// Pass 2 on the tensor cores: dK and dV of every key row.
template <int D>
__global__ void __launch_bounds__(xpt_proxy::kMmaThreads)
dkv_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               const bf16* __restrict__ dout, const float* __restrict__ lse,
               const float* __restrict__ delta, bf16* __restrict__ dk, bf16* __restrict__ dv,
               Layout lq, Layout lk, Layout lv, Layout ldo, Layout ldk, Layout ldv, int S, int M,
               int L, int RT, float scale, float scale_log2) {
  using namespace xpt_proxy;
  using Dm = Dims<D>;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* ks = reinterpret_cast<bf16*>(mma_smem);  // [kMmaRows][RS]: the fixed keys
  bf16* vs = ks + kMmaRows * Dm::RS;         // [kMmaRows][RS]: their values
  bf16* qs = vs + kMmaRows * Dm::RS;         // [kMmaRows][RS]: streamed query rows
  bf16* dos = qs + kMmaRows * Dm::RS;        // [kMmaRows][RS]: their dO
  float* ls = reinterpret_cast<float*>(dos + kMmaRows * Dm::RS);  // [kMmaRows]: LSE * log2 e
  float* dls = ls + kMmaRows;                                     // [kMmaRows]: delta
  // proxy merge scratch, aliasing the tiles once they are consumed
  float* red_dk = reinterpret_cast<float*>(mma_smem);  // [4][16][D]
  float* red_dv = red_dk + 64 * D;                 // [4][16][D]

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int t4 = lane & 3;
  const long long bz = blockIdx.z, hy = blockIdx.y;
  const size_t bh = (size_t)blockIdx.z * gridDim.y + blockIdx.y;
  const bf16* qh = q + bz * lq.b + hy * lq.h;
  const bf16* kh = k + bz * lk.b + hy * lk.h;
  const bf16* vh = v + bz * lv.b + hy * lv.h;
  const bf16* doh = dout + bz * ldo.b + hy * ldo.h;
  bf16* dkh = dk + bz * ldk.b + hy * ldk.h;
  bf16* dvh = dv + bz * ldv.b + hy * ldv.h;
  const float* lseh = lse + bh * S;
  const float* deltah = delta + bh * S;
  const Block blk(S, M, L, RT);  // fixed side: keys; streamed side: query rows

  for (int pass = 0; pass < blk.passes; ++pass) {
    const int r0 = blk.row0(pass), nr = blk.nrows(pass), wrow = blk.warp_row(warp);
    __syncthreads();  // the previous pass's merge scratch is consumed
    load_rows<D>(ks, kh, lk.r, blk.staged(), 0, nr, 0, r0);
    load_rows<D>(vs, vh, lv.r, blk.staged(), 0, nr, 0, r0);
    cp_async_wait_all();
    __syncthreads();
    unsigned ka[Dm::KS][4], va[Dm::KS][4];
    load_a<D>(ka, ks, wrow, lane);
    load_a<D>(va, vs, wrow, lane);

    float dka[Dm::NT][4], dva[Dm::NT][4];
    zero<D>(dka);
    zero<D>(dva);
    for (int t0 = 0; t0 < blk.nstream; t0 += kMmaRows) {
      const int nt = min(kMmaRows, blk.nstream - t0);
      __syncthreads();  // the previous tile is consumed
      load_rows<D>(qs, qh, lq.r, kMmaRows, t0, nt, M, blk.frame0);
      load_rows<D>(dos, doh, ldo.r, kMmaRows, t0, nt, M, blk.frame0);
      for (int t = threadIdx.x; t < kMmaRows; t += kMmaThreads) {
        const int lt = t0 + t;
        const int srow = lt < M ? lt : blk.frame0 + (lt - M);
        // a row past the stream gets P = exp2(-inf) = 0 and contributes nothing
        ls[t] = t < nt ? lseh[srow] * kLog2e : INFINITY;
        dls[t] = t < nt ? deltah[srow] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();
      for (int c = blk.chunk0(warp); c * 16 < nt; c += blk.chunk_step()) {
        float pt[2][4], dst[2][4];  // P^T, then dS^T: rows are keys, columns query rows
        scores<D>(pt, ka, qs, c * 16, lane);
        scores<D>(dst, va, dos, c * 16, lane);  // dP^T
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int col = c * 16 + j * 8 + 2 * t4 + (e & 1);
            pt[j][e] = exp2f(pt[j][e] * scale_log2 - ls[col]);
            dst[j][e] = pt[j][e] * (dst[j][e] - dls[col]);
          }
        unsigned hi[4], lo[4];
        split_a(pt, hi, lo);
        accumulate<D>(dva, hi, lo, dos, c * 16, lane);
        split_a(dst, hi, lo);
        accumulate<D>(dka, hi, lo, qs, c * 16, lane);
      }
    }

    if (!blk.proxy) {
      const float mul_k[2] = {scale, scale}, mul_v[2] = {1.f, 1.f};
      store_rows<D>(dkh, ldk.r, r0 + wrow, nr - wrow, dka, mul_k, lane);
      store_rows<D>(dvh, ldv.r, r0 + wrow, nr - wrow, dva, mul_v, lane);
      continue;
    }
    // the proxy block: sum the four warps' row slices, in warp order
    __syncthreads();  // the tiles are no longer read
    frag_to_smem<D>(red_dk + warp * 16 * D, dka, lane);
    frag_to_smem<D>(red_dv + warp * 16 * D, dva, lane);
    __syncthreads();
    for (int i = threadIdx.x; i < nr * D; i += kMmaThreads) {
      const int row = i / D, d = i % D;
      float sk = 0.f, sv = 0.f;
      for (int w = 0; w < 4; ++w) {
        sk += red_dk[(w * 16 + row) * D + d];
        sv += red_dv[(w * 16 + row) * D + d];
      }
      dkh[(r0 + row) * ldk.r + d] = __float2bfloat16(sk * scale);
      dvh[(r0 + row) * ldv.r + d] = __float2bfloat16(sv);
    }
  }
}

template <int D>
cudaError_t launch_bf16(const void* q, const void* k, const void* v, const void* dout, void* dq,
                        void* dk, void* dv, float* lse, float* delta, bool lse_given,
                        const Layout* lay, int B, int H, int S, int M, int N, int L, float scale,
                        cudaStream_t stream) {
  using namespace xpt_proxy;
  const dim3 grid = proxy_grid(B, H, N, L);
  const int RT = (L + kMmaRows - 1) / kMmaRows;
  const float scale_log2 = static_cast<float>(static_cast<double>(scale) * 1.4426950408889634);
  const bf16* qt = static_cast<const bf16*>(q);
  const bf16* kt = static_cast<const bf16*>(k);
  const bf16* vt = static_cast<const bf16*>(v);
  const bf16* dot = static_cast<const bf16*>(dout);
  cudaError_t err;
  if (!lse_given) {  // the forward kernel without its output: the same LSE bits
    err = launch_with_smem(fwd_mma_kernel<D, false>, grid, fwd_smem_bytes(D, false), stream, qt,
                           kt, static_cast<const bf16*>(nullptr), static_cast<bf16*>(nullptr), lse,
                           lay[0], lay[1], lay[2], lay[3], S, M, L, RT, scale_log2);
    if (err != cudaSuccess) return err;
  }
  err = launch_with_smem(dq_mma_kernel<D>, grid, bwd_smem_bytes(D), stream, qt, kt, vt, dot,
                         static_cast<bf16*>(dq), static_cast<const float*>(lse), delta, lay[0],
                         lay[1], lay[2], lay[3], lay[4], S, M, L, RT, scale, scale_log2);
  if (err != cudaSuccess) return err;
  return launch_with_smem(dkv_mma_kernel<D>, grid, bwd_smem_bytes(D), stream, qt, kt, vt, dot,
                          static_cast<const float*>(lse), static_cast<const float*>(delta),
                          static_cast<bf16*>(dk), static_cast<bf16*>(dv), lay[0], lay[1], lay[2],
                          lay[3], lay[5], lay[6], S, M, L, RT, scale, scale_log2);
}

// ---------------------------------------------------------------- fp32

template <typename T, int DPT>
cudaError_t launch(const void* q, const void* k, const void* v, const void* dout, void* dq,
                   void* dk, void* dv, float* lse, float* delta, bool lse_given,
                   const Layout* lay, int B, int H, int S, int M, int N, int L, float scale,
                   cudaStream_t stream) {
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
      qt, kt, vt, dot, static_cast<T*>(dq), lse, delta, lse_given, lay[0], lay[1], lay[2], lay[3],
      lay[4], S, M, L, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  bwd_dkv_kernel<T, DPT><<<grid, kThreads, smem_dkv, stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), lay[0], lay[1],
      lay[2], lay[3], lay[5], lay[6], S, M, L, scale);
  return cudaGetLastError();
}

cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, const void* dout,
                              void* dq, void* dk, void* dv, float* lse, float* delta,
                              bool lse_given, const Layout* lay, int B, int H, int S, int D, int M,
                              int N, int L, float scale, bool is_bf16, cudaStream_t stream) {
  switch (D) {
#define XPT_CASE(DIM)                                                                            \
  case DIM:                                                                                      \
    return is_bf16 ? launch_bf16<DIM>(q, k, v, dout, dq, dk, dv, lse, delta, lse_given, lay, B, \
                                      H, S, M, N, L, scale, stream)                             \
                   : launch<float, DIM / kLanes>(q, k, v, dout, dq, dk, dv, lse, delta,         \
                                                 lse_given, lay, B, H, S, M, N, L, scale, stream);
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
// dk and dv. `lse` holds the forward's per-row log-sum-exp when `lse_given`,
// else it receives it. bf16 runs on the tensor cores and needs what 16-byte
// cp.async needs (16-byte aligned pointers, strides multiples of 8); fp32
// runs on the CUDA cores.
extern "C" int xpt_proxy_attention_bwd(const void* q, const void* k, const void* v,
                                       const void* dout, void* dq, void* dk, void* dv,
                                       void* lse, void* delta, int lse_given,
                                       const long long* strides, int B, int H, int S, int D,
                                       int M, int N, int L, float scale, int is_bf16,
                                       void* stream) {
  if (B < 1 || B > 65535 || H < 1 || H > 65535 || M < 1 || N < 1 || L < 1 ||
      S != M + N * L)
    return cudaErrorInvalidValue;
  Layout lay[7];
  if (!xpt_proxy::make_layouts(strides, 7, S, D, lay)) return cudaErrorInvalidValue;
  const void* ptrs[7] = {q, k, v, dout, dq, dk, dv};
  if (is_bf16 && !xpt_proxy::cp_async_ok(ptrs, strides, 7)) return cudaErrorInvalidValue;
  return dispatch_head_dim(q, k, v, dout, dq, dk, dv, static_cast<float*>(lse),
                           static_cast<float*>(delta), lse_given != 0, lay, B, H, S, D, M, N, L,
                           scale, is_bf16 != 0, static_cast<cudaStream_t>(stream));
}
