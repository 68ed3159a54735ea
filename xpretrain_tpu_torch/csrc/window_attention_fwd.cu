// Swin3D/HTWA window-attention forward for Hopper (sm_90a): bf16 on the
// tensor cores, fp32 on the CUDA cores.
//
// Replaces the Pallas TPU kernel `window_attention_pallas` in
// xpretrain_tpu/ops/window_attention.py. For each window bn and head h of
// q/k/v [Bn, H, N, d]:
//
//   O = softmax(Q K^T d^-1/2 + bias[h] + mask[bn % nW]) V
//
// with the relative-position bias [H, N, N] and the optional shifted- or
// grouped-window mask [nW, N, N] both fp32 and additive (the masks hold -100,
// not -inf, and are added as given). Scores, softmax and sums are fp32, as in
// the Pallas cell, and the output is stored once in q's dtype. q, k, v and o
// are read through their own (batch, head, row) element strides with d
// contiguous (`xpt_mma::Layout`), so the model's q/k/v, views of one fused
// qkv projection, are read in place. The TPU kernel's window grouping and
// mask tiling are grid choices of the TPU and have no counterpart: the mask
// is indexed by bn % nW directly.
//
// What bounds it: at the LF-VILA stage-3 shape (Bn=64, H=16, N=240, d=32,
// bf16, the shifted blocks' mask) the call moves q/k/v/o once, 63 MB, and
// the bias and mask, 5.5 MB (0.020 ms at 3.35 TB/s: bytes bound the
// function); it does 7.5 GFLOP of QK^T + PV (0.008 ms at 989 TFLOP/s). Each
// (window, head) reads its N x N slice of bias and mask again, 0.47 GB from
// L2 in all at that shape, so L2, not HBM, is the nearest limit of this
// design.
//
// bf16 (`window_mma_kernel`): grid (Bn, H, ceil(N / 64)); a block of 4 warps
// holds 64 query rows of one (window, head), one 16-row m-tile per warp, and
// streams the window's keys and values through shared memory in 64-row tiles
// staged with 16-byte cp.async (rows past N zero-filled). A warp scores a
// whole tile at once on mma.sync m16n8k16, into fp32 fragments that start as
// (bias + mask) / scale: the bias read in fp32 from L2 straight into them
// while the tile lands (a key pair as one float2 when N is even), the mask,
// which the window's heads share, from a 64 x 64 tile staged beside K and V
// with coalesced loads (scattered loads of both kept too many requests in
// flight). One multiply by scale then gives Q K^T scale + bias + mask, moved
// to the log2 domain. One online-softmax
// step per 64-key tile, and P enters PV as hi + lo bf16 terms (one bf16
// rounding of P misses the 1-ulp bar; the tests emulate both). The fp32
// accumulator is rounded once at the store. Ragged N (G*N = 120, a tail of
// 77) masks the last m- and n-tiles: keys past N score -inf, rows past N
// are not stored. Scoring the whole tile gives each warp 16 independent
// products and 32 independent exponentials a step, where 16-key chunks
// would chain four dependent softmax steps.
//
// fp32 (`window_attention_fwd_kernel`, the CUDA cores; TF32 would miss the
// 2e-5 bar): grid (Bn, H, ceil(N / kRows)); four lanes share one query row,
// each holding d/4 of q and of the fp32 accumulator, with an online softmax
// over keys and values staged in shared memory in tiles of kKeyTile rows with
// the tile's [kRows, kKeyTile] slice of bias + mask.
//
// C interface for ctypes: xpt_window_attention_fwd returns cudaGetLastError()
// after the launch (0 on success). Launches on the caller's stream, does not
// synchronise and allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "mma_bf16.cuh"

namespace {

using xpt_mma::bf16;
using xpt_mma::Layout;

// ---------------------------------------------------------------- fp32

constexpr int kThreads = 256;               // threads per block
constexpr int kLanes = 4;                   // lanes sharing one query row
constexpr int kRows = kThreads / kLanes;    // query rows per block
constexpr int kKeyTile = 32;                // keys staged per tile
constexpr int kPad = 4;                     // floats of K/V row padding
constexpr int kBmStride = kKeyTile + 1;     // bias+mask tile row stride: the 8 rows a
                                            // warp reads at one key hit 8 banks

template <int DPT>  // DPT = head dim / kLanes
__global__ void __launch_bounds__(kThreads)
window_attention_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                            const float* __restrict__ v, const float* __restrict__ bias,
                            const float* __restrict__ mask, float* __restrict__ o, Layout lq,
                            Layout lk, Layout lv, Layout lo, int N, int nW, float scale) {
  constexpr int D = DPT * kLanes;
  constexpr int RS = D + kPad;  // shared-memory K/V row stride (floats)
  __shared__ float ks[kKeyTile * RS];
  __shared__ float vs[kKeyTile * RS];
  __shared__ float bm[kRows * kBmStride];  // bias + mask of the tile's rows and keys

  const long long bn = blockIdx.x, h = blockIdx.y;
  const int row0 = blockIdx.z * kRows;
  const float* qh = q + bn * lq.b + h * lq.h;
  const float* kh = k + bn * lk.b + h * lk.h;
  const float* vh = v + bn * lv.b + h * lv.h;
  float* oh = o + bn * lo.b + h * lo.h;
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
    qr[e] = active ? qh[r * lq.r + e * kLanes + lane] : 0.f;
    acc[e] = 0.f;
  }
  const int rows = min(kRows, N - row0);

  for (int t0 = 0; t0 < N; t0 += kKeyTile) {
    const int nt = min(kKeyTile, N - t0);
    __syncthreads();  // the previous tile is consumed
    for (int i = threadIdx.x; i < nt * D; i += kThreads) {
      const int t = i / D, d = i % D;
      ks[t * RS + d] = kh[(t0 + t) * lk.r + d];
      vs[t * RS + d] = vh[(t0 + t) * lv.r + d];
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
    for (int e = 0; e < DPT; ++e) oh[r * lo.r + e * kLanes + lane] = acc[e] * inv;
  }
}

// ---------------------------------------------------------------- bf16

// The bias at flat offsets `at` and `at + 1` of its [N, N] slice; a key
// past N reads nothing. `pairs`: the pair is 8-byte aligned (N even, an
// aligned base), so one float2 load.
__device__ __forceinline__ float2 bias_pair(const float* bh, int at, bool v0, bool v1, bool pairs) {
  float2 x = make_float2(0.f, 0.f);
  if (pairs) {
    if (v0) x = __ldg(reinterpret_cast<const float2*>(bh + at));  // N even, the key even: both in
  } else {
    if (v0) x.x = __ldg(bh + at);
    if (v1) x.y = __ldg(bh + at + 1);
  }
  return x;
}

constexpr int kMaskStride = xpt_mma::kMmaRows + 8;  // floats per staged mask row (32 bytes of padding)

// Dynamic shared memory of `window_mma_kernel<D>`: the query tile and the
// K and V tiles, 64 rows each, and with a mask its 64 x 64 fp32 tile.
constexpr int mma_smem_bytes(int D, bool masked) {
  return 3 * xpt_mma::kMmaRows * (D + 8) * 2 + (masked ? xpt_mma::kMmaRows * kMaskStride * 4 : 0);
}

// Stage the mask's [64 rows from r0] x [64 keys from t0] tile (zeros past N)
// into `ms`: 16-byte cp.async runs when `async` (N % 4 == 0 and a 16-byte
// aligned base), else coalesced scalar loads.
__device__ __forceinline__ void load_mask(float* ms, const float* mh, int N, int r0, int t0, bool async) {
  using namespace xpt_mma;
  if (async) {
    for (int i = threadIdx.x; i < kMmaRows * (kMmaRows / 4); i += kMmaThreads) {
      const int r = i / (kMmaRows / 4), c = 4 * (i % (kMmaRows / 4));
      const bool valid = r0 + r < N && t0 + c < N;
      cp_async_16(ms + r * kMaskStride + c, valid ? mh + (r0 + r) * N + t0 + c : mh, valid);
    }
  } else {
    for (int i = threadIdx.x; i < kMmaRows * kMmaRows; i += kMmaThreads) {
      const int r = i / kMmaRows, c = i % kMmaRows;
      ms[r * kMaskStride + c] = r0 + r < N && t0 + c < N ? __ldg(mh + (r0 + r) * N + t0 + c) : 0.f;
    }
  }
}

// d <= 32 (the LF-VILA shapes) is held to 96 registers, 5 blocks an SM: 7-10%
// faster than its natural 128 at the b=8 stage shapes, where 80 was slower
// (tools/ab_proxy_kernels.py); larger d needs its registers.
template <int D>
__global__ void __launch_bounds__(xpt_mma::kMmaThreads, D <= 32 ? 5 : 1)
window_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
                  const float* __restrict__ bias, const float* __restrict__ mask, bf16* __restrict__ o,
                  Layout lq, Layout lk, Layout lv, Layout lo, int N, int nW, float scale, bool pairs,
                  bool mask_async) {
  using namespace xpt_mma;
  const float inv_scale = 1.f / scale, scale_log2 = scale * kLog2e;
  using Dm = Dims<D>;
  extern __shared__ __align__(16) unsigned char win_smem[];
  bf16* qs = reinterpret_cast<bf16*>(win_smem);  // [kMmaRows][RS]
  bf16* ks = qs + kMmaRows * Dm::RS;             // [kMmaRows][RS]
  bf16* vs = ks + kMmaRows * Dm::RS;             // [kMmaRows][RS]
  float* ms = reinterpret_cast<float*>(vs + kMmaRows * Dm::RS);  // [kMmaRows][kMaskStride], with a mask

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const long long bn = blockIdx.x, h = blockIdx.y;
  const int r0 = blockIdx.z * kMmaRows, nr = min(kMmaRows, N - r0), wrow = 16 * warp;
  const bf16* qh = q + bn * lq.b + h * lq.h;
  const bf16* kh = k + bn * lk.b + h * lk.h;
  const bf16* vh = v + bn * lv.b + h * lv.h;
  bf16* oh = o + bn * lo.b + h * lo.h;
  const float* bh = bias + (size_t)h * N * N;
  const float* mh = mask == nullptr ? nullptr : mask + (size_t)(bn % nW) * N * N;
  const bool active = wrow < nr;  // the warp has rows in the window (warp-uniform)
  // the bias rows of fragment rows g and g + 8 (a row past N reads row N - 1
  // and is never stored)
  const int brow[2] = {min(r0 + wrow + g, N - 1) * N, min(r0 + wrow + g + 8, N - 1) * N};

  load_rows<D>(qs, qh, lq.r, kMmaRows, 0, nr, 0, r0);
  cp_async_wait_all();
  __syncthreads();
  unsigned qa[Dm::KS][4];
  load_a<D>(qa, qs, wrow, lane);

  float acc[Dm::NT][4];
  zero<D>(acc);
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // per fragment row g, g + 8
  for (int t0 = 0; t0 < N; t0 += kMmaRows) {
    const int nt = min(kMmaRows, N - t0);
    __syncthreads();  // the previous tile is consumed
    load_rows<D>(ks, kh, lk.r, kMmaRows, t0, nt, 0, 0);
    load_rows<D>(vs, vh, lv.r, kMmaRows, t0, nt, 0, 0);
    if (mh != nullptr) load_mask(ms, mh, N, r0, t0, mask_async);
    // The scores of the tile's 64 keys start as (bias + mask) / scale at the
    // warp's fragments (n-tile n: keys t0 + 8n + 2t4 + {0, 1}, rows g and
    // g + 8): the bias read from L2 straight into them while K, V and the
    // mask tile land, the mask (shared by the window's heads) from its tile.
    // Q K^T accumulates onto them, and one multiply by scale gives
    // Q K^T scale + bias + mask.
    float s[8][4];
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int key = t0 + n * 8 + 2 * t4;
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float2 b = active ? bias_pair(bh, brow[r] + key, key < N, key + 1 < N, pairs)
                                : make_float2(0.f, 0.f);
        s[n][2 * r] = b.x;
        s[n][2 * r + 1] = b.y;
      }
    }
    cp_async_wait_all();
    __syncthreads();
    if (!active) continue;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float2 m2 = make_float2(0.f, 0.f);
        if (mh != nullptr)
          m2 = *reinterpret_cast<const float2*>(ms + (wrow + g + 8 * r) * kMaskStride + n * 8 + 2 * t4);
        s[n][2 * r] = (s[n][2 * r] + m2.x) * inv_scale;
        s[n][2 * r + 1] = (s[n][2 * r + 1] + m2.y) * inv_scale;
      }
#pragma unroll
    for (int kk = 0; kk < Dm::KS; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        unsigned b[4];
        ldsm_x4(b, b_addr<D>(ks, np * 16, kk * 16, lane));
        mma(s[2 * np], qa[kk], b[0], b[1]);
        mma(s[2 * np + 1], qa[kk], b[2], b[3]);
      }
    // to the log2 domain, keys past N to -inf; one online-softmax step per tile
    float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = t0 + n * 8 + 2 * t4 + (e & 1) < N ? s[n][e] * scale_log2 : -INFINITY;
        mx[e >> 1] = fmaxf(mx[e >> 1], s[n][e]);
      }
    float base[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const float mn = fmaxf(m[r], quad_max(mx[r]));
      base[r] = mn == -INFINITY ? 0.f : mn;  // a row with no key so far
      const float corr = exp2f(m[r] - base[r]);
      m[r] = mn;
      l[r] *= corr;
#pragma unroll
      for (int n = 0; n < Dm::NT; ++n) {
        acc[n][2 * r] *= corr;
        acc[n][2 * r + 1] *= corr;
      }
    }
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        s[n][e] = exp2f(s[n][e] - base[e >> 1]);
        l[e >> 1] += s[n][e];
      }
    // PV in 16-key steps: the C layout of n-tiles 2c and 2c + 1 is the A
    // layout of k-step c; P enters as hi + lo bf16 terms
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      if (c * 16 >= nt) break;
      unsigned hi[4], lo_[4];
      split2(s[2 * c][0], s[2 * c][1], hi[0], lo_[0]);
      split2(s[2 * c][2], s[2 * c][3], hi[1], lo_[1]);
      split2(s[2 * c + 1][0], s[2 * c + 1][1], hi[2], lo_[2]);
      split2(s[2 * c + 1][2], s[2 * c + 1][3], hi[3], lo_[3]);
      accumulate<D>(acc, hi, lo_, vs, c * 16, lane);
    }
  }
  if (!active) return;
#pragma unroll
  for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);
  const float inv[2] = {1.f / l[0], 1.f / l[1]};
  store_rows<D>(oh, lo.r, r0 + wrow, nr - wrow, acc, inv, lane);
}

cudaError_t dispatch_head_dim(const void* q, const void* k, const void* v, const float* bias,
                              const float* mask, void* o, const Layout* lay, int Bn, int H, int N,
                              int D, int nW, float scale, bool is_bf16, bool pairs, bool mask_async,
                              cudaStream_t stream) {
  switch (D) {
#define XPT_CASE(DIM)                                                                              \
  case DIM:                                                                                        \
    if (is_bf16)                                                                                   \
      return xpt_mma::launch_with_smem(                                                            \
          window_mma_kernel<DIM>, dim3(Bn, H, (N + xpt_mma::kMmaRows - 1) / xpt_mma::kMmaRows),    \
          mma_smem_bytes(DIM, mask != nullptr), stream, static_cast<const bf16*>(q),               \
          static_cast<const bf16*>(k), static_cast<const bf16*>(v), bias, mask,                    \
          static_cast<bf16*>(o), lay[0], lay[1], lay[2], lay[3], N, nW, scale, pairs, mask_async); \
    window_attention_fwd_kernel<DIM / kLanes><<<dim3(Bn, H, (N + kRows - 1) / kRows), kThreads, 0,  \
                                                stream>>>(                                          \
        static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),  \
        bias, mask, static_cast<float*>(o), lay[0], lay[1], lay[2], lay[3], N, nW, scale);         \
    return cudaGetLastError();
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

// q, k, v and o are [Bn, H, N, D] with (batch, head, row) element strides in
// `strides` (3 per tensor, in that order) and D contiguous; bf16 views need
// what 16-byte cp.async needs (`xpt_mma::cp_async_ok`). bias and mask are
// contiguous fp32; mask may be null (no shifted-window mask), and then nW is
// ignored.
extern "C" int xpt_window_attention_fwd(const void* q, const void* k, const void* v,
                                        const void* bias, const void* mask, void* o,
                                        const long long* strides, int Bn, int H, int N, int D,
                                        int nW, float scale, int is_bf16, void* stream) {
  if (Bn < 1 || H < 1 || H > 65535 || N < 1 || (N + kRows - 1) / kRows > 65535 ||
      (mask != nullptr && (nW < 1 || Bn % nW != 0)))
    return cudaErrorInvalidValue;
  Layout lay[4];
  if (!xpt_mma::make_layouts(strides, 4, N, D, lay)) return cudaErrorInvalidValue;
  const void* ptrs[4] = {q, k, v, o};
  if (is_bf16 && !xpt_mma::cp_async_ok(ptrs, strides, 4)) return cudaErrorInvalidValue;
  const bool pairs = N % 2 == 0 && reinterpret_cast<unsigned long long>(bias) % 8 == 0;
  const bool mask_async = N % 4 == 0 && reinterpret_cast<unsigned long long>(mask) % 16 == 0;
  return dispatch_head_dim(q, k, v, static_cast<const float*>(bias), static_cast<const float*>(mask),
                           o, lay, Bn, H, N, D, nW, scale, is_bf16 != 0, pairs, mask_async,
                           static_cast<cudaStream_t>(stream));
}

// Dynamic shared memory, in bytes, of the bf16 kernel at head dim D with a mask.
extern "C" int xpt_window_attention_smem_bytes(int D) { return mma_smem_bytes(D, true); }
