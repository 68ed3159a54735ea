// Tensor-core building blocks of the bf16 proxy-attention kernels (sm_90a),
// shared by proxy_attention_fwd.cu and proxy_attention_bwd.cu, and the bf16
// forward itself (the backward runs it without its output when no forward
// LSE is given).
//
// The sequence is [M proxy tokens | N frames x L patches], S = M + N*L. Each
// tensor is indexed [B, H, S, D] through its own (batch, head, row) element
// strides, D contiguous (see `Layout`). A block of 4 warps owns a "fixed"
// side and streams the other side through shared memory in 64-row tiles:
//
//   block 0 (the proxy block): the M proxy rows, 16 at a time (one m-tile
//     shared by the four warps), against all S streamed rows; each warp takes
//     its own 16-row chunk of every 64-row tile, and the four partial results
//     are merged through shared memory in a fixed order;
//   block 1 + f * RT + rt (a frame block): rows [64 rt, 64 rt + 64) of frame f
//     (one 16-row m-tile per warp) against the frame's logical stream
//     [M proxies | own L rows], every warp over all four chunks of a tile.
//
// Products run on mma.sync.m16n8k16 (bf16 in, fp32 accumulate), fed by
// ldmatrix from tiles staged with 16-byte cp.async, through the building
// blocks of mma_bf16.cuh (shared with the window-attention kernel and the
// patch-embed GEMM). An fp32 intermediate that feeds
// a product (P, P*dP, dS) enters as two bf16 terms, hi = bf16(x) and
// lo = bf16(x - hi), whose two products are summed in fp32: a single bf16
// rounding of P costs tens of bf16 ulps of the output at the B/32 shape, the
// split ~0.5 ulp (tests/test_torch_proxy_attention.py emulates both). q, k,
// v and dO are bf16 already and enter exact.
//
// Scores are kept in the log2 domain (s * scale * log2 e) and exponentiated
// with exp2f; LSE leaves and enters the kernels in natural units.

#pragma once

#include "mma_bf16.cuh"

namespace xpt_proxy {

using namespace xpt_mma;

// ------------------------------------------------------ blocks, tiles

// What a block holds (see the file header). The streamed side's logical row
// t is sequence row t < M ? t : frame0 + (t - M): the proxies, then the frame
// (for the proxy block frame0 = M, so every row maps to itself).
struct Block {
  bool proxy;
  int frame0, nstream;  // stream map and its logical length
  int fixed0, nfixed;   // a frame block's own rows
  int passes;           // 16-row m-tiles of the proxy block; 1 for a frame block

  __device__ __forceinline__ Block(int S, int M, int L, int RT) {
    proxy = blockIdx.x == 0;
    if (proxy) {
      frame0 = M, nstream = S, fixed0 = 0, nfixed = M, passes = (M + 15) / 16;
    } else {
      const int f = (blockIdx.x - 1) / RT, rt = (blockIdx.x - 1) % RT;
      frame0 = M + f * L, nstream = M + L;
      fixed0 = frame0 + rt * kMmaRows, nfixed = min(kMmaRows, L - rt * kMmaRows), passes = 1;
    }
  }
  // pass p's first fixed row, its valid rows, the rows it stages
  __device__ __forceinline__ int row0(int p) const { return proxy ? 16 * p : fixed0; }
  __device__ __forceinline__ int nrows(int p) const { return proxy ? min(16, nfixed - 16 * p) : nfixed; }
  __device__ __forceinline__ int staged() const { return proxy ? 16 : kMmaRows; }
  // the warp's m-tile inside the staged fixed rows
  __device__ __forceinline__ int warp_row(int warp) const { return proxy ? 0 : 16 * warp; }
  // the warp's 16-row chunks of a streamed tile: its own one, or all four
  __device__ __forceinline__ int chunk0(int warp) const { return proxy ? warp : 0; }
  __device__ __forceinline__ int chunk_step() const { return proxy ? 4 : 1; }
};

// ------------------------------------------------------ the forward

// Dynamic shared memory of `fwd_mma_kernel<D, out>`: the fixed rows' tile and
// the K (and V) tile; the proxy merge reuses the K/V tiles.
constexpr int fwd_smem_bytes(int D, bool out) { return (out ? 3 : 2) * kMmaRows * (D + 8) * 2; }

// Dynamic shared memory of either bf16 backward pass: four 64-row tiles (the
// fixed side's two, the streamed side's two) and, for pass 2, the streamed
// rows' LSE and delta; the proxy merge reuses the tiles.
constexpr int bwd_smem_bytes(int D) { return 4 * kMmaRows * (D + 8) * 2 + 2 * kMmaRows * 4; }

// O = softmax(s q k^T) v over each row's allowed keys, and each row's LSE
// (natural log) when `lse` is not null. kOut = false computes LSE alone (the
// same code, so the same bits as the forward's) and reads no v.
template <int D, bool kOut>
__global__ void __launch_bounds__(kMmaThreads)
fwd_mma_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k, const bf16* __restrict__ v,
               bf16* __restrict__ o, float* __restrict__ lse, Layout lq, Layout lk, Layout lv,
               Layout lo, int S, int M, int L, int RT, float scale_log2) {
  using Dm = Dims<D>;
  extern __shared__ __align__(16) unsigned char mma_smem[];
  bf16* qs = reinterpret_cast<bf16*>(mma_smem);  // [kMmaRows][RS]
  bf16* ks = qs + kMmaRows * Dm::RS;            // [kMmaRows][RS]
  bf16* vs = ks + kMmaRows * Dm::RS;            // [kMmaRows][RS], kOut only
  // proxy merge scratch, aliasing the K/V tiles once they are consumed
  float* red_m = reinterpret_cast<float*>(ks);  // [4][16]
  float* red_l = red_m + 64;                    // [4][16]
  float* red_acc = red_l + 64;                  // [4][16][D], kOut only

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane >> 2, t4 = lane & 3;
  const long long bz = blockIdx.z, hy = blockIdx.y;
  const bf16* qh = q + bz * lq.b + hy * lq.h;
  const bf16* kh = k + bz * lk.b + hy * lk.h;
  const bf16* vh = kOut ? v + bz * lv.b + hy * lv.h : nullptr;
  bf16* oh = kOut ? o + bz * lo.b + hy * lo.h : nullptr;
  float* lseh = lse == nullptr ? nullptr : lse + ((size_t)blockIdx.z * gridDim.y + blockIdx.y) * S;
  const Block blk(S, M, L, RT);

  for (int pass = 0; pass < blk.passes; ++pass) {
    const int r0 = blk.row0(pass), nr = blk.nrows(pass), wrow = blk.warp_row(warp);
    __syncthreads();  // the previous pass's merge scratch is consumed
    load_rows<D>(qs, qh, lq.r, blk.staged(), 0, nr, 0, r0);
    cp_async_wait_all();
    __syncthreads();
    unsigned qa[Dm::KS][4];
    load_a<D>(qa, qs, wrow, lane);

    float acc[Dm::NT][4];
    zero<D>(acc);
    float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};  // per fragment row g, g + 8
    for (int t0 = 0; t0 < blk.nstream; t0 += kMmaRows) {
      const int nt = min(kMmaRows, blk.nstream - t0);
      __syncthreads();  // the previous tile is consumed
      load_rows<D>(ks, kh, lk.r, kMmaRows, t0, nt, M, blk.frame0);
      if (kOut) load_rows<D>(vs, vh, lv.r, kMmaRows, t0, nt, M, blk.frame0);
      cp_async_wait_all();
      __syncthreads();
      for (int c = blk.chunk0(warp); c * 16 < nt; c += blk.chunk_step()) {
        float s[2][4];
        scores<D>(s, qa, ks, c * 16, lane);
        float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int key = c * 16 + j * 8 + 2 * t4 + (e & 1);
            s[j][e] = key < nt ? s[j][e] * scale_log2 : -INFINITY;
            mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
          }
        float base[2];
#pragma unroll
        for (int r = 0; r < 2; ++r) {
          const float mn = fmaxf(m[r], quad_max(mx[r]));
          base[r] = mn == -INFINITY ? 0.f : mn;  // a row with no key so far
          const float corr = exp2f(m[r] - base[r]);
          m[r] = mn;
          l[r] *= corr;
          if (kOut) {
#pragma unroll
            for (int n = 0; n < Dm::NT; ++n) {
              acc[n][2 * r] *= corr;
              acc[n][2 * r + 1] *= corr;
            }
          }
        }
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            s[j][e] = exp2f(s[j][e] - base[e >> 1]);
            l[e >> 1] += s[j][e];
          }
        if (kOut) {
          unsigned hi[4], lo[4];
          split_a(s, hi, lo);
          accumulate<D>(acc, hi, lo, vs, c * 16, lane);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < 2; ++r) l[r] = quad_sum(l[r]);

    if (!blk.proxy) {
      if (kOut) {
        const float inv[2] = {1.f / l[0], 1.f / l[1]};
        store_rows<D>(oh, lo.r, r0 + wrow, nr - wrow, acc, inv, lane);
      }
      if (lseh != nullptr && t4 == 0) {
#pragma unroll
        for (int r = 0; r < 2; ++r)
          if (wrow + g + 8 * r < nr) lseh[r0 + wrow + g + 8 * r] = (m[r] + log2f(l[r])) * kLn2;
      }
      continue;
    }
    // the proxy block: merge the four warps' key slices, in warp order
    __syncthreads();  // the K/V tiles are no longer read
    if (t4 == 0) {
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        red_m[warp * 16 + g + 8 * r] = m[r];
        red_l[warp * 16 + g + 8 * r] = l[r];
      }
    }
    if (kOut) frag_to_smem<D>(red_acc + warp * 16 * D, acc, lane);
    __syncthreads();
    const int cols = kOut ? D : 1;
    for (int i = threadIdx.x; i < nr * cols; i += kMmaThreads) {
      const int row = i / cols, d = i % cols;
      float mx = -INFINITY;
      for (int w = 0; w < 4; ++w) mx = fmaxf(mx, red_m[w * 16 + row]);
      const float base = mx == -INFINITY ? 0.f : mx;
      float lsum = 0.f, od = 0.f;
      for (int w = 0; w < 4; ++w) {
        const float e = exp2f(red_m[w * 16 + row] - base);  // 0 for a slice with no keys
        lsum = fmaf(red_l[w * 16 + row], e, lsum);
        if (kOut) od = fmaf(red_acc[(w * 16 + row) * D + d], e, od);
      }
      if (kOut) oh[(r0 + row) * lo.r + d] = __float2bfloat16(od * (1.f / lsum));
      if (lseh != nullptr && d == 0) lseh[r0 + row] = (base + log2f(lsum)) * kLn2;
    }
  }
}

// Blocks along x: the proxy block, then RT row tiles of each of the N frames.
inline dim3 proxy_grid(int B, int H, int N, int L) {
  return dim3(1 + N * ((L + kMmaRows - 1) / kMmaRows), H, B);
}

}  // namespace xpt_proxy
