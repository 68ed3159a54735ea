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
// ldmatrix from tiles staged with 16-byte cp.async (rows padded by 16 bytes,
// so the eight row addresses of an ldmatrix hit eight different bank groups;
// rows past the valid ones are zero-filled). An fp32 intermediate that feeds
// a product (P, P*dP, dS) enters as two bf16 terms, hi = bf16(x) and
// lo = bf16(x - hi), whose two products are summed in fp32: a single bf16
// rounding of P costs tens of bf16 ulps of the output at the B/32 shape, the
// split ~0.5 ulp (tests/test_torch_proxy_attention.py emulates both). q, k,
// v and dO are bf16 already and enter exact.
//
// Scores are kept in the log2 domain (s * scale * log2 e) and exponentiated
// with exp2f; LSE leaves and enters the kernels in natural units.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace xpt_proxy {

using bf16 = __nv_bfloat16;

// Element strides of one tensor indexed [B, H, S, D] (D has stride 1). The
// batch and head strides place a block's (b, h) once, in 64 bits; the row
// stride addresses the rows inside it in 32 bits (`make_layouts` checks that
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

// What 16-byte cp.async needs of a bf16 tensor: its data pointer 16-byte
// aligned and every stride a multiple of 8 elements.
inline bool cp_async_ok(const void* const* ptrs, const long long* strides, int n) {
  for (int i = 0; i < n; ++i) {
    if (reinterpret_cast<unsigned long long>(ptrs[i]) % 16) return false;
    for (int j = 0; j < 3; ++j)
      if (strides[3 * i + j] % 8) return false;
  }
  return true;
}

constexpr int kMmaThreads = 128;  // 4 warps
constexpr int kMmaRows = 64;      // streamed rows staged per tile; frame rows per block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

template <int D>
struct Dims {
  static constexpr int RS = D + 8;   // bf16 elements per staged row (16 bytes of padding)
  static constexpr int KS = D / 16;  // k-steps of 16 over the head dim
  static constexpr int NT = D / 8;   // n-tiles of 8 over the head dim
};

// ---------------------------------------------------------------- PTX

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-filled when !valid (src is not read then).
__device__ __forceinline__ void cp_async_16(void* dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(smem_u32(dst)), "l"(src),
               "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}

__device__ __forceinline__ void ldsm_x4(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldsm_x4_t(unsigned (&r)[4], const bf16* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
               : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma(float (&d)[4], const unsigned (&a)[4], unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// ------------------------------------------------------ fragments

// The lane's row address for an ldmatrix.x4 of a 16x16 block at (row0, col0)
// whose four matrices are (rows 0-7 | 8-15) x (cols 0-7), then x (cols 8-15):
// an A fragment, or with .trans the B fragments of two n-tiles (cols 0-7 and
// 8-15 of the block's columns) of a [k][n] tile.
template <int D>
__device__ __forceinline__ const bf16* a_addr(const bf16* tile, int row0, int col0, int lane) {
  return tile + (row0 + (lane & 7) + ((lane >> 3) & 1) * 8) * Dims<D>::RS + col0 + (lane >> 4) * 8;
}

// The lane's row address for an ldmatrix.x4 (no .trans) giving the B
// fragments of two n-tiles (rows 0-7 and 8-15 of an [n][k] tile) at one
// k-step: matrices (rows 0-7) x (cols 0-7 | 8-15), then rows 8-15.
template <int D>
__device__ __forceinline__ const bf16* b_addr(const bf16* tile, int row0, int col0, int lane) {
  return tile + (row0 + (lane & 7) + (lane >> 4) * 8) * Dims<D>::RS + col0 + ((lane >> 3) & 1) * 8;
}

// A fragments of a warp's 16 fixed rows (starting at tile row `row0`) over D.
template <int D>
__device__ __forceinline__ void load_a(unsigned (&a)[Dims<D>::KS][4], const bf16* tile, int row0, int lane) {
#pragma unroll
  for (int kk = 0; kk < Dims<D>::KS; ++kk) ldsm_x4(a[kk], a_addr<D>(tile, row0, kk * 16, lane));
}

// s[j] = a (16 x D) . tile rows [row0 + 8j, row0 + 8j + 8)^T: 16 x 16 scores.
template <int D>
__device__ __forceinline__ void scores(float (&s)[2][4], const unsigned (&a)[Dims<D>::KS][4],
                                       const bf16* tile, int row0, int lane) {
#pragma unroll
  for (int j = 0; j < 2; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
  for (int kk = 0; kk < Dims<D>::KS; ++kk) {
    unsigned b[4];
    ldsm_x4(b, b_addr<D>(tile, row0, kk * 16, lane));
    mma(s[0], a[kk], b[0], b[1]);
    mma(s[1], a[kk], b[2], b[3]);
  }
}

// x, y -> their bf16 pair (x in the low half) and the pair of what is left.
__device__ __forceinline__ void split2(float x, float y, unsigned& hi, unsigned& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x - hf.x, y - hf.y);
  hi = *reinterpret_cast<const unsigned*>(&h);
  lo = *reinterpret_cast<const unsigned*>(&l);
}

// The 16x16 fp32 accumulator pair p (C layout) as hi and lo A fragments.
__device__ __forceinline__ void split_a(const float (&p)[2][4], unsigned (&hi)[4], unsigned (&lo)[4]) {
  split2(p[0][0], p[0][1], hi[0], lo[0]);
  split2(p[0][2], p[0][3], hi[1], lo[1]);
  split2(p[1][0], p[1][1], hi[2], lo[2]);
  split2(p[1][2], p[1][3], hi[3], lo[3]);
}

// acc (16 x D) += (hi + lo) (16 x 16) . tile rows [row0, row0 + 16) (16 x D).
template <int D>
__device__ __forceinline__ void accumulate(float (&acc)[Dims<D>::NT][4], const unsigned (&hi)[4],
                                           const unsigned (&lo)[4], const bf16* tile, int row0,
                                           int lane) {
#pragma unroll
  for (int np = 0; np < Dims<D>::NT / 2; ++np) {
    unsigned b[4];
    ldsm_x4_t(b, a_addr<D>(tile, row0, np * 16, lane));
    mma(acc[2 * np], hi, b[0], b[1]);
    mma(acc[2 * np + 1], hi, b[2], b[3]);
    mma(acc[2 * np], lo, b[0], b[1]);
    mma(acc[2 * np + 1], lo, b[2], b[3]);
  }
}

template <int D>
__device__ __forceinline__ void zero(float (&acc)[Dims<D>::NT][4]) {
#pragma unroll
  for (int n = 0; n < Dims<D>::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[n][e] = 0.f;
}

// A warp's 16 x D accumulator into fp32 shared memory [16][D].
template <int D>
__device__ __forceinline__ void frag_to_smem(float* dst, const float (&acc)[Dims<D>::NT][4], int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int n = 0; n < Dims<D>::NT; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dst[(g + (e >> 1) * 8) * D + n * 8 + 2 * t + (e & 1)] = acc[n][e];
}

// Rows g and g + 8 of a warp's 16 x D accumulator, times mul[0] and mul[1],
// to bf16 rows `row0 + g` and `row0 + g + 8` of a head (those below `nvalid`).
template <int D>
__device__ __forceinline__ void store_rows(bf16* head, int rs, int row0, int nvalid,
                                           const float (&acc)[Dims<D>::NT][4], const float (&mul)[2],
                                           int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (g + 8 * r >= nvalid) continue;
    bf16* dst = head + (row0 + g + 8 * r) * rs + 2 * t;
#pragma unroll
    for (int n = 0; n < Dims<D>::NT; ++n)
      *reinterpret_cast<__nv_bfloat162*>(dst + n * 8) =
          __floats2bfloat162_rn(acc[n][2 * r] * mul[r], acc[n][2 * r + 1] * mul[r]);
  }
}

// Sum (or max) over the four lanes of a quad, which share a fragment row.
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}

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

// Stage `rows` rows of a head into a padded tile with cp.async: tile row t is
// logical row t0 + t, mapped to its sequence row as `Block` says (M = 0 and
// frame0 = r0 give the plain rows r0 + t); rows at or past `nvalid` are zeros.
template <int D>
__device__ __forceinline__ void load_rows(bf16* tile, const bf16* head, int rs, int rows, int t0,
                                          int nvalid, int M, int frame0) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < rows * CPR; i += kMmaThreads) {
    const int t = i / CPR, c = i % CPR;
    const int lt = t0 + t;
    const bool valid = t < nvalid;
    const int srow = lt < M ? lt : frame0 + (lt - M);
    cp_async_16(tile + t * Dims<D>::RS + c * 8, valid ? head + srow * rs + c * 8 : head, valid);
  }
}

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

// Launch `kernel` with `smem` bytes of dynamic shared memory, opting in above
// the default 48 KB.
template <typename Kernel, typename... Args>
cudaError_t launch_with_smem(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, kMmaThreads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// Blocks along x: the proxy block, then RT row tiles of each of the N frames.
inline dim3 proxy_grid(int B, int H, int N, int L) {
  return dim3(1 + N * ((L + kMmaRows - 1) / kMmaRows), H, B);
}

}  // namespace xpt_proxy
