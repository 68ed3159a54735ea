// Tensor-core building blocks for the port's bf16 kernels on Hopper (sm_90a):
// inline PTX for mma.sync m16n8k16 (bf16 in, fp32 accumulate), ldmatrix and
// 16-byte cp.async, the fragment helpers of a flash-style attention warp, and
// the strided [B, H, S, D] layouts the attention kernels read. Used by the
// proxy-attention kernels (proxy_attention_mma.cuh), the window-attention
// kernel and the u8 patch-embed GEMM.
//
// Tiles are staged in shared memory with rows padded by 16 bytes, so the
// eight row addresses of an ldmatrix hit eight different bank groups; rows
// past the valid ones are zero-filled. An fp32 value that feeds a product
// enters as two bf16 terms, hi = bf16(x) and lo = bf16(x - hi), whose two
// products are summed in fp32 (`split2`): about 16 significant bits instead
// of bf16's 8.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace xpt_mma {

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
constexpr int kMmaRows = 64;      // rows staged per tile; fixed rows per block
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

__device__ __forceinline__ void cp_async_commit() { asm volatile("cp.async.commit_group;\n" ::: "memory"); }

// Wait until at most N committed groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

// ------------------------------------------------------ tiles, launches

// Stage `rows` rows of a head into a padded tile with cp.async: tile row t is
// logical row lt = t0 + t, read from head row lt < M ? lt : frame0 + (lt - M)
// (M shared rows, then a run from frame0: the proxy kernels' stream; M = 0
// and frame0 = r0 give the plain rows r0 + t0 + t); rows at or past `nvalid`
// are zeros.
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

// Launch `kernel` with `threads` threads and `smem` bytes of dynamic shared
// memory, opting in above the default 48 KB.
template <typename Kernel, typename... Args>
cudaError_t launch_block(Kernel kernel, dim3 grid, int threads, int smem, cudaStream_t stream,
                         Args... args) {
  if (smem > 48 * 1024) {
    const cudaError_t err =
        cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
  }
  kernel<<<grid, threads, smem, stream>>>(args...);
  return cudaGetLastError();
}

// `launch_block` with the 4 warps of an attention block.
template <typename Kernel, typename... Args>
cudaError_t launch_with_smem(Kernel kernel, dim3 grid, int smem, cudaStream_t stream, Args... args) {
  return launch_block(kernel, grid, kMmaThreads, smem, stream, args...);
}

}  // namespace xpt_mma
