// Frozen batch norm with its activation, one pass each way, for Hopper
// (sm_90a): HD-VILA's ResNets (FrozenBatchNorm in models/hd_vila/resnet.py).
//
// Replaces no TPU kernel: the JAX package leaves FrozenBN, its ReLU and the
// residual add to XLA, which fuses them into the convolutions' neighbours.
// Eager PyTorch does not: the multiply and add by per-channel vectors, the
// ReLU, the residual add and their backward were each a pass over the maps
// (broadcasts of [C, 1, 1] against channels_last, which do not vectorise),
// and autograd summed the parameters' gradients over N*H*W in separate
// reductions. This file does the same arithmetic in one pass forward and one
// backward.
//
// Forward, over channels_last (NHWC) maps x [rows = N*H*W, C]:
//
//   y = act(x * a + b [+ identity]),  act = ReLU or none,
//
// with a = inv and b = shift, the fp32 per-channel vectors FrozenBatchNorm
// computes, rounded to the activation dtype first (as `inv.to(x.dtype)`);
// the product and the sums are taken in fp32 and rounded once at the store.
//
// Backward, from the output gradient g and the saved y (ReLU mask y > 0, as
// PyTorch's ReLU backward reads its output) and x:
//
//   gm = g * mask,  dx = gm * a,  d_identity = gm,
//   d_inv[c] = sum over rows of gm * x,  d_shift[c] = sum of gm,
//
// the sums in fp32: each block keeps its threads' sums in registers, reduces
// them over its rows in shared memory in a fixed order and writes one
// partial per channel to a scratch [blocks, 2, C]; a second kernel adds the
// partials in a fixed order. No atomics, so two runs give the same bits.
//
// What bounds it: bytes. At the main path's largest shape, layer1's bn3 of
// the high-resolution ResNet (bf16 [32, 256, 160, 256], 335.5 M elements),
// the forward reads x and the identity and writes y, 2.01 GB, 0.60 ms at
// 3.35 TB/s; the backward reads g, y and x and writes dx and d_identity,
// 3.36 GB, 1.00 ms; it does ~3 operations an element. The design moves each
// byte once: 16-byte vector loads and stores along C (8 bf16 or 4 fp32
// channels a thread), a thread fixed on its channels for the whole pass so
// that its a (and b) and its sums stay in registers, and a grid that strides
// over the rows with enough blocks to keep every SM's memory pipe full. A C
// that is not a multiple of the vector, or a pointer not 16-byte aligned,
// takes the same kernels one channel a thread.
//
// C interface for ctypes: the launch functions return cudaGetLastError()
// after their launches (0 on success). They launch on the caller's stream,
// do not synchronise and allocate nothing: the backward's scratch of
// xpt_frozen_bn_scratch_floats(rows, C) floats comes from the caller.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <initializer_list>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;     // a block: (channel vectors) x (rows)
constexpr int kFwdBlocksPerSm = 8;
constexpr int kBwdBlocksPerSm = 4;
constexpr int kSumLanes = 8;      // rows of partials a finishing thread walks

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename T>
__device__ __forceinline__ T from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

// VEC channels of one row, loaded and stored as one 16-byte access (VEC = 1:
// one element)
template <typename T, int VEC>
struct alignas(sizeof(T) * VEC) Pack {
  T v[VEC];
};

template <typename T, int VEC>
__device__ __forceinline__ Pack<T, VEC> load(const T* p) {
  return *reinterpret_cast<const Pack<T, VEC>*>(p);
}

template <typename T, int VEC>
__device__ __forceinline__ void store(T* p, const Pack<T, VEC>& v) {
  *reinterpret_cast<Pack<T, VEC>*>(p) = v;
}

// The launch geometry: a block of (bx, by) threads covers bx channel vectors
// of by rows; grid (row blocks, channel tiles), about blocks_per_sm blocks
// an SM in all.
struct Geometry {
  dim3 block, grid;
};

Geometry geometry(long long rows, int C, int vec, int sms, int blocks_per_sm) {
  const int cv = (C + vec - 1) / vec;
  const int bx = cv < kThreads ? cv : kThreads;
  const int by = kThreads / bx;
  const int tiles = (cv + bx - 1) / bx;
  const long long row_blocks = (rows + by - 1) / by;
  long long target = static_cast<long long>(sms) * blocks_per_sm / tiles;
  if (target < 1) target = 1;
  const long long gx = row_blocks < target ? row_blocks : target;
  return {dim3(bx, by), dim3(static_cast<unsigned>(gx), static_cast<unsigned>(tiles))};
}

template <typename T, int VEC, bool RELU, bool RESID>
__global__ void __launch_bounds__(kThreads, 4)
frozen_bn_act_fwd_kernel(const T* __restrict__ x, const T* __restrict__ identity, const float* __restrict__ inv,
                         const float* __restrict__ shift, T* __restrict__ y, long long rows, int C) {
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  if (c0 >= C) return;
  float a[VEC], b[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    a[j] = to_float(from_float<T>(inv[c0 + j]));
    b[j] = to_float(from_float<T>(shift[c0 + j]));
  }
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.y;
  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y; r < rows; r += stride) {
    const long long off = r * C + c0;
    const Pack<T, VEC> xv = load<T, VEC>(x + off);
    Pack<T, VEC> iv;
    if (RESID) iv = load<T, VEC>(identity + off);
    Pack<T, VEC> out;
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      // mul then add, each rounded in fp32: in fp32 the plain version's own
      // arithmetic; in bf16 the product of two bf16 values is exact
      float v = __fadd_rn(__fmul_rn(to_float(xv.v[j]), a[j]), b[j]);
      if (RESID) v = __fadd_rn(v, to_float(iv.v[j]));
      if (RELU) v = fmaxf(v, 0.f);
      out.v[j] = from_float<T>(v);
    }
    store<T, VEC>(y + off, out);
  }
}

template <typename T, int VEC, bool RELU, bool RESID, bool SUMS>
__global__ void __launch_bounds__(kThreads, 4)
frozen_bn_act_bwd_kernel(const T* __restrict__ g, const T* __restrict__ y, const T* __restrict__ x,
                         const float* __restrict__ inv, T* __restrict__ dx, T* __restrict__ d_identity,
                         float* __restrict__ partial, long long rows, int C) {
  const int c0 = (blockIdx.y * blockDim.x + threadIdx.x) * VEC;
  const bool active = c0 < C;
  float s_gx[VEC], s_g[VEC];
#pragma unroll
  for (int j = 0; j < VEC; ++j) s_gx[j] = s_g[j] = 0.f;
  if (active) {
    float a[VEC];
#pragma unroll
    for (int j = 0; j < VEC; ++j) a[j] = to_float(from_float<T>(inv[c0 + j]));
    const long long stride = static_cast<long long>(gridDim.x) * blockDim.y;
    for (long long r = static_cast<long long>(blockIdx.x) * blockDim.y + threadIdx.y; r < rows; r += stride) {
      const long long off = r * C + c0;
      const Pack<T, VEC> gv = load<T, VEC>(g + off);
      Pack<T, VEC> yv, xv, dxv, dv;
      if (RELU) yv = load<T, VEC>(y + off);
      if (SUMS) xv = load<T, VEC>(x + off);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        float gm = to_float(gv.v[j]);
        if (RELU && !(to_float(yv.v[j]) > 0.f)) gm = 0.f;
        dxv.v[j] = from_float<T>(__fmul_rn(gm, a[j]));
        if (RESID) dv.v[j] = from_float<T>(gm);
        if (SUMS) {
          s_g[j] += gm;
          s_gx[j] = fmaf(gm, to_float(xv.v[j]), s_gx[j]);
        }
      }
      store<T, VEC>(dx + off, dxv);
      if (RESID) store<T, VEC>(d_identity + off, dv);
    }
  }
  if (!SUMS) return;
  // the block's sums over its rows: each of its (bx x 2 VEC) values summed
  // over threadIdx.y in order, into this block's partial row
  __shared__ float red[2 * VEC * kThreads];
  const int bx = blockDim.x, by = blockDim.y;
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    red[((2 * j) * by + threadIdx.y) * bx + threadIdx.x] = s_gx[j];
    red[((2 * j + 1) * by + threadIdx.y) * bx + threadIdx.x] = s_g[j];
  }
  __syncthreads();
  const int tid = threadIdx.y * bx + threadIdx.x;
  for (int p = tid; p < 2 * VEC * bx; p += bx * by) {
    const int k = p / bx, tx = p % bx;
    const int c = (blockIdx.y * bx + tx) * VEC + k / 2;
    if (c >= C) continue;
    float s = 0.f;
    for (int i = 0; i < by; ++i) s += red[(k * by + i) * bx + tx];
    partial[(static_cast<long long>(blockIdx.x) * 2 + (k & 1)) * C + c] = s;
  }
}

// out[i] = sum over b of partial[b][i], i < n = 2C, in a fixed order: lane
// ty adds rows ty, ty + 8, ..., then the 8 lanes are added in order
__global__ void __launch_bounds__(32 * kSumLanes)
frozen_bn_param_sums_kernel(const float* __restrict__ partial, float* __restrict__ out, int blocks, int n) {
  __shared__ float red[kSumLanes][33];
  const int i = blockIdx.x * 32 + threadIdx.x;
  float s = 0.f;
  if (i < n) {
    for (int b = threadIdx.y; b < blocks; b += kSumLanes) s += partial[static_cast<long long>(b) * n + i];
  }
  red[threadIdx.y][threadIdx.x] = s;
  __syncthreads();
  if (threadIdx.y == 0 && i < n) {
    float t = 0.f;
#pragma unroll
    for (int l = 0; l < kSumLanes; ++l) t += red[l][threadIdx.x];
    out[i] = t;
  }
}

int sm_count() {
  int dev = 0, sms = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 132;
  if (cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess || sms < 1) return 132;
  return sms;
}

bool aligned16(const void* p) { return p == nullptr || reinterpret_cast<unsigned long long>(p) % 16 == 0; }

template <typename T, int VEC>
void launch_fwd(const void* x, const void* identity, const float* inv, const float* shift, void* y, long long rows,
                int C, bool relu, cudaStream_t st) {
  const Geometry geo = geometry(rows, C, VEC, sm_count(), kFwdBlocksPerSm);
  const T* xp = static_cast<const T*>(x);
  const T* ip = static_cast<const T*>(identity);
  T* yp = static_cast<T*>(y);
  if (relu && ip) frozen_bn_act_fwd_kernel<T, VEC, true, true><<<geo.grid, geo.block, 0, st>>>(xp, ip, inv, shift, yp, rows, C);
  else if (relu) frozen_bn_act_fwd_kernel<T, VEC, true, false><<<geo.grid, geo.block, 0, st>>>(xp, ip, inv, shift, yp, rows, C);
  else if (ip) frozen_bn_act_fwd_kernel<T, VEC, false, true><<<geo.grid, geo.block, 0, st>>>(xp, ip, inv, shift, yp, rows, C);
  else frozen_bn_act_fwd_kernel<T, VEC, false, false><<<geo.grid, geo.block, 0, st>>>(xp, ip, inv, shift, yp, rows, C);
}

template <typename T, int VEC, bool RELU, bool RESID>
void launch_bwd_sums(const Geometry& geo, const T* g, const T* y, const T* x, const float* inv, T* dx, T* di,
                     float* partial, long long rows, int C, cudaStream_t st) {
  if (x) frozen_bn_act_bwd_kernel<T, VEC, RELU, RESID, true><<<geo.grid, geo.block, 0, st>>>(g, y, x, inv, dx, di, partial, rows, C);
  else frozen_bn_act_bwd_kernel<T, VEC, RELU, RESID, false><<<geo.grid, geo.block, 0, st>>>(g, y, x, inv, dx, di, partial, rows, C);
}

// x == nullptr: no parameter gradients (no sums, no partials)
template <typename T, int VEC>
cudaError_t launch_bwd(const void* g, const void* y, const void* x, const float* inv, void* dx, void* d_identity,
               float* partial, float* sums, long long rows, int C, cudaStream_t st) {
  const Geometry geo = geometry(rows, C, VEC, sm_count(), kBwdBlocksPerSm);
  const T* gp = static_cast<const T*>(g);
  const T* yp = static_cast<const T*>(y);
  const T* xp = static_cast<const T*>(x);
  T* dxp = static_cast<T*>(dx);
  T* dip = static_cast<T*>(d_identity);
  if (yp && dip) launch_bwd_sums<T, VEC, true, true>(geo, gp, yp, xp, inv, dxp, dip, partial, rows, C, st);
  else if (yp) launch_bwd_sums<T, VEC, true, false>(geo, gp, yp, xp, inv, dxp, dip, partial, rows, C, st);
  else if (dip) launch_bwd_sums<T, VEC, false, true>(geo, gp, yp, xp, inv, dxp, dip, partial, rows, C, st);
  else launch_bwd_sums<T, VEC, false, false>(geo, gp, yp, xp, inv, dxp, dip, partial, rows, C, st);
  const cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || !xp) return err;
  const int n = 2 * C;
  frozen_bn_param_sums_kernel<<<(n + 31) / 32, dim3(32, kSumLanes), 0, st>>>(partial, sums, geo.grid.x, n);
  return cudaGetLastError();
}

bool bad_shape(long long rows, int C) { return rows < 1 || C < 1 || rows * C < rows; }

}  // namespace

// y = act(x * inv + shift [+ identity]) over channels_last [rows, C] maps;
// identity may be null, relu 0 or 1; bf16 (is_bf16) or fp32.
extern "C" int xpt_frozen_bn_act_fwd(const void* x, const void* identity, const float* inv, const float* shift,
                                     void* y, long long rows, int C, int relu, int is_bf16, void* stream) {
  if (bad_shape(rows, C)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = is_bf16 ? 8 : 4;
  const bool vectorised = C % vec == 0 && aligned16(x) && aligned16(identity) && aligned16(y);
  if (is_bf16) {
    if (vectorised) launch_fwd<bf16, 8>(x, identity, inv, shift, y, rows, C, relu, st);
    else launch_fwd<bf16, 1>(x, identity, inv, shift, y, rows, C, relu, st);
  } else {
    if (vectorised) launch_fwd<float, 4>(x, identity, inv, shift, y, rows, C, relu, st);
    else launch_fwd<float, 1>(x, identity, inv, shift, y, rows, C, relu, st);
  }
  return cudaGetLastError();
}

// The backward of xpt_frozen_bn_act_fwd: dx, and d_identity where it is not
// null; y null for no activation (no mask); x null for no parameter
// gradients, else sums [2, C] fp32 receives (d_inv, d_shift) through the
// caller's scratch `partial` of xpt_frozen_bn_scratch_floats(rows, C) floats.
extern "C" int xpt_frozen_bn_act_bwd(const void* g, const void* y, const void* x, const float* inv, void* dx,
                                     void* d_identity, float* partial, float* sums, long long rows, int C,
                                     int is_bf16, void* stream) {
  if (bad_shape(rows, C)) return cudaErrorInvalidValue;
  if (x && (partial == nullptr || sums == nullptr)) return cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int vec = is_bf16 ? 8 : 4;
  const bool vectorised = C % vec == 0 && aligned16(g) && aligned16(y) && aligned16(x) && aligned16(dx) &&
                          aligned16(d_identity);
  if (is_bf16) {
    return vectorised ? launch_bwd<bf16, 8>(g, y, x, inv, dx, d_identity, partial, sums, rows, C, st)
                      : launch_bwd<bf16, 1>(g, y, x, inv, dx, d_identity, partial, sums, rows, C, st);
  }
  return vectorised ? launch_bwd<float, 4>(g, y, x, inv, dx, d_identity, partial, sums, rows, C, st)
                    : launch_bwd<float, 1>(g, y, x, inv, dx, d_identity, partial, sums, rows, C, st);
}

// Floats of the backward's scratch for parameter gradients: 2C partials for
// each row block of the larger of the vector and the one-channel geometry.
extern "C" long long xpt_frozen_bn_scratch_floats(long long rows, int C) {
  if (bad_shape(rows, C)) return 0;
  const int sms = sm_count();
  unsigned blocks = 0;
  for (int vec : {1, 4, 8}) {
    const Geometry geo = geometry(rows, C, vec, sms, kBwdBlocksPerSm);
    if (geo.grid.x > blocks) blocks = geo.grid.x;
  }
  return 2LL * C * blocks;
}
