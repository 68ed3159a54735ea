// GroupedAdamW's update (optim/optimizer.py) as one multi-tensor pass, for
// Hopper (sm_90a).
//
// Replaces no TPU kernel: the JAX package's fused_grouped_adamw is one XLA
// fusion. Eager PyTorch ran it as about fifteen torch._foreach_* passes per
// parameter group (the clip, each moment's mul and add, the denominator's
// div, sqrt and add, the update's divs, the decay and the lr), each reading
// and writing whole fp32 lists. This file does the same arithmetic in one
// pass: each element of every leaf, in every group, is read once and
// written once.
//
// For each element, from the parameter (or its fp32 master) p, the gradient
// g, the moments m and v, and the device scalars gnorm and
// scalars = [c1, c2, -lr*mul of each group]:
//
//   g' = gnorm < max_norm ? g : (g / gnorm) * max_norm      (clip, if on)
//   m  = m*b1 + g'*(1-b1)
//   v  = v*b2 + (g'*g')*(1-b2)
//   u  = (m / c1) / (sqrt(v / c2) + eps)  [+ p*wd where the group decays]
//   p  = p + u * scalars[2 + group]
//
// in fp32, each operation rounded to nearest as the _foreach ops round it:
// __fmul_rn, __fadd_rn, __fdiv_rn and __fsqrt_rn keep the compiler from
// contracting a product and a sum into an FMA, so the bits are the _foreach
// path's. bf16 moments load into fp32, update there and store rounded to
// nearest (the path's .float() ... copy_); u reads the unrounded values.
//
// What bounds it: bytes. Each element reads p, g, m, v and writes p, m, v:
// 28 B in fp32 (20 B with bf16 moments), ~12 operations with three
// divisions and a square root. The design moves each byte once: 16-byte
// vector loads and stores along each leaf (4 elements a thread and access),
// a block per chunk of kChunk elements of one leaf, and one grid over the
// chunks of all the leaves a launch takes, so one launch covers every group.
// Each leaf's pointers, size, first chunk, scalar index and decay travel in
// the kernel's parameter block (__grid_constant__, up to kMaxLeaves leaves,
// 26.6 KB), so a CUDA graph that captures the launch replays it on the same
// addresses with no table to rewrite; a block finds its leaf by a binary
// search over the first chunks. gnorm and the scalars are read from device
// memory, so nothing waits for the host. No atomics: every element is
// written by one thread.
//
// Alignment: a leaf may start anywhere (a view into a larger buffer). Where
// its four pointers sit at the same element offset from a vector boundary
// (16 bytes for fp32, 8 for bf16 moments), each chunk updates its first few
// elements one at a time up to that boundary, then vectors, then a scalar
// tail; where they do not, the leaf's chunks run element by element. The
// arithmetic is the same either way.
//
// C interface for ctypes: xpt_adamw_multi_tensor returns
// cudaGetLastError() after its launch (0 on success). It launches on the
// caller's stream, does not synchronise and allocates nothing. The caller
// checks dtypes and contiguity of every leaf.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

using bf16 = __nv_bfloat16;

constexpr int kThreads = 256;
constexpr int kChunk = 4096;  // elements a block updates: 4 vectors of 4 a thread
constexpr int kMaxLeaves = 512;

struct AdamwLeaves {
  float* p[kMaxLeaves];
  const float* g[kMaxLeaves];
  void* m[kMaxLeaves];
  void* v[kMaxLeaves];
  long long n[kMaxLeaves];
  int first_chunk[kMaxLeaves + 1];  // leaf l owns chunks [first_chunk[l], first_chunk[l + 1])
  int scalar[kMaxLeaves];           // index of its group's -lr*mul in scalars
  float wd[kMaxLeaves];             // its group's decay, 0 for none
  int leaves;
};

struct AdamwHyper {
  float b1, one_minus_b1, b2, one_minus_b2, eps, max_norm;
  int clip;
};

template <typename M, int VEC>
struct alignas(sizeof(M) * VEC) Pack {
  M v[VEC];
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(bf16 v) { return __bfloat162float(v); }

template <typename M>
__device__ __forceinline__ M from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) { return v; }
template <>
__device__ __forceinline__ bf16 from_float<bf16>(float v) { return __float2bfloat16_rn(v); }

struct Step {
  float b1, one_minus_b1, b2, one_minus_b2, eps, c1, c2, lr, wd, gnorm, max_norm;
  bool clip, decay;

  __device__ __forceinline__ void operator()(float& p, float g, float& m, float& v) const {
    if (clip) g = __fmul_rn(__fdiv_rn(g, gnorm), max_norm);
    m = __fadd_rn(__fmul_rn(m, b1), __fmul_rn(g, one_minus_b1));
    v = __fadd_rn(__fmul_rn(v, b2), __fmul_rn(__fmul_rn(g, g), one_minus_b2));
    const float denom = __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), eps);
    float u = __fdiv_rn(__fdiv_rn(m, c1), denom);
    if (decay) u = __fadd_rn(u, __fmul_rn(p, wd));
    p = __fadd_rn(p, __fmul_rn(u, lr));
  }
};

template <typename M, int VEC>
__device__ __forceinline__ void update(const Step& step, float* __restrict__ p, const float* __restrict__ g,
                                       M* __restrict__ m, M* __restrict__ v, long long i) {
  Pack<float, VEC> pv = *reinterpret_cast<const Pack<float, VEC>*>(p + i);
  const Pack<float, VEC> gv = *reinterpret_cast<const Pack<float, VEC>*>(g + i);
  Pack<M, VEC> mv = *reinterpret_cast<const Pack<M, VEC>*>(m + i);
  Pack<M, VEC> vv = *reinterpret_cast<const Pack<M, VEC>*>(v + i);
#pragma unroll
  for (int j = 0; j < VEC; ++j) {
    float mj = to_float(mv.v[j]), vj = to_float(vv.v[j]);
    step(pv.v[j], gv.v[j], mj, vj);
    mv.v[j] = from_float<M>(mj);
    vv.v[j] = from_float<M>(vj);
  }
  *reinterpret_cast<Pack<float, VEC>*>(p + i) = pv;
  *reinterpret_cast<Pack<M, VEC>*>(m + i) = mv;
  *reinterpret_cast<Pack<M, VEC>*>(v + i) = vv;
}

template <typename M>
__global__ void __launch_bounds__(kThreads)
xpt_adamw_multi_tensor_apply_kernel(const __grid_constant__ AdamwLeaves t, const AdamwHyper h,
                                    const float* __restrict__ scalars, const float* __restrict__ gnorm) {
  const int chunk = blockIdx.x;
  int lo = 0, hi = t.leaves - 1;  // the last leaf whose first chunk is <= this one
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (t.first_chunk[mid] <= chunk) lo = mid;
    else hi = mid - 1;
  }
  const long long start = static_cast<long long>(chunk - t.first_chunk[lo]) * kChunk;
  const long long n = t.n[lo];
  const int len = static_cast<int>(n - start < kChunk ? n - start : kChunk);

  Step step;
  step.b1 = h.b1;
  step.one_minus_b1 = h.one_minus_b1;
  step.b2 = h.b2;
  step.one_minus_b2 = h.one_minus_b2;
  step.eps = h.eps;
  step.max_norm = h.max_norm;
  step.gnorm = h.clip ? *gnorm : 0.f;
  // the clip scales unless gnorm < max_norm (a NaN norm scales too)
  step.clip = h.clip && !(step.gnorm < h.max_norm);
  step.c1 = scalars[0];
  step.c2 = scalars[1];
  step.lr = scalars[t.scalar[lo]];
  step.wd = t.wd[lo];
  step.decay = step.wd != 0.f;

  float* p = t.p[lo] + start;
  const float* g = t.g[lo] + start;
  M* m = static_cast<M*>(t.m[lo]) + start;
  M* v = static_cast<M*>(t.v[lo]) + start;
  // elements past the last vector boundary, per pointer: start is a multiple
  // of 4, so every chunk of a leaf sees its leaf's offsets
  const unsigned phase = (reinterpret_cast<uintptr_t>(p) / sizeof(float)) & 3;
  const bool vec = phase == ((reinterpret_cast<uintptr_t>(g) / sizeof(float)) & 3) &&
                   phase == ((reinterpret_cast<uintptr_t>(m) / sizeof(M)) & 3) &&
                   phase == ((reinterpret_cast<uintptr_t>(v) / sizeof(M)) & 3);
  // the scalar head: up to the first boundary, or the whole chunk
  const int head = vec ? min(static_cast<int>((4 - phase) & 3), len) : len;
  const int vecs = (len - head) / 4;
  for (int k = threadIdx.x; k < vecs; k += kThreads) update<M, 4>(step, p, g, m, v, head + 4LL * k);
  for (int k = threadIdx.x; k < head; k += kThreads) update<M, 1>(step, p, g, m, v, k);
  const int tail = head + 4 * vecs + threadIdx.x;
  if (tail < len) update<M, 1>(step, p, g, m, v, tail);
}

}  // namespace

// One launch over `leaves` (1..kMaxLeaves) leaves: ptrs holds each leaf's
// (p, g, m, v) device addresses, numel its size, first_chunk (leaves + 1
// entries) the prefix of its chunks of kChunk elements, scalar_index and wd
// its group's entry of `scalars` and decay. m and v are bf16 if moment_bf16,
// else fp32. gnorm (a device fp32 scalar) is read only if clip.
extern "C" int xpt_adamw_multi_tensor(const unsigned long long* ptrs, const long long* numel,
                                      const int* first_chunk, const int* scalar_index, const float* wd, int leaves,
                                      int moment_bf16, const float* scalars, const float* gnorm, float b1,
                                      float one_minus_b1, float b2, float one_minus_b2, float eps, float max_norm,
                                      int clip, void* stream) {
  if (leaves < 1 || leaves > kMaxLeaves || first_chunk[0] != 0 || (clip && gnorm == nullptr)) {
    return cudaErrorInvalidValue;
  }
  AdamwLeaves t;
  t.leaves = leaves;
  for (int l = 0; l < leaves; ++l) {
    if (numel[l] < 1 || first_chunk[l + 1] - first_chunk[l] != (numel[l] + kChunk - 1) / kChunk) {
      return cudaErrorInvalidValue;
    }
    t.p[l] = reinterpret_cast<float*>(ptrs[4 * l]);
    t.g[l] = reinterpret_cast<const float*>(ptrs[4 * l + 1]);
    t.m[l] = reinterpret_cast<void*>(ptrs[4 * l + 2]);
    t.v[l] = reinterpret_cast<void*>(ptrs[4 * l + 3]);
    t.n[l] = numel[l];
    t.first_chunk[l] = first_chunk[l];
    t.scalar[l] = scalar_index[l];
    t.wd[l] = wd[l];
  }
  t.first_chunk[leaves] = first_chunk[leaves];
  const AdamwHyper h{b1, one_minus_b1, b2, one_minus_b2, eps, max_norm, clip};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const unsigned grid = static_cast<unsigned>(first_chunk[leaves]);
  if (moment_bf16) xpt_adamw_multi_tensor_apply_kernel<bf16><<<grid, kThreads, 0, st>>>(t, h, scalars, gnorm);
  else xpt_adamw_multi_tensor_apply_kernel<float><<<grid, kThreads, 0, st>>>(t, h, scalars, gnorm);
  return cudaGetLastError();
}

extern "C" int xpt_adamw_max_leaves() { return kMaxLeaves; }

extern "C" int xpt_adamw_chunk() { return kChunk; }
