// The clip by global norm and the AdamW update of a training step, over
// every leaf at once, for Hopper.
//
// Replaces no TPU kernel: the JAX package's optimizer
// (repro/train/optimizer.py) is jnp code that XLA fuses. The plain version
// is repro_torch/train/optimizer.py: clip_by_global_norm, then
// adamw_update, some 25 PyTorch operations a leaf, each a full pass over
// f32 data. Wrapper, tables and launch counts: repro_torch/kernels/adamw.py.
//
// Work. For every element of every leaf (the parameter p in bf16 or f32,
// its gradient g in bf16 or f32, f32 moments m and v):
//   norm  = sqrt(sum over all leaves of g^2)
//   scale = min(max_norm * (1 / (norm + 1e-9)), 1)
//   g'    = bf16(g * bf16(scale))  (bf16 g)  or  g * scale  (f32 g)
//   m = m b1 + (1 - b1) g'        v = v b2 + ((1 - b2) g') g'
//   p = p - lr (m / bc1 / (sqrt(v / bc2) + eps) + wd p)
// in f32, every operation rounded where and as the plain version rounds
// it: the __f*_rn intrinsics, so that no FMA contraction changes a
// rounding, and p stored back in its dtype, nearest even. lr, bc1, bc2
// (the schedule's PyTorch code) and scale are read from device memory, so
// the host never waits.
//
// Bound. Bytes: g read by the norm, then p, g, m, v read and p, m, v
// written, 24 B an element with bf16 p and g. The training cell's leaves
// hold ~3.05 G elements (the experts padded to 64): ~73 GB, 22 ms at
// 3.35 TB/s. Two divisions and a square root an element come to ~50
// instructions, a fifth of that time on the CUDA cores.
//
// Design.
//   * One launch of each kernel covers up to kMaxLeaves leaves, a group;
//     a longer list takes a launch of each a group. Every leaf is cut
//     into chunks
//     of kChunk elements, the last one shorter, numbered across the
//     leaves. The leaf table, built once per set of parameters and state
//     and kept on the device, holds each leaf's first chunk, so chunk c
//     finds its leaf by a binary search and the chunks take no memory of
//     their own. A fixed grid walks them, chunk c to block c mod grid, so
//     each block always sums the same elements in the same order.
//   * The gradients are new tensors every step: their pointers come by
//     value in the launch's parameters (AdamwArgs.g, up to 32 KB of
//     parameters since CUDA 12.1), not in the table.
//   * 16-byte loads and stores, 8 elements a thread at a time. A leaf
//     whose p, g, m and v reach a 16-byte boundary at the same element
//     (vec_head) takes vectors from there, with a scalar head and tail in
//     each chunk; a leaf whose tensors never line up (views at unequal
//     offsets) takes the scalar loop, in the same kernel.
//   * The norm is deterministic. Each thread sums squares in f32, a
//     chunk's at a time; each block reduces its threads' sums in a fixed
//     tree into one partial. The last block to finish, found by an atomic
//     ticket (no float atomics), sums the partials in a fixed order
//     into its group's sum and resets the ticket for the next launch;
//     the last group's launch adds the earlier groups' sums to its own,
//     in order, and writes norm and scale.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 8;              // elements a thread moves at a time
constexpr int kMaxLeaves = 4000;     // gradient pointers a launch
constexpr int kChunk = 32768;        // elements of a leaf a block takes
enum : int { kBF16 = 0, kF32 = 1 };

// A row of the wrapper's leaf table (int64 x 6): pointers, elements, the
// leaf's first chunk, the dtypes of p and g.
struct Leaf {
  long long p, m, v, n, first;
  int p_dt, g_dt;
};

// Mirror of the wrapper's _Args. The floats are the plain version's
// Python constants rounded to f32 on the host, as PyTorch rounds a
// scalar operand.
struct AdamwArgs {
  const Leaf* leaves;
  float* partials;          // the norm's sums, one a block
  unsigned int* ticket;     // blocks of the norm done
  float* sums;              // the norm's sums, one a group
  float* out;               // [norm, scale]
  const float* lr;
  const float* bc1;
  const float* bc2;
  float b1, b2, c1, c2;     // c1 = 1 - b1, c2 = 1 - b2 (from doubles)
  float eps, wd, max_norm, norm_eps;
  int n_leaves;             // of this launch's group
  int n_chunks;
  int group, n_groups;
  const void* g[kMaxLeaves];
};

static_assert(sizeof(Leaf) == 48, "leaf table row");
static_assert(kChunk % 8 == 0, "chunks of whole vectors");
static_assert(sizeof(AdamwArgs) == 112 + 8 * kMaxLeaves, "AdamwArgs");
static_assert(sizeof(AdamwArgs) <= 32764, "kernel parameters");

namespace {

// The leaf of chunk c: the last row whose first chunk is at most c (an
// empty leaf shares its first chunk with the next one).
__device__ __forceinline__ int leaf_of(const Leaf* leaves, int n,
                                       long long c) {
  int lo = 0, hi = n - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (leaves[mid].first <= c) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// Fold the constraint "a vector starts where `addr` + i * es is 16-byte
// aligned" into (h, period): vectors start at the i = h mod period.
// False where no such i exists or it contradicts the constraints so far.
__device__ __forceinline__ bool fold_head(uintptr_t addr, int es, int& h,
                                          int& period) {
  const int mis = int(addr & 15);
  if (mis % es) return false;
  const int r = ((16 - mis) & 15) / es, q = 16 / es;
  if (q >= period) {
    if (r % period != h) return false;
    h = r;
    period = q;
    return true;
  }
  return h % q == r;
}

// The first element at which all of `n` tensors start a 16-byte piece
// (vectors of kVec elements from there stay aligned), or -1.
__device__ __forceinline__ int vec_head(const uintptr_t* addr, const int* es,
                                        int n) {
  int h = 0, period = 1;
  for (int k = 0; k < n; ++k)
    if (!fold_head(addr[k], es[k], h, period)) return -1;
  return h;
}

// The vector part [a, b) of a chunk [s, e): kVec-element pieces that
// start at h mod kVec. h < 0: none.
__device__ __forceinline__ void vec_span(long long s, long long e, int h,
                                         long long& a, long long& b) {
  if (h < 0) {
    a = b = e;
    return;
  }
  a = s + (((h - s) % kVec) + kVec) % kVec;
  if (a > e) a = e;
  b = a + (e - a) / kVec * kVec;
}

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

__device__ __forceinline__ void ld8(const float* p, float (&x)[kVec]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
  x[4] = b.x; x[5] = b.y; x[6] = b.z; x[7] = b.w;
}

__device__ __forceinline__ void ld8(const __nv_bfloat16* p,
                                    float (&x)[kVec]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k) {
    const float2 f = __bfloat1622float2(h[k]);
    x[2 * k] = f.x;
    x[2 * k + 1] = f.y;
  }
}

__device__ __forceinline__ void st8(float* p, const float (&x)[kVec]) {
  reinterpret_cast<float4*>(p)[0] = make_float4(x[0], x[1], x[2], x[3]);
  reinterpret_cast<float4*>(p)[1] = make_float4(x[4], x[5], x[6], x[7]);
}

__device__ __forceinline__ void st8(__nv_bfloat16* p,
                                    const float (&x)[kVec]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int k = 0; k < kVec / 2; ++k)
    h[k] = __floats2bfloat162_rn(x[2 * k], x[2 * k + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

// Sum of x over the block, in a fixed order; the result in every thread.
__device__ float block_sum(float x) {
  __shared__ float warp_sums[kWarps];
  __syncthreads();                      // warp_sums of a previous call read
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = x;
  __syncthreads();
  float t = 0.f;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) t += warp_sums[w];
  return t;
}

// ------------------------------------------------------------------ norm
template <typename G>
__device__ float chunk_squares(const G* g, long long s, long long e) {
  const uintptr_t addr[1] = {reinterpret_cast<uintptr_t>(g)};
  const int es[1] = {int(sizeof(G))};
  long long a, b;
  vec_span(s, e, vec_head(addr, es, 1), a, b);
  float acc = 0.f;
  for (long long i = s + threadIdx.x; i < a; i += kThreads) {
    const float x = to_f(g[i]);
    acc = fmaf(x, x, acc);
  }
  for (long long i = a + threadIdx.x * (long long)kVec; i < b;
       i += kThreads * (long long)kVec) {
    float x[kVec];
    ld8(g + i, x);
#pragma unroll
    for (int k = 0; k < kVec; ++k) acc = fmaf(x[k], x[k], acc);
  }
  for (long long i = b + threadIdx.x; i < e; i += kThreads) {
    const float x = to_f(g[i]);
    acc = fmaf(x, x, acc);
  }
  return acc;
}

__global__ void __launch_bounds__(kThreads)
    adamw_norm_kernel(const __grid_constant__ AdamwArgs a) {
  float total = 0.f;
  for (int c = blockIdx.x; c < a.n_chunks; c += gridDim.x) {
    const int li = leaf_of(a.leaves, a.n_leaves, c);
    const Leaf lf = a.leaves[li];
    const void* g = a.g[li];
    const long long s = (c - lf.first) * kChunk;
    const long long e = s + kChunk < lf.n ? s + kChunk : lf.n;
    total += lf.g_dt == kBF16
                 ? chunk_squares(static_cast<const __nv_bfloat16*>(g), s, e)
                 : chunk_squares(static_cast<const float*>(g), s, e);
  }
  total = block_sum(total);
  __shared__ bool last;
  if (threadIdx.x == 0) {
    a.partials[blockIdx.x] = total;
    __threadfence();                    // the partial before the ticket
    last = atomicAdd(a.ticket, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!last) return;
  __threadfence();
  float t = 0.f;
  for (int i = threadIdx.x; i < int(gridDim.x); i += kThreads)
    t += __ldcg(a.partials + i);
  t = block_sum(t);
  if (threadIdx.x == 0) {
    a.sums[a.group] = t;
    *a.ticket = 0u;
  }
  if (threadIdx.x == 0 && a.group == a.n_groups - 1) {
    // the earlier groups' sums: written by earlier launches on the stream
    for (int k = 0; k < a.group; ++k) t = __fadd_rn(t, a.sums[k]);
    // torch.sqrt, then clamp(max_norm / (norm + 1e-9), max=1.0), where a
    // Python number over a tensor is reciprocal() * number; the clamp
    // passes NaN
    const float norm = __fsqrt_rn(t);
    const float r = __fdiv_rn(1.f, __fadd_rn(norm, a.norm_eps));
    const float s = __fmul_rn(r, a.max_norm);
    a.out[0] = norm;
    a.out[1] = isnan(s) ? s : fminf(s, 1.f);
  }
}

// ---------------------------------------------------------------- update
struct Hyper {
  float b1, b2, c1, c2, eps, wd, lr, bc1, bc2, scale, scale_bf;
};

template <typename G>
__device__ __forceinline__ float clipped(float g, const Hyper& h);
template <>
__device__ __forceinline__ float clipped<float>(float g, const Hyper& h) {
  return __fmul_rn(g, h.scale);
}
template <>
__device__ __forceinline__ float clipped<__nv_bfloat16>(float g,
                                                        const Hyper& h) {
  return __bfloat162float(__float2bfloat16_rn(__fmul_rn(g, h.scale_bf)));
}

// adamw_update's arithmetic on one element, operation by operation.
__device__ __forceinline__ void adamw(float& p, float g, float& m, float& v,
                                      const Hyper& h) {
  m = __fadd_rn(__fmul_rn(m, h.b1), __fmul_rn(h.c1, g));
  v = __fadd_rn(__fmul_rn(v, h.b2), __fmul_rn(__fmul_rn(h.c2, g), g));
  const float mh = __fdiv_rn(m, h.bc1);
  const float vh = __fdiv_rn(v, h.bc2);
  const float q = __fdiv_rn(mh, __fadd_rn(__fsqrt_rn(vh), h.eps));
  const float delta = __fadd_rn(q, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(h.lr, delta));
}

template <typename P, typename G>
__device__ void chunk_update(const Leaf& lf, const G* __restrict__ g,
                             long long s, long long e, const Hyper& h) {
  P* __restrict__ p = reinterpret_cast<P*>(lf.p);
  float* __restrict__ m = reinterpret_cast<float*>(lf.m);
  float* __restrict__ v = reinterpret_cast<float*>(lf.v);
  const uintptr_t addr[4] = {uintptr_t(p), uintptr_t(g), uintptr_t(m),
                             uintptr_t(v)};
  const int es[4] = {int(sizeof(P)), int(sizeof(G)), 4, 4};
  long long a, b;
  vec_span(s, e, vec_head(addr, es, 4), a, b);
  auto one = [&](long long i) {
    float pf = to_f(p[i]), mf = m[i], vf = v[i];
    adamw(pf, clipped<G>(to_f(g[i]), h), mf, vf, h);
    p[i] = from_f<P>(pf);
    m[i] = mf;
    v[i] = vf;
  };
  for (long long i = s + threadIdx.x; i < a; i += kThreads) one(i);
  for (long long i = a + threadIdx.x * (long long)kVec; i < b;
       i += kThreads * (long long)kVec) {
    float pf[kVec], gf[kVec], mf[kVec], vf[kVec];
    ld8(g + i, gf);
    ld8(p + i, pf);
    ld8(m + i, mf);
    ld8(v + i, vf);
#pragma unroll
    for (int k = 0; k < kVec; ++k)
      adamw(pf[k], clipped<G>(gf[k], h), mf[k], vf[k], h);
    st8(p + i, pf);
    st8(m + i, mf);
    st8(v + i, vf);
  }
  for (long long i = b + threadIdx.x; i < e; i += kThreads) one(i);
}

__global__ void __launch_bounds__(kThreads)
    adamw_update_kernel(const __grid_constant__ AdamwArgs a) {
  Hyper h;
  h.b1 = a.b1;
  h.b2 = a.b2;
  h.c1 = a.c1;
  h.c2 = a.c2;
  h.eps = a.eps;
  h.wd = a.wd;
  h.lr = *a.lr;
  h.bc1 = *a.bc1;
  h.bc2 = *a.bc2;
  h.scale = a.out[1];
  h.scale_bf = __bfloat162float(__float2bfloat16_rn(h.scale));
  for (int c = blockIdx.x; c < a.n_chunks; c += gridDim.x) {
    const int li = leaf_of(a.leaves, a.n_leaves, c);
    const Leaf lf = a.leaves[li];
    const void* g = a.g[li];
    const long long s = (c - lf.first) * kChunk;
    const long long e = s + kChunk < lf.n ? s + kChunk : lf.n;
    using bf = __nv_bfloat16;
    switch (lf.p_dt * 2 + lf.g_dt) {
      case kBF16 * 2 + kBF16:
        chunk_update<bf>(lf, static_cast<const bf*>(g), s, e, h);
        break;
      case kBF16 * 2 + kF32:
        chunk_update<bf>(lf, static_cast<const float*>(g), s, e, h);
        break;
      case kF32 * 2 + kBF16:
        chunk_update<float>(lf, static_cast<const bf*>(g), s, e, h);
        break;
      default:
        chunk_update<float>(lf, static_cast<const float*>(g), s, e, h);
    }
  }
}

}  // namespace

// Blocks of the fixed grid on the current device: the SMs times the
// blocks an SM holds of the kernel that holds fewer (0 on error).
extern "C" int adamw_grid() {
  int dev = 0, sms = 0, n_norm = 0, n_update = 0;
  if (cudaGetDevice(&dev) != cudaSuccess ||
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev) !=
          cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n_norm, adamw_norm_kernel, kThreads, 0) != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n_update, adamw_update_kernel, kThreads, 0) != cudaSuccess)
    return 0;
  return sms * (n_norm < n_update ? n_norm : n_update);
}

extern "C" int adamw_max_leaves() { return kMaxLeaves; }

extern "C" int adamw_chunk() { return kChunk; }

extern "C" int adamw_args_bytes() { return int(sizeof(AdamwArgs)); }

extern "C" int adamw_norm(const AdamwArgs* a, int grid, void* stream) {
  adamw_norm_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      *a);
  return int(cudaGetLastError());
}

extern "C" int adamw_update(const AdamwArgs* a, int grid, void* stream) {
  adamw_update_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(*a);
  return int(cudaGetLastError());
}

extern "C" const char* adamw_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
