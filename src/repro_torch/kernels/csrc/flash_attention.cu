// Flash attention for Hopper: the forward with online softmax, and its
// backward, for GQA with causal, sliding-window and tanh-softcap masks.
//
// Replaces the TPU kernel repro/kernels/flash_attention.py:_attn_kernel
// (launched by flash_attention). The JAX package has no backward kernel:
// its training differentiates the jnp oracle, and jax.grad cannot pass
// through the Pallas call. The backward here is the standard flash
// backward (recompute P from the saved log-sum-exp), written by hand.
// Plain versions: repro_torch/kernels/ref.py:flash_attention_ref and
// flash_attention_bwd_ref. Wrapper, checks, autograd and launch counts:
// repro_torch/kernels/flash_attention.py.
//
// Layout. q and o are [B,S,nq,hd], k and v [B,T,nkv,hd], read through
// their batch, sequence and head strides (the head dim is contiguous);
// JAX's moveaxis and padding become index math and masks. Query head h
// reads kv head h / (nq/nkv). lse and the scratch D are [B,nq,S] f32.
// The causal mask is start-aligned (query i sees keys <= i), as in the
// TPU kernel; the wrapper sends only S == T calls when a mask is set.
//
// Bound. At the training path's shape (B=4, S=T=2048, 14:2 heads, hd=64,
// causal, bf16) the forward does 30.1 GFLOP on 34 MB and the backward's
// five products 75.2 GFLOP: both are bound by operations, 0.030 ms and
// 0.076 ms at the H100 SXM's 989 bf16 tensor-core TFLOP/s (arithmetic).
//
// Design: simple and right first. No tensor cores, no wgmma, no TMA, no
// cp.async: tiles are staged in shared memory as f32 by plain loads and
// every product runs on the CUDA cores in f32 (67 TFLOP/s on the H100
// SXM, so the kernels sit far above the bound).
//   * 64x64 tiles, 128 threads. Thread (tx, ty) = (tid % 16, tid / 16)
//     owns tile rows ty*8 .. ty*8+7 and columns tx + 16*j, so the 16
//     threads that share a row are one half-warp and row maxima and sums
//     are shuffles. Operands read along rows are stored transposed with
//     a stride of 68 floats (two float4 loads give a thread its 8 rows);
//     operands read along columns are stored row-major with a stride of
//     hd+1 floats (the 16 columns of a half-warp fall in 16 banks).
//   * Forward: one block per (q tile, q head, batch), the KV loop inside
//     the block (blocks run in no order, so nothing carries between
//     them). Dead KV tiles are skipped by the TPU kernel's test
//     (flash_attention.py:50-54). Running max, denominator and the
//     accumulator stay in f32 registers; p is masked explicitly, so a
//     live tile in which a row has no valid key adds nothing to it.
//     The denominator is clamped at 1e-30 and the output rounded once.
//   * Backward, two launches and no atomics (the gradients are the same
//     from run to run):
//       dq:   one block per (q tile, q head, batch); first D = rowsum(
//             dO * O) for its rows (also written to scratch for dkdv),
//             then over the live k tiles P = exp(s - lse),
//             dS = P * (dP - D) [* (1 - tanh^2) with softcap],
//             dQ += scale * dS K.
//       dk/dv: one block per (k tile, kv head, batch), looping over the
//             group's nq/nkv query heads and the live q tiles:
//             dV += P^T dO, dK += scale * dS^T Q.
//   * Shared memory per block (dynamic), hd = 64 / 128: forward 68 / 118
//     KB, dq 86 / 154 KB, dk/dv 103 / 171 KB.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Arguments of every launch; mirrored by ctypes.Structure in
// flash_attention.py (pointers, then 64-bit strides, then ints, floats).
struct FlashArgs {
  const void* q;
  const void* k;
  const void* v;
  const void* o;        // backward: the forward's output
  const void* dout;     // backward: dL/do
  void* out;            // forward: o [B,S,nq,hd], contiguous
  float* lse;           // [B,nq,S]: forward writes, backward reads
  float* dsum;          // [B,nq,S] scratch: D = rowsum(dO * O)
  void* dq;             // [B,S,nq,hd], contiguous
  void* dk;             // [B,T,nkv,hd], contiguous
  void* dv;
  long long q_sb, q_ss, q_sh;
  long long k_sb, k_ss, k_sh;
  long long v_sb, v_ss, v_sh;
  long long o_sb, o_ss, o_sh;
  long long do_sb, do_ss, do_sh;
  int B, S, T, nq, nkv;
  int causal;
  int window;           // <= 0: none
  float scale;
  float softcap;        // <= 0: none
};

namespace {

constexpr int kTile = 64;          // rows of a q tile and of a k tile
constexpr int kThreads = 128;
constexpr int kTX = 16;            // threads along a tile row
constexpr int kRowsPer = 8;        // tile rows per thread (64 / 8 ty)
constexpr int kColsPer = 4;        // tile columns per thread (64 / 16 tx)
constexpr int kLdT = kTile + 4;    // stride of transposed tiles (16B rows)
constexpr float kNegInf = -1e30f;  // the masked score, as in the TPU kernel

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

// A (q tile, k tile) pair holds a live score unless the causal or the
// window test rules the whole tile out (flash_attention.py:50-54).
__device__ __forceinline__ bool tile_live(const FlashArgs& a, int q0, int k0) {
  if (a.causal && k0 > q0 + kTile - 1) return false;
  if (a.window > 0 && k0 + kTile - 1 <= q0 - a.window) return false;
  return true;
}

__device__ __forceinline__ bool score_valid(const FlashArgs& a, int qpos,
                                            int kpos) {
  if (qpos >= a.S || kpos >= a.T) return false;
  if (a.causal && kpos > qpos) return false;
  if (a.window > 0 && kpos <= qpos - a.window) return false;
  return true;
}

// Scaled, softcapped score; `cap_t` gets tanh(u / softcap) for the
// backward's derivative (0 without softcap).
__device__ __forceinline__ float score(const FlashArgs& a, float dot,
                                       float* cap_t) {
  const float u = dot * a.scale;
  if (a.softcap > 0.f) {
    const float t = tanhf(u / a.softcap);
    *cap_t = t;
    return t * a.softcap;
  }
  *cap_t = 0.f;
  return u;
}

// The first 64 rows of a [len, HD] slab with row stride `rs` into
// shared memory. Row-major: dst[r * (HD+1) + d]. Transposed:
// dst[d * kLdT + r]. Rows past `len` are zeros.
template <typename T, int HD>
__device__ __forceinline__ void load_rows(float* dst, const T* src,
                                          long long rs, int len) {
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[r * (HD + 1) + d] =
        r < len ? to_f32(src[static_cast<long long>(r) * rs + d]) : 0.f;
  }
}

template <typename T, int HD>
__device__ __forceinline__ void load_rows_t(float* dst, const T* src,
                                            long long rs, int len) {
  for (int i = threadIdx.x; i < kTile * HD; i += kThreads) {
    const int r = i / HD, d = i % HD;
    dst[d * kLdT + r] =
        r < len ? to_f32(src[static_cast<long long>(r) * rs + d]) : 0.f;
  }
}

// acc[i][j] += sum_d at[d][ty*8+i] * bs[(tx+16j)*LDB + d]   (A B^T)
template <int N, int KD, int LDB>
__device__ __forceinline__ void mma_nt(float (&acc)[kRowsPer][N],
                                       const float* at, const float* bs,
                                       int tx, int ty) {
#pragma unroll 4
  for (int d = 0; d < KD; ++d) {
    const float4 a0 = *reinterpret_cast<const float4*>(at + d * kLdT + ty * 8);
    const float4 a1 =
        *reinterpret_cast<const float4*>(at + d * kLdT + ty * 8 + 4);
    const float a[kRowsPer] = {a0.x, a0.y, a0.z, a0.w,
                               a1.x, a1.y, a1.z, a1.w};
    float b[N];
#pragma unroll
    for (int j = 0; j < N; ++j) b[j] = bs[(tx + kTX * j) * LDB + d];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// acc[i][j] += sum_k at[k][ty*8+i] * bs[k*LDB + tx+16j]   (A B)
template <int N, int KD, int LDB>
__device__ __forceinline__ void mma_nn(float (&acc)[kRowsPer][N],
                                       const float* at, const float* bs,
                                       int tx, int ty) {
#pragma unroll 4
  for (int k = 0; k < KD; ++k) {
    const float4 a0 = *reinterpret_cast<const float4*>(at + k * kLdT + ty * 8);
    const float4 a1 =
        *reinterpret_cast<const float4*>(at + k * kLdT + ty * 8 + 4);
    const float a[kRowsPer] = {a0.x, a0.y, a0.z, a0.w,
                               a1.x, a1.y, a1.z, a1.w};
    float b[N];
#pragma unroll
    for (int j = 0; j < N; ++j) b[j] = bs[k * LDB + tx + kTX * j];
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
      for (int j = 0; j < N; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
  }
}

// Store v[i][j] (tile row ty*8+i, column tx+16j) transposed:
// dst[(tx+16j) * kLdT + ty*8 + i], two float4 per column.
__device__ __forceinline__ void store_t(float* dst,
                                        const float (&v)[kRowsPer][kColsPer],
                                        int tx, int ty) {
#pragma unroll
  for (int j = 0; j < kColsPer; ++j) {
    float* p = dst + (tx + kTX * j) * kLdT + ty * 8;
    *reinterpret_cast<float4*>(p) = make_float4(v[0][j], v[1][j], v[2][j],
                                                v[3][j]);
    *reinterpret_cast<float4*>(p + 4) = make_float4(v[4][j], v[5][j], v[6][j],
                                                    v[7][j]);
  }
}

// Reductions over the 16 threads of a half-warp that share a tile row.
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// ------------------------------------------------------------- forward
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const FlashArgs a) {
  constexpr int N = HD / kTX;              // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                        // [HD][kLdT]
  float* ks = qt + HD * kLdT;              // [64][HD+1]
  float* vs = ks + kTile * (HD + 1);       // [64][HD+1]
  float* pt = vs + kTile * (HD + 1);       // [64][kLdT]: P transposed

  const int tx = threadIdx.x % kTX, ty = threadIdx.x / kTX;
  const int n_qt = (a.S + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - blockIdx.x) * kTile;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.nq / a.nkv);
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  load_rows_t<T, HD>(qt, qp + static_cast<long long>(q0) * a.q_ss, a.q_ss,
                     a.S - q0);
  float m[kRowsPer], l[kRowsPer], acc[kRowsPer][N];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = (a.T + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_live(a, q0, k0)) continue;
    __syncthreads();                       // done with the last tile
    load_rows<T, HD>(ks, kp + static_cast<long long>(k0) * a.k_ss, a.k_ss,
                     a.T - k0);
    load_rows<T, HD>(vs, vp + static_cast<long long>(k0) * a.v_ss, a.v_ss,
                     a.T - k0);
    __syncthreads();

    float s[kRowsPer][kColsPer] = {};
    mma_nt<kColsPer, HD, HD + 1>(s, qt, ks, tx, ty);
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int qpos = q0 + ty * 8 + i;
      bool ok[kColsPer];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) {
        float t;
        ok[j] = score_valid(a, qpos, k0 + tx + kTX * j);
        s[i][j] = ok[j] ? score(a, s[i][j], &t) : kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_max(mx));
      const float alpha = expf(m[i] - m_new);
      float sum = 0.f;
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) {
        s[i][j] = ok[j] ? expf(s[i][j] - m_new) : 0.f;   // p, masked
        sum += s[i][j];
      }
      l[i] = l[i] * alpha + row_sum(sum);
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < N; ++j) acc[i][j] *= alpha;
    }
    store_t(pt, s, tx, ty);
    __syncthreads();
    mma_nn<N, kTile, HD + 1>(acc, pt, vs, tx, ty);
  }

  T* op = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int qpos = q0 + ty * 8 + i;
    if (qpos >= a.S) continue;
    const float inv = 1.f / fmaxf(l[i], 1e-30f);
    T* row = op + ((static_cast<long long>(b) * a.S + qpos) * a.nq + h) * HD;
#pragma unroll
    for (int j = 0; j < N; ++j) row[tx + kTX * j] = from_f32<T>(acc[i][j] * inv);
    if (tx == 0)
      a.lse[(static_cast<long long>(b) * a.nq + h) * a.S + qpos] =
          m[i] + logf(l[i]);
  }
}

// ------------------------------------------------------------ backward
// dq kernel; also writes D = rowsum(dO * O) for the dk/dv kernel.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const FlashArgs a) {
  constexpr int N = HD / kTX;
  extern __shared__ __align__(16) float smem[];
  float* qt = smem;                        // [HD][kLdT]
  float* dot = qt + HD * kLdT;             // [HD][kLdT]: dO transposed
  float* ks = dot + HD * kLdT;             // [64][HD+1]
  float* vs = ks + kTile * (HD + 1);       // [64][HD+1]
  float* dst = vs + kTile * (HD + 1);      // [64][kLdT]: dS transposed
  float* d_s = dst + kTile * kLdT;         // [64]
  float* lse_s = d_s + kTile;              // [64]

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int n_qt = (a.S + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - blockIdx.x) * kTile;
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.nq / a.nkv);
  const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const T* op = static_cast<const T*>(a.o) + b * a.o_sb + h * a.o_sh;
  const T* dop = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const long long rowbase = (static_cast<long long>(b) * a.nq + h) * a.S;

  load_rows_t<T, HD>(qt, qp + static_cast<long long>(q0) * a.q_ss, a.q_ss,
                     a.S - q0);
  load_rows_t<T, HD>(dot, dop + static_cast<long long>(q0) * a.do_ss,
                     a.do_ss, a.S - q0);
  {  // D for the tile's 64 rows: two threads per row, one half of hd each
    const int r = tid / 2, half = tid % 2;
    const int qpos = q0 + r;
    float part = 0.f;
    if (qpos < a.S) {
      const T* orow = op + static_cast<long long>(qpos) * a.o_ss;
      const T* drow = dop + static_cast<long long>(qpos) * a.do_ss;
      for (int d = half * (HD / 2); d < (half + 1) * (HD / 2); ++d)
        part += to_f32(orow[d]) * to_f32(drow[d]);
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      d_s[r] = part;
      lse_s[r] = qpos < a.S ? a.lse[rowbase + qpos] : 0.f;
      if (qpos < a.S) a.dsum[rowbase + qpos] = part;
    }
  }
  __syncthreads();
  float dsum[kRowsPer], lse[kRowsPer], acc[kRowsPer][N];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    dsum[i] = d_s[ty * 8 + i];
    lse[i] = lse_s[ty * 8 + i];
#pragma unroll
    for (int j = 0; j < N; ++j) acc[i][j] = 0.f;
  }

  const int n_kt = (a.T + kTile - 1) / kTile;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * kTile;
    if (!tile_live(a, q0, k0)) continue;
    __syncthreads();
    load_rows<T, HD>(ks, kp + static_cast<long long>(k0) * a.k_ss, a.k_ss,
                     a.T - k0);
    load_rows<T, HD>(vs, vp + static_cast<long long>(k0) * a.v_ss, a.v_ss,
                     a.T - k0);
    __syncthreads();

    float s[kRowsPer][kColsPer] = {};
    float dp[kRowsPer][kColsPer] = {};
    mma_nt<kColsPer, HD, HD + 1>(s, qt, ks, tx, ty);
    mma_nt<kColsPer, HD, HD + 1>(dp, dot, vs, tx, ty);
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      const int qpos = q0 + ty * 8 + i;
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) {
        float t;
        const float x = score(a, s[i][j], &t);
        const float p = score_valid(a, qpos, k0 + tx + kTX * j)
                            ? expf(x - lse[i]) : 0.f;
        float ds = p * (dp[i][j] - dsum[i]);
        if (a.softcap > 0.f) ds *= 1.f - t * t;
        s[i][j] = ds;
      }
    }
    store_t(dst, s, tx, ty);
    __syncthreads();
    mma_nn<N, kTile, HD + 1>(acc, dst, ks, tx, ty);
  }

  T* dq = static_cast<T*>(a.dq);
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int qpos = q0 + ty * 8 + i;
    if (qpos >= a.S) continue;
    T* row = dq + ((static_cast<long long>(b) * a.S + qpos) * a.nq + h) * HD;
#pragma unroll
    for (int j = 0; j < N; ++j)
      row[tx + kTX * j] = from_f32<T>(acc[i][j] * a.scale);
  }
}

// dk/dv kernel: tile rows are keys, tile columns queries.
template <typename T, int HD>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const FlashArgs a) {
  constexpr int N = HD / kTX;
  extern __shared__ __align__(16) float smem[];
  float* kt_s = smem;                      // [HD][kLdT]: K transposed
  float* vt_s = kt_s + HD * kLdT;          // [HD][kLdT]: V transposed
  float* qs = vt_s + HD * kLdT;            // [64][HD+1]
  float* dos = qs + kTile * (HD + 1);      // [64][HD+1]
  float* pb = dos + kTile * (HD + 1);      // [64 q][kLdT]: P, keys inner
  float* dsb = pb + kTile * kLdT;          // [64 q][kLdT]: dS, keys inner
  float* d_s = dsb + kTile * kLdT;         // [64]
  float* lse_s = d_s + kTile;              // [64]

  const int tid = threadIdx.x;
  const int tx = tid % kTX, ty = tid / kTX;
  const int k0 = blockIdx.x * kTile;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int group = a.nq / a.nkv;
  const T* kp = static_cast<const T*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const T* vp = static_cast<const T*>(a.v) + b * a.v_sb + hk * a.v_sh;

  load_rows_t<T, HD>(kt_s, kp + static_cast<long long>(k0) * a.k_ss, a.k_ss,
                     a.T - k0);
  load_rows_t<T, HD>(vt_s, vp + static_cast<long long>(k0) * a.v_ss, a.v_ss,
                     a.T - k0);
  float dk[kRowsPer][N], dv[kRowsPer][N];
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
    for (int j = 0; j < N; ++j) dk[i][j] = dv[i][j] = 0.f;

  const int n_qt = (a.S + kTile - 1) / kTile;
  for (int g = 0; g < group; ++g) {
    const int h = hk * group + g;
    const T* qp = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh;
    const T* dop = static_cast<const T*>(a.dout) + b * a.do_sb + h * a.do_sh;
    const long long rowbase = (static_cast<long long>(b) * a.nq + h) * a.S;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q0 = qt * kTile;
      if (!tile_live(a, q0, k0)) continue;
      __syncthreads();
      load_rows<T, HD>(qs, qp + static_cast<long long>(q0) * a.q_ss, a.q_ss,
                       a.S - q0);
      load_rows<T, HD>(dos, dop + static_cast<long long>(q0) * a.do_ss,
                       a.do_ss, a.S - q0);
      if (tid < kTile) {
        const bool in = q0 + tid < a.S;
        d_s[tid] = in ? a.dsum[rowbase + q0 + tid] : 0.f;
        lse_s[tid] = in ? a.lse[rowbase + q0 + tid] : 0.f;
      }
      __syncthreads();

      // s[i][j]: key k0+ty*8+i against query q0+tx+16j
      float s[kRowsPer][kColsPer] = {};
      mma_nt<kColsPer, HD, HD + 1>(s, kt_s, qs, tx, ty);
      float lse[kColsPer], dsum[kColsPer];
#pragma unroll
      for (int j = 0; j < kColsPer; ++j) {
        lse[j] = lse_s[tx + kTX * j];
        dsum[j] = d_s[tx + kTX * j];
      }
      unsigned valid = 0u;             // bit i*4+j
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int j = 0; j < kColsPer; ++j) {
          float t;
          const bool ok = score_valid(a, q0 + tx + kTX * j, k0 + ty * 8 + i);
          valid |= static_cast<unsigned>(ok) << (i * kColsPer + j);
          s[i][j] = score(a, s[i][j], &t);           // the capped score x
        }
      float p[kRowsPer][kColsPer];
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int j = 0; j < kColsPer; ++j)
          p[i][j] = (valid >> (i * kColsPer + j)) & 1u
                        ? expf(s[i][j] - lse[j]) : 0.f;
      store_t(pb, p, tx, ty);
      float dp[kRowsPer][kColsPer] = {};
      mma_nt<kColsPer, HD, HD + 1>(dp, vt_s, dos, tx, ty);
#pragma unroll
      for (int i = 0; i < kRowsPer; ++i)
#pragma unroll
        for (int j = 0; j < kColsPer; ++j) {
          const bool ok = (valid >> (i * kColsPer + j)) & 1u;
          float ds = ok ? expf(s[i][j] - lse[j]) * (dp[i][j] - dsum[j]) : 0.f;
          if (a.softcap > 0.f) {
            const float t = s[i][j] / a.softcap;     // tanh(u / softcap)
            ds *= 1.f - t * t;
          }
          dp[i][j] = ds;
        }
      store_t(dsb, dp, tx, ty);
      __syncthreads();
      mma_nn<N, kTile, HD + 1>(dv, pb, dos, tx, ty);
      mma_nn<N, kTile, HD + 1>(dk, dsb, qs, tx, ty);
    }
  }

  T* dkp = static_cast<T*>(a.dk);
  T* dvp = static_cast<T*>(a.dv);
#pragma unroll
  for (int i = 0; i < kRowsPer; ++i) {
    const int kpos = k0 + ty * 8 + i;
    if (kpos >= a.T) continue;
    const long long base =
        ((static_cast<long long>(b) * a.T + kpos) * a.nkv + hk) * HD;
#pragma unroll
    for (int j = 0; j < N; ++j) {
      dkp[base + tx + kTX * j] = from_f32<T>(dk[i][j] * a.scale);
      dvp[base + tx + kTX * j] = from_f32<T>(dv[i][j]);
    }
  }
}

template <int HD>
constexpr int fwd_smem() {
  return (HD * kLdT + 2 * kTile * (HD + 1) + kTile * kLdT) * 4;
}
template <int HD>
constexpr int dq_smem() {
  return (2 * HD * kLdT + 2 * kTile * (HD + 1) + kTile * kLdT + 2 * kTile) * 4;
}
template <int HD>
constexpr int dkdv_smem() {
  return (2 * HD * kLdT + 2 * kTile * (HD + 1) + 2 * kTile * kLdT +
          2 * kTile) * 4;
}

template <typename Kernel>
int launch(Kernel kernel, dim3 grid, int smem, const FlashArgs& a,
           void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, int HD>
int fwd(const FlashArgs& a, void* stream) {
  const dim3 grid((a.S + kTile - 1) / kTile, a.nq, a.B);
  return launch(flash_fwd_kernel<T, HD>, grid, fwd_smem<HD>(), a, stream);
}

template <typename T, int HD>
int bwd_dq(const FlashArgs& a, void* stream) {
  const dim3 grid((a.S + kTile - 1) / kTile, a.nq, a.B);
  return launch(flash_bwd_dq_kernel<T, HD>, grid, dq_smem<HD>(), a, stream);
}

template <typename T, int HD>
int bwd_dkdv(const FlashArgs& a, void* stream) {
  const dim3 grid((a.T + kTile - 1) / kTile, a.nkv, a.B);
  return launch(flash_bwd_dkdv_kernel<T, HD>, grid, dkdv_smem<HD>(), a,
                stream);
}

constexpr int kBadHeadDim = -1;

// Dispatch on dtype (0 = f32, 1 = bf16) and head dim (16, 64, 128).
template <template <typename, int> class Op>
int dispatch(const FlashArgs& a, int hd, int bf16, void* stream) {
  if (bf16) {
    switch (hd) {
      case 16: return Op<__nv_bfloat16, 16>::run(a, stream);
      case 64: return Op<__nv_bfloat16, 64>::run(a, stream);
      case 128: return Op<__nv_bfloat16, 128>::run(a, stream);
    }
  } else {
    switch (hd) {
      case 16: return Op<float, 16>::run(a, stream);
      case 64: return Op<float, 64>::run(a, stream);
      case 128: return Op<float, 128>::run(a, stream);
    }
  }
  return kBadHeadDim;
}

template <typename T, int HD>
struct Fwd {
  static int run(const FlashArgs& a, void* s) { return fwd<T, HD>(a, s); }
};
template <typename T, int HD>
struct BwdDq {
  static int run(const FlashArgs& a, void* s) { return bwd_dq<T, HD>(a, s); }
};
template <typename T, int HD>
struct BwdDkdv {
  static int run(const FlashArgs& a, void* s) {
    return bwd_dkdv<T, HD>(a, s);
  }
};

}  // namespace

// Plain C entry points for ctypes. Each launches one kernel on `stream`
// and returns cudaGetLastError() after the launch (0 = cudaSuccess), or
// -1 for a head dim that has no instantiation.
extern "C" int flash_attention_fwd(const FlashArgs* a, int hd, int bf16,
                                   void* stream) {
  return dispatch<Fwd>(*a, hd, bf16, stream);
}

// Must run before flash_attention_bwd_dkdv on the same stream: it writes
// the D scratch that the dk/dv kernel reads.
extern "C" int flash_attention_bwd_dq(const FlashArgs* a, int hd, int bf16,
                                      void* stream) {
  return dispatch<BwdDq>(*a, hd, bf16, stream);
}

extern "C" int flash_attention_bwd_dkdv(const FlashArgs* a, int hd, int bf16,
                                        void* stream) {
  return dispatch<BwdDkdv>(*a, hd, bf16, stream);
}

// Dynamic shared memory of a launch: which = 0 forward, 1 dq, 2 dk/dv.
extern "C" int flash_attention_smem_bytes(int which, int hd) {
  switch (hd) {
    case 16: return which == 0 ? fwd_smem<16>() : which == 1 ? dq_smem<16>()
                                                             : dkdv_smem<16>();
    case 64: return which == 0 ? fwd_smem<64>() : which == 1 ? dq_smem<64>()
                                                             : dkdv_smem<64>();
    case 128: return which == 0 ? fwd_smem<128>()
                     : which == 1 ? dq_smem<128>() : dkdv_smem<128>();
  }
  return kBadHeadDim;
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code == kBadHeadDim) return "head dim has no kernel (16, 64, 128)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
