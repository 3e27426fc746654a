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
// The backward's two kernels recompute S (and dP) in each, 7 products in
// all: dq's 3 are bound at 0.046 ms, dk/dv's 4 at 0.061, both 0.106.
//
// Forward, bf16: flash_fwd_mma_kernel, FlashAttention-2's organisation on
// the tensor cores (mma.sync m16n8k16, bf16 in, f32 accumulators):
//   * One block per (64-row q tile, q head, batch), 4 warps; each warp
//     owns 16 query rows and keeps their Q fragments in registers.
//   * K and V tiles of 64 keys arrive by cp.async (16 B a copy, rows past
//     T zero-filled) in two shared-memory stages: the next live tile loads
//     while this one is used. Rows are padded by 16 B, so ldmatrix's 8
//     rows fall in 8 different bank groups. K is read with ldmatrix as
//     the B operand of Q K^T, V with ldmatrix.trans as the B operand of
//     P V.
//   * S, the running max and the denominator stay in f32 registers (the
//     softmax in base 2, lse returned in base e). P is packed from S's
//     accumulator fragment straight into P V's A fragment, rounded to
//     bf16: the one rounding the design adds. The denominator is summed
//     from the f32 P, so lse means what it meant.
//   * Each tile's softmax is one of three instantiations, chosen once per
//     tile: no mask and no softcap (every tile below the causal diagonal;
//     one FFMA and one ex2 an element), masked, or softcapped. One loop
//     with a per-element test compiled to a branch around every ex2.
//   * Masks, the dead-tile test (tile_live), the -1e30 sentinel with p
//     masked explicitly, the 1e-30 clamp and the single rounding of the
//     output are the f32 kernel's.
//   * Measured on an H100 SXM at 700 W (PERF.md): 0.19 ms at the training
//     shape against SDPA's 0.09, with a lean inner loop (~370
//     instructions a warp a tile). A third K/V stage, a larger shared-
//     memory carveout, 2 blocks an SM by launch bounds, 32 rows a warp, 8
//     warps a block, tree reductions and issuing the next tile's Q K^T
//     before this tile's softmax each left it within 3% or made it
//     slower. wgmma (FlashAttention-3) is the next design.
//   * The inputs' base addresses and batch, sequence and head strides
//     must be 16-byte aligned (cp.async); the wrapper copies any that are
//     not.
//
// Backward, bf16: FlashAttention-2's backward on the same mma.sync, in
// two launches and no atomics (the gradients are the same bits from run
// to run). P = 2^(dot * scale * log2e - lse * log2e) is recomputed from
// the saved lse, dS = P (dP - D) [* (1 - tanh^2) under softcap], in f32
// in the accumulator fragments, in the forward's three modes a tile. P
// and dS are rounded to bf16 once, when packed straight into the A
// fragments of the products they feed; neither touches shared memory.
//   * flash_bwd_dq_mma_kernel: one block per (64-row q tile, q head,
//     batch), longest rows first, 4 warps of 16 rows. D = rowsum(dO * O)
//     from the bf16 values, for its rows, also written to the scratch
//     for dk/dv. K and V stream through two cp.async stages; S = Q K^T
//     and dP = dO V^T read K and V by ldmatrix, dQ += dS K reads K by
//     ldmatrix.trans. Q and dO fragments come from shared memory at each
//     use: held in registers they left room for only 2 blocks an SM.
//   * flash_bwd_dkdv_mma_kernel, transposed: one block per (64-key tile,
//     kv head, batch), each warp owning 16 keys, with K and V fragments
//     in registers (from shared memory at hd 128). S^T = K Q^T and dP^T =
//     V dO^T read Q and dO tiles by ldmatrix, dV += P^T dO and dK +=
//     dS^T Q read them by ldmatrix.trans; lse and D of the tile's queries
//     arrive in shared memory with them. A k tile's work is its group's
//     query heads times its live q tiles (224 steps at k0 = 0 on the
//     causal path, 7 at the last tile): two warpgroups take every other
//     (head, q tile) pair, each with its own two cp.async stages and
//     named barrier, and sum dK and dV through shared memory at the end
//     in a fixed order. The grid puts the k tile last, so the longest
//     blocks start first. At hd 128 a step takes 32 queries (dK and dV
//     hold 128 registers a thread).
//   * Measured on an H100 SXM at 700 W (PERF.md): dq 0.23 ms and
//     dk/dv 0.25 ms at the training shape, 0.48 ms in all against SDPA's
//     backward at 0.29 (was 8.67 on the CUDA cores); ~22% of the 7
//     products' bound. Each warp reads whole Q and dO (or K and V) tiles
//     for its 16 rows: a 512-byte ldmatrix.x4 feeds two mma, so at 128
//     B of shared memory an SM a clock the reads take twice the tensor
//     cores' time. 32-query steps in dk/dv, or K and V read from shared
//     memory there, were slower.
//
// Forward and backward in f32: simple and right first. No tensor cores:
// tiles are staged in shared memory as f32 by plain loads and every
// product runs on the CUDA cores in f32 (67 TFLOP/s on the H100 SXM, so
// these kernels sit far above the bound; tensor cores would take f32
// only as TF32, and the f32 checks need 1e-4).
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
//   * Backward, two launches and no atomics:
//       dq:   one block per (q tile, q head, batch); first D = rowsum(
//             dO * O) for its rows (also written to scratch for dkdv),
//             then over the live k tiles P = exp(s - lse),
//             dS = P * (dP - D) [* (1 - tanh^2) with softcap],
//             dQ += scale * dS K.
//       dk/dv: one block per (k tile, kv head, batch), looping over the
//             group's nq/nkv query heads and the live q tiles:
//             dV += P^T dO, dK += scale * dS^T Q.
//
// Shared memory per block (dynamic), hd = 64 / 128: forward 68 / 118 KB
// in f32 and 45 / 85 KB in bf16; dq 86 / 154 KB in f32 and 54 / 102 KB in
// bf16; dk/dv 103 / 171 KB in f32 and 92 / 103 KB in bf16.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

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

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

// A (q tile of bq rows, k tile) pair holds a live score unless the causal
// or the window test rules the whole tile out (flash_attention.py:50-54).
__device__ __forceinline__ bool tile_live(const FlashArgs& a, int q0, int k0,
                                          int bq = kTile) {
  if (a.causal && k0 > q0 + bq - 1) return false;
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

// --------------------------------------- forward, bf16 on tensor cores
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory tiles of 64 rows of HD bf16, rows padded by 16 B: Q, then
// kFwdStages stages of K and V (3 stages measured no faster than 2).
constexpr int kFwdStages = 2;
template <int HD>
__host__ __device__ constexpr int ld_mma() { return HD + 8; }
template <int HD>
constexpr int fwd_mma_smem() {
  return (1 + 2 * kFwdStages) * kTile * ld_mma<HD>() * 2;
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, or 16 zero bytes if !ok.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool ok) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d (16x8 f32) += a (16x16 bf16, row-major) b (16x8 bf16, column-major)
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x on the SFU; 2^-1e30 = 0.
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// Every (query, key) pair of a live (q tile, k tile) holds a valid score
// for the tile's query rows that exist: no mask is needed.
__device__ __forceinline__ bool tile_full(const FlashArgs& a, int q0, int k0,
                                          int bq = kTile) {
  if (k0 + kTile > a.T) return false;
  if (a.causal && k0 + kTile - 1 > q0) return false;
  if (a.window > 0 && k0 <= q0 + bq - 1 - a.window) return false;
  return true;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// 4 bytes from global to shared memory, or 4 zero bytes if !ok.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool ok) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(ok ? 4 : 0) : "memory");
}

// The A fragment of rows 16 * w .. 16 * w + 15, columns 16 * kk ..
// 16 * kk + 15 of a bf16 tile in shared memory, by ldmatrix.
template <int LD>
__device__ __forceinline__ uint32_t a_frag_addr(uint32_t tile, int w,
                                                int kk, int lane) {
  return tile + ((w * 16 + lane % 16) * LD + 16 * kk + (lane / 16) * 8) * 2;
}
// The B fragments of n8 blocks 2 * jp and 2 * jp + 1 (rows 16 * jp ..) and
// columns 16 * kk .. 16 * kk + 15 of a row-major [n][k] tile (B = tile^T).
template <int LD>
__device__ __forceinline__ uint32_t b_frag_addr(uint32_t tile, int jp,
                                                int kk, int lane) {
  return tile + ((16 * jp + lane % 8 + (lane / 16) * 8) * LD + 16 * kk +
                 ((lane / 8) % 2) * 8) * 2;
}
// The B fragments, by ldmatrix.trans, of rows 16 * t .. 16 * t + 15 (the
// k dim) and n8 blocks 2 * dp, 2 * dp + 1 of a row-major [k][n] tile.
template <int LD>
__device__ __forceinline__ uint32_t bt_frag_addr(uint32_t tile, int t,
                                                 int dp, int lane) {
  return tile + ((16 * t + lane % 8 + ((lane / 8) % 2) * 8) * LD + 16 * dp +
                 (lane / 16) * 8) * 2;
}

// The A fragment of k16 step t (n8 blocks 2t and 2t + 1) of a 16-row f32
// accumulator tile, rounded to bf16: S's fragment becomes P V's A.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4],
                                       const float (&s)[N][4], int t) {
  a[0] = pack_bf16(s[2 * t][0], s[2 * t][1]);
  a[1] = pack_bf16(s[2 * t][2], s[2 * t][3]);
  a[2] = pack_bf16(s[2 * t + 1][0], s[2 * t + 1][1]);
  a[3] = pack_bf16(s[2 * t + 1][2], s[2 * t + 1][3]);
}

// The first ROWS rows of a [len, HD] bf16 slab with row stride `rs`
// (elements) into shared memory at `dst` by cp.async, shared among the
// `nthr` threads numbered `tid`; rows past `len` are zeros.
template <int HD, int ROWS = kTile>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                long long rs, int len,
                                                int tid = threadIdx.x,
                                                int nthr = kThreads) {
  constexpr int kChunks = HD / 8;                 // 16-byte chunks a row
  for (int i = tid; i < ROWS * kChunks; i += nthr) {
    const int r = i / kChunks, c = i % kChunks;
    const bool ok = r < len;
    cp_async16(dst + (r * ld_mma<HD>() + c * 8) * 2,
               src + (ok ? r * rs + c * 8 : 0), ok);
  }
}

// Reductions over the 4 threads of a quad, which share an mma row.
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// How a tile's scores are formed: kPlain, every pair valid and no
// softcap; kMasked, pairs tested against the masks, no softcap; kSoftcap,
// pairs tested and scores softcapped.
enum SoftmaxMode { kPlain, kMasked, kSoftcap };

// One tile's online-softmax step, in base 2, for this thread's two rows
// (qrow[i]): fragment element (j, 2i + c) of S is row qrow[i], key
// k0 + 8j + 2 * (lane % 4) + c. Rescales o and l by the change of the
// running max m, and leaves p in s; masked p are 0. Without softcap, m is
// taken over the raw dots and p = 2^(dot * scale * log2e - m) is one FFMA
// and one ex2.
template <SoftmaxMode kMode, int NS, int NO>
__device__ __forceinline__ void softmax_step(const FlashArgs& a,
                                             float (&s)[NS][4],
                                             float (&o)[NO][4], float (&m)[2],
                                             float (&l)[2],
                                             const int (&qrow)[2], int k0,
                                             int lane, float scale_log2) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    uint32_t ok = 0;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[j][2 * i + c];
        if (kMode != kPlain) {
          const bool valid =
              score_valid(a, qrow[i], k0 + 8 * j + 2 * (lane % 4) + c);
          ok |= static_cast<uint32_t>(valid) << (2 * j + c);
          float t;
          if (kMode == kSoftcap)
            x = valid ? score(a, x, &t) * kLog2e : kNegInf;
          else
            x = valid ? x : kNegInf;
        }
        mx = fmaxf(mx, x);
      }
    if (kMode != kSoftcap) mx *= scale_log2;   // raw dots; -1e30 stays low
    const float m_new = fmaxf(m[i], quad_max(mx));
    const float alpha = ex2(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        float& x = s[j][2 * i + c];
        const float p = kMode == kSoftcap ? ex2(x - m_new)
                                          : ex2(fmaf(x, scale_log2, -m_new));
        x = kMode == kPlain || (ok >> (2 * j + c)) & 1u ? p : 0.f;
        sum += x;
      }
    l[i] = l[i] * alpha + sum;             // this thread's part of the row
    m[i] = m_new;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      o[j][2 * i] *= alpha;
      o[j][2 * i + 1] *= alpha;
    }
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads)
flash_fwd_mma_kernel(const FlashArgs a) {
  constexpr int LD = ld_mma<HD>();
  constexpr int kTileBytes = kTile * LD * 2;
  constexpr int KS = HD / 16;              // k16 steps of Q K^T
  constexpr int NO = HD / 8;               // n8 blocks of the output
  constexpr int NS = kTile / 8;            // n8 blocks of S
  constexpr int ST = kFwdStages;
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const uint32_t sq = smem_u32(smem_mma);
  auto sk = [&](int st) { return sq + (1 + 2 * st) * kTileBytes; };
  auto sv = [&](int st) { return sq + (2 + 2 * st) * kTileBytes; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_qt = (a.S + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - blockIdx.x) * kTile;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.nq / a.nkv);
  const auto* qp = static_cast<const __nv_bfloat16*>(a.q) + b * a.q_sb +
                   h * a.q_sh;
  const auto* kp = static_cast<const __nv_bfloat16*>(a.k) + b * a.k_sb +
                   hk * a.k_sh;
  const auto* vp = static_cast<const __nv_bfloat16*>(a.v) + b * a.v_sb +
                   hk * a.v_sh;
  const int n_kt = (a.T + kTile - 1) / kTile;
  const float scale_log2 = a.scale * kLog2e;
  auto next_live = [&](int kt) {
    do ++kt; while (kt < n_kt && !tile_live(a, q0, kt * kTile));
    return kt;
  };
  auto load_kv = [&](int st, int kt) {
    const int k0 = kt * kTile;
    load_tile_async<HD>(sk(st), kp + static_cast<long long>(k0) * a.k_ss,
                        a.k_ss, a.T - k0);
    load_tile_async<HD>(sv(st), vp + static_cast<long long>(k0) * a.v_ss,
                        a.v_ss, a.T - k0);
  };

  // Q, then the first ST - 1 live K/V tiles, one cp.async group each.
  load_tile_async<HD>(sq, qp + static_cast<long long>(q0) * a.q_ss, a.q_ss,
                      a.S - q0);
  int kt = next_live(-1), kt_load = kt;
#pragma unroll
  for (int st = 0; st < ST - 1; ++st) {
    if (kt_load < n_kt) {
      load_kv(st, kt_load);
      kt_load = next_live(kt_load);
    }
    cp_async_commit();
  }

  // This thread's rows of the warp's 16: lane / 4 and lane / 4 + 8.
  const int qrow[2] = {q0 + warp * 16 + lane / 4,
                       q0 + warp * 16 + lane / 4 + 8};
  uint32_t qf[KS][4];
  float o[NO][4], m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[j][c] = 0.f;

  for (int st = 0, first = 1; kt < n_kt; first = 0) {
    // load ST - 1 tiles ahead, into the stage the last iteration freed
    if (kt_load < n_kt) {
      load_kv(st == 0 ? ST - 1 : st - 1, kt_load);
      kt_load = next_live(kt_load);
    }
    cp_async_commit();
    cp_async_wait<ST - 1>();               // Q and this tile have landed
    __syncthreads();
    if (first) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldmatrix_x4(qf[kk], a_frag_addr<LD>(sq, warp, kk, lane));
    }

    // S = Q K^T for the warp's 16 rows and the tile's 64 keys.
    float s[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk)
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t kb[4];
        ldmatrix_x4(kb, b_frag_addr<LD>(sk(st), jp, kk, lane));
        mma_bf16(s[2 * jp], qf[kk], kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qf[kk], kb[2], kb[3]);
      }

    // Online softmax over the tile. The three modes are separate
    // instantiations, chosen once per tile, so none carries another's
    // branches: on the causal path only the diagonal tile is masked.
    const int k0 = kt * kTile;
    if (a.softcap > 0.f)
      softmax_step<kSoftcap>(a, s, o, m, l, qrow, k0, lane, scale_log2);
    else if (tile_full(a, q0, k0))
      softmax_step<kPlain>(a, s, o, m, l, qrow, k0, lane, scale_log2);
    else
      softmax_step<kMasked>(a, s, o, m, l, qrow, k0, lane, scale_log2);

    // O += P V: P's A fragment for keys 16t .. 16t + 15 is S's n8 blocks
    // 2t and 2t + 1, rounded to bf16.
#pragma unroll
    for (int t = 0; t < kTile / 16; ++t) {
      uint32_t pa[4];
      pack_a(pa, s, t);
#pragma unroll
      for (int dp = 0; dp < NO / 2; ++dp) {
        uint32_t vb[4];
        ldmatrix_x4_trans(vb, bt_frag_addr<LD>(sv(st), t, dp, lane));
        mma_bf16(o[2 * dp], pa, vb[0], vb[1]);
        mma_bf16(o[2 * dp + 1], pa, vb[2], vb[3]);
      }
    }
    __syncthreads();                       // done with stage st
    kt = next_live(kt);
    st = st == ST - 1 ? 0 : st + 1;
  }
  cp_async_wait<0>();

  auto* op = static_cast<__nv_bfloat16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const float l_row = quad_sum(l[i]);
    if (qrow[i] >= a.S) continue;
    const float inv = 1.f / fmaxf(l_row, 1e-30f);
    __nv_bfloat16* row =
        op + ((static_cast<long long>(b) * a.S + qrow[i]) * a.nq + h) * HD;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(o[j][2 * i] * inv, o[j][2 * i + 1] * inv);
    if (lane % 4 == 0)
      a.lse[(static_cast<long long>(b) * a.nq + h) * a.S + qrow[i]] =
          (m[i] + log2f(l_row)) * kLn2;
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

// -------------------------------------- backward, bf16 on tensor cores
// Shared by the two kernels below: for one tile, P and dS in f32, in
// place. On entry s holds the raw dots and dp holds dP; on exit s holds P
// (masked P are 0) and dp holds dS = P (dP - D) [* (1 - tanh^2) under
// softcap]. Fragment element (j, 2i + c) has row row[i] and column
// col0 + 8j + 2 * (lane % 4) + c; kT: rows are keys and columns queries
// (the dk/dv kernel), else rows are queries. stats(j, i, c) gives the
// element's query's (lse * log2e, D). P = 2^(dot * scale * log2e - lse *
// log2e) is one FFMA and one ex2 without softcap.
template <SoftmaxMode kMode, bool kT, int NS, class Stats>
__device__ __forceinline__ void p_ds_tile(const FlashArgs& a,
                                          float (&s)[NS][4],
                                          float (&dp)[NS][4],
                                          const int (&row)[2], int col0,
                                          int lane, float scale_log2,
                                          Stats stats) {
#pragma unroll
  for (int j = 0; j < NS; ++j)
#pragma unroll
    for (int i = 0; i < 2; ++i)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int e = 2 * i + c, col = col0 + 8 * j + 2 * (lane % 4) + c;
        const float2 st = stats(j, i, c);
        float p, dcap = 1.f;
        if constexpr (kMode == kSoftcap) {
          float t;
          const float x = score(a, s[j][e], &t);
          dcap = 1.f - t * t;
          p = ex2(fmaf(x, kLog2e, -st.x));
        } else {
          p = ex2(fmaf(s[j][e], scale_log2, -st.x));
        }
        if (kMode != kPlain && !(kT ? score_valid(a, col, row[i])
                                    : score_valid(a, row[i], col)))
          p = 0.f;
        s[j][e] = p;
        dp[j][e] = p * (dp[j][e] - st.y) * dcap;
      }
}

// Q and dO, then 2 stages of K and V: 64-row bf16 tiles, rows padded.
template <int HD>
constexpr int dq_mma_smem() { return 6 * kTile * ld_mma<HD>() * 2; }

// dq on the tensor cores; also writes D = rowsum(dO * O) for the dk/dv
// kernel. One block per (64-row q tile, q head, batch), 4 warps of 16
// query rows, the live K/V tiles streamed through two cp.async stages.
// Q and dO fragments are read from shared memory at each use, which
// leaves room for 3 blocks an SM at hd <= 64 without spilling.
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 3 : 1)
flash_bwd_dq_mma_kernel(const FlashArgs a) {
  constexpr int LD = ld_mma<HD>();
  constexpr int kTileBytes = kTile * LD * 2;
  constexpr int KS = HD / 16;              // k16 steps of Q K^T and dO V^T
  constexpr int NO = HD / 8;               // n8 blocks of dQ
  constexpr int NS = kTile / 8;            // n8 blocks of S and dP
  extern __shared__ __align__(16) unsigned char smem_mma[];
  __shared__ float d_s[kTile];
  const uint32_t sq = smem_u32(smem_mma), sdo = sq + kTileBytes;
  auto sk = [&](int st) { return sq + (2 + 2 * st) * kTileBytes; };
  auto sv = [&](int st) { return sq + (3 + 2 * st) * kTileBytes; };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int n_qt = (a.S + kTile - 1) / kTile;
  const int q0 = (n_qt - 1 - blockIdx.x) * kTile;   // longest rows first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (a.nq / a.nkv);
  using bf16 = __nv_bfloat16;
  const auto* qp = static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh;
  const auto* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const auto* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const auto* op = static_cast<const bf16*>(a.o) + b * a.o_sb + h * a.o_sh;
  const auto* dop = static_cast<const bf16*>(a.dout) + b * a.do_sb +
                    h * a.do_sh;
  const long long rowbase = (static_cast<long long>(b) * a.nq + h) * a.S;
  const int n_kt = (a.T + kTile - 1) / kTile;
  const float scale_log2 = a.scale * kLog2e;
  auto next_live = [&](int kt) {
    do ++kt; while (kt < n_kt && !tile_live(a, q0, kt * kTile));
    return kt;
  };
  auto load_kv = [&](int st, int kt) {
    const int k0 = kt * kTile;
    load_tile_async<HD>(sk(st), kp + static_cast<long long>(k0) * a.k_ss,
                        a.k_ss, a.T - k0);
    load_tile_async<HD>(sv(st), vp + static_cast<long long>(k0) * a.v_ss,
                        a.v_ss, a.T - k0);
  };

  // Q, dO and the first live K/V tile: one cp.async group.
  load_tile_async<HD>(sq, qp + static_cast<long long>(q0) * a.q_ss, a.q_ss,
                      a.S - q0);
  load_tile_async<HD>(sdo, dop + static_cast<long long>(q0) * a.do_ss,
                      a.do_ss, a.S - q0);
  int kt = next_live(-1);
  if (kt < n_kt) load_kv(0, kt);
  cp_async_commit();

  {  // D of the tile's rows from the bf16 O and dO: two threads a row
    const int r = threadIdx.x / 2, half = threadIdx.x % 2;
    const int qpos = q0 + r;
    float part = 0.f;
    if (qpos < a.S) {
      const auto* orow = reinterpret_cast<const uint4*>(
          op + static_cast<long long>(qpos) * a.o_ss + half * (HD / 2));
      const auto* drow = reinterpret_cast<const uint4*>(
          dop + static_cast<long long>(qpos) * a.do_ss + half * (HD / 2));
#pragma unroll
      for (int c = 0; c < HD / 16; ++c) {   // 8 bf16 a 16-byte chunk
        const uint4 ov = orow[c], dv = drow[c];
        const auto* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const auto* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(o2[e]);
          const float2 df = __bfloat1622float2(d2[e]);
          part = fmaf(of.x, df.x, fmaf(of.y, df.y, part));
        }
      }
    }
    part += __shfl_xor_sync(0xffffffffu, part, 1);
    if (half == 0) {
      d_s[r] = part;
      if (qpos < a.S) a.dsum[rowbase + qpos] = part;
    }
  }
  __syncthreads();

  // This thread's rows of the warp's 16: lane / 4 and lane / 4 + 8. Rows
  // past S read Q = dO = 0 and lse = D = 0, so their dS is 0.
  const int qrow[2] = {q0 + warp * 16 + lane / 4,
                       q0 + warp * 16 + lane / 4 + 8};
  float2 stat[2];                          // (lse * log2e, D) of each row
#pragma unroll
  for (int i = 0; i < 2; ++i)
    stat[i] = qrow[i] < a.S
                  ? make_float2(a.lse[rowbase + qrow[i]] * kLog2e,
                                d_s[qrow[i] - q0])
                  : make_float2(0.f, 0.f);
  auto stats = [&](int, int i, int) { return stat[i]; };

  float dq[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[j][c] = 0.f;

  for (int st = 0; kt < n_kt; st ^= 1) {
    const int kt_next = next_live(kt);
    if (kt_next < n_kt) load_kv(st ^ 1, kt_next);
    cp_async_commit();
    cp_async_wait<1>();                    // this stage has landed
    __syncthreads();

    // S = Q K^T and dP = dO V^T for the warp's 16 rows, the tile's 64 keys.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t qa[4], da[4];
      ldmatrix_x4(qa, a_frag_addr<LD>(sq, warp, kk, lane));
      ldmatrix_x4(da, a_frag_addr<LD>(sdo, warp, kk, lane));
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t kb[4], vb[4];
        ldmatrix_x4(kb, b_frag_addr<LD>(sk(st), jp, kk, lane));
        mma_bf16(s[2 * jp], qa, kb[0], kb[1]);
        mma_bf16(s[2 * jp + 1], qa, kb[2], kb[3]);
        ldmatrix_x4(vb, b_frag_addr<LD>(sv(st), jp, kk, lane));
        mma_bf16(dp[2 * jp], da, vb[0], vb[1]);
        mma_bf16(dp[2 * jp + 1], da, vb[2], vb[3]);
      }
    }

    const int k0 = kt * kTile;
    if (a.softcap > 0.f)
      p_ds_tile<kSoftcap, false>(a, s, dp, qrow, k0, lane, scale_log2, stats);
    else if (tile_full(a, q0, k0))
      p_ds_tile<kPlain, false>(a, s, dp, qrow, k0, lane, scale_log2, stats);
    else
      p_ds_tile<kMasked, false>(a, s, dp, qrow, k0, lane, scale_log2, stats);

    // dQ += dS K: dS's A fragment for keys 16t .. 16t + 15 is dP's n8
    // blocks 2t and 2t + 1, rounded to bf16; K through ldmatrix.trans.
#pragma unroll
    for (int t = 0; t < kTile / 16; ++t) {
      uint32_t da[4];
      pack_a(da, dp, t);
#pragma unroll
      for (int d2 = 0; d2 < NO / 2; ++d2) {
        uint32_t kb[4];
        ldmatrix_x4_trans(kb, bt_frag_addr<LD>(sk(st), t, d2, lane));
        mma_bf16(dq[2 * d2], da, kb[0], kb[1]);
        mma_bf16(dq[2 * d2 + 1], da, kb[2], kb[3]);
      }
    }
    __syncthreads();                       // done with stage st
    kt = kt_next;
  }
  cp_async_wait<0>();

  auto* dqp = static_cast<bf16*>(a.dq);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (qrow[i] >= a.S) continue;
    bf16* row =
        dqp + ((static_cast<long long>(b) * a.S + qrow[i]) * a.nq + h) * HD;
#pragma unroll
    for (int j = 0; j < NO; ++j)
      *reinterpret_cast<__nv_bfloat162*>(row + 8 * j + 2 * (lane % 4)) =
          __floats2bfloat162_rn(dq[j][2 * i] * a.scale,
                                dq[j][2 * i + 1] * a.scale);
  }
}

// dk/dv on the tensor cores: two warpgroups, each taking every other
// (query head of the group, live q tile) pair of the block's 64 keys, and
// summing their dK, dV through shared memory at the end, warpgroup 0
// plus warpgroup 1 (a fixed order: no atomics).
constexpr int kDkdvThreads = 256;
// Queries a step: 64, or 32 at hd 128, where dK and dV take 128
// registers a thread.
template <int HD>
__host__ __device__ constexpr int dkdv_bq() {
  return HD <= 64 ? kTile : kTile / 2;
}
// A warpgroup's stage: Q and dO tiles of BQ rows, then lse and D of BQ
// queries (f32).
template <int HD>
__host__ __device__ constexpr int dkdv_stage_bytes() {
  return 2 * dkdv_bq<HD>() * ld_mma<HD>() * 2 + 2 * dkdv_bq<HD>() * 4;
}
// K and V, then 2 stages for each warpgroup; the final sum reuses the
// front: 128 threads x (dK, dV) = HD floats each.
template <int HD>
constexpr int dkdv_mma_smem() {
  constexpr int loop =
      2 * kTile * ld_mma<HD>() * 2 + 4 * dkdv_stage_bytes<HD>();
  constexpr int sum = kThreads * HD * 4;
  return loop > sum ? loop : sum;
}

// A barrier of one warpgroup (named barrier 1 + wg, 128 threads).
__device__ __forceinline__ void wg_sync(int wg) {
  asm volatile("bar.sync %0, %1;" ::"r"(1 + wg), "n"(kThreads) : "memory");
}

template <int HD>
__global__ void __launch_bounds__(kDkdvThreads, 1)
flash_bwd_dkdv_mma_kernel(const FlashArgs a) {
  constexpr int LD = ld_mma<HD>();
  constexpr int BQ = dkdv_bq<HD>();
  constexpr int kTileBytes = kTile * LD * 2, kQBytes = BQ * LD * 2;
  constexpr int KS = HD / 16;              // k16 steps of K Q^T and V dO^T
  constexpr int NO = HD / 8;               // n8 blocks of dK and dV
  constexpr int NS = BQ / 8;               // n8 blocks of S^T and dP^T
  constexpr bool kRegs = HD <= 64;         // K, V fragments in registers
  extern __shared__ __align__(16) unsigned char smem_mma[];
  const uint32_t sk = smem_u32(smem_mma), sv = sk + kTileBytes;
  const int tid = threadIdx.x, wg = tid / kThreads, wtid = tid % kThreads;
  const int warp = wtid / 32, lane = tid % 32;
  auto stage_off = [&](int st) {
    return 2 * kTileBytes + (2 * wg + st) * dkdv_stage_bytes<HD>();
  };

  // Grid (kv head, batch, k tile): the k tiles with the most live q tiles
  // under the causal mask start first.
  const int hk = blockIdx.x, b = blockIdx.y, k0 = blockIdx.z * kTile;
  const int group = a.nq / a.nkv;
  using bf16 = __nv_bfloat16;
  const auto* kp = static_cast<const bf16*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const auto* vp = static_cast<const bf16*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const float scale_log2 = a.scale * kLog2e;

  // The live q tiles of this k tile are one range (the causal test keeps
  // tiles from some q0 on, the window's up to some q0).
  const int n_qt = (a.S + BQ - 1) / BQ;
  int qt_lo = 0;
  while (qt_lo < n_qt && !tile_live(a, qt_lo * BQ, k0, BQ)) ++qt_lo;
  int qt_hi = qt_lo;
  while (qt_hi < n_qt && tile_live(a, qt_hi * BQ, k0, BQ)) ++qt_hi;
  const int n_live = qt_hi - qt_lo, n_pairs = group * n_live;
  auto head_of = [&](int idx) { return hk * group + idx / n_live; };
  auto q0_of = [&](int idx) { return (qt_lo + idx % n_live) * BQ; };
  auto load_q = [&](int st, int idx) {     // Q, dO, lse and D of pair idx
    const int h = head_of(idx), q0 = q0_of(idx);
    const uint32_t base = sk + stage_off(st);
    load_tile_async<HD, BQ>(
        base, static_cast<const bf16*>(a.q) + b * a.q_sb + h * a.q_sh +
                  static_cast<long long>(q0) * a.q_ss,
        a.q_ss, a.S - q0, wtid, kThreads);
    load_tile_async<HD, BQ>(
        base + kQBytes, static_cast<const bf16*>(a.dout) + b * a.do_sb +
                            h * a.do_sh + static_cast<long long>(q0) * a.do_ss,
        a.do_ss, a.S - q0, wtid, kThreads);
    const long long row = (static_cast<long long>(b) * a.nq + h) * a.S + q0;
    for (int r = wtid; r < 2 * BQ; r += kThreads) {   // zeros past S
      const int qr = r % BQ;
      const bool ok = q0 + qr < a.S;
      cp_async4(base + 2 * kQBytes + r * 4,
                (r < BQ ? a.lse : a.dsum) + row + (ok ? qr : 0), ok);
    }
  };

  // K and V (all 256 threads) and each warpgroup's first pair.
  load_tile_async<HD>(sk, kp + static_cast<long long>(k0) * a.k_ss, a.k_ss,
                      a.T - k0, tid, kDkdvThreads);
  load_tile_async<HD>(sv, vp + static_cast<long long>(k0) * a.v_ss, a.v_ss,
                      a.T - k0, tid, kDkdvThreads);
  int idx = wg;
  if (idx < n_pairs) load_q(0, idx);
  cp_async_commit();
  cp_async_wait<0>();
  __syncthreads();

  uint32_t kf[kRegs ? KS : 1][4], vf[kRegs ? KS : 1][4];
  if constexpr (kRegs) {
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      ldmatrix_x4(kf[kk], a_frag_addr<LD>(sk, warp, kk, lane));
      ldmatrix_x4(vf[kk], a_frag_addr<LD>(sv, warp, kk, lane));
    }
  }
  // This thread's keys of the warp's 16: lane / 4 and lane / 4 + 8.
  const int krow[2] = {k0 + warp * 16 + lane / 4,
                       k0 + warp * 16 + lane / 4 + 8};
  float dk[NO][4], dv[NO][4];
#pragma unroll
  for (int j = 0; j < NO; ++j)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[j][c] = dv[j][c] = 0.f;

  for (int st = 0; idx < n_pairs; st ^= 1) {
    const int next = idx + 2;
    if (next < n_pairs) load_q(st ^ 1, next);
    cp_async_commit();
    cp_async_wait<1>();                    // this stage has landed
    wg_sync(wg);
    const uint32_t sq = sk + stage_off(st), sdo = sq + kQBytes;
    const float* lse_s =
        reinterpret_cast<const float*>(smem_mma + stage_off(st) + 2 * kQBytes);
    const float* d_s = lse_s + BQ;

    // S^T = K Q^T and dP^T = V dO^T: the warp's 16 keys, BQ queries.
    float s[NS][4], dp[NS][4];
#pragma unroll
    for (int j = 0; j < NS; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KS; ++kk) {
      uint32_t ka[4], va[4];
      if constexpr (kRegs) {
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          ka[c] = kf[kk][c];
          va[c] = vf[kk][c];
        }
      } else {
        ldmatrix_x4(ka, a_frag_addr<LD>(sk, warp, kk, lane));
        ldmatrix_x4(va, a_frag_addr<LD>(sv, warp, kk, lane));
      }
#pragma unroll
      for (int jp = 0; jp < NS / 2; ++jp) {
        uint32_t qb[4], db[4];
        ldmatrix_x4(qb, b_frag_addr<LD>(sq, jp, kk, lane));
        mma_bf16(s[2 * jp], ka, qb[0], qb[1]);
        mma_bf16(s[2 * jp + 1], ka, qb[2], qb[3]);
        ldmatrix_x4(db, b_frag_addr<LD>(sdo, jp, kk, lane));
        mma_bf16(dp[2 * jp], va, db[0], db[1]);
        mma_bf16(dp[2 * jp + 1], va, db[2], db[3]);
      }
    }

    const int q0 = q0_of(idx);
    auto stats = [&](int j, int, int c) {
      const int col = 8 * j + 2 * (lane % 4) + c;
      return make_float2(lse_s[col] * kLog2e, d_s[col]);
    };
    if (a.softcap > 0.f)
      p_ds_tile<kSoftcap, true>(a, s, dp, krow, q0, lane, scale_log2, stats);
    else if (tile_full(a, q0, k0, BQ))
      p_ds_tile<kPlain, true>(a, s, dp, krow, q0, lane, scale_log2, stats);
    else
      p_ds_tile<kMasked, true>(a, s, dp, krow, q0, lane, scale_log2, stats);

    // dV += P^T dO and dK += dS^T Q: the A fragments for queries 16t ..
    // 16t + 15 are n8 blocks 2t and 2t + 1 of P^T and dS^T, rounded to
    // bf16; dO and Q through ldmatrix.trans.
#pragma unroll
    for (int t = 0; t < BQ / 16; ++t) {
      uint32_t pa[4], da[4];
      pack_a(pa, s, t);
      pack_a(da, dp, t);
#pragma unroll
      for (int d2 = 0; d2 < NO / 2; ++d2) {
        uint32_t ob[4], qb[4];
        ldmatrix_x4_trans(ob, bt_frag_addr<LD>(sdo, t, d2, lane));
        mma_bf16(dv[2 * d2], pa, ob[0], ob[1]);
        mma_bf16(dv[2 * d2 + 1], pa, ob[2], ob[3]);
        ldmatrix_x4_trans(qb, bt_frag_addr<LD>(sq, t, d2, lane));
        mma_bf16(dk[2 * d2], da, qb[0], qb[1]);
        mma_bf16(dk[2 * d2 + 1], da, qb[2], qb[3]);
      }
    }
    wg_sync(wg);                           // done with stage st
    idx = next;
  }
  cp_async_wait<0>();

  // dK, dV = warpgroup 0's + warpgroup 1's, each thread's fragment through
  // its own column of shared memory (consecutive threads, consecutive
  // banks).
  __syncthreads();
  auto* sum = reinterpret_cast<float*>(smem_mma);
  if (wg == 1) {
#pragma unroll
    for (int j = 0; j < NO; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        sum[(4 * j + c) * kThreads + wtid] = dk[j][c];
        sum[(4 * (NO + j) + c) * kThreads + wtid] = dv[j][c];
      }
  }
  __syncthreads();
  if (wg == 1) return;
  auto* dkp = static_cast<bf16*>(a.dk);
  auto* dvp = static_cast<bf16*>(a.dv);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (krow[i] >= a.T) continue;
    const long long base =
        ((static_cast<long long>(b) * a.T + krow[i]) * a.nkv + hk) * HD;
#pragma unroll
    for (int j = 0; j < NO; ++j) {
      const int e0 = 2 * i, col = 8 * j + 2 * (lane % 4);
      const float k_lo = dk[j][e0] + sum[(4 * j + e0) * kThreads + wtid];
      const float k_hi =
          dk[j][e0 + 1] + sum[(4 * j + e0 + 1) * kThreads + wtid];
      const float v_lo =
          dv[j][e0] + sum[(4 * (NO + j) + e0) * kThreads + wtid];
      const float v_hi =
          dv[j][e0 + 1] + sum[(4 * (NO + j) + e0 + 1) * kThreads + wtid];
      *reinterpret_cast<__nv_bfloat162*>(dkp + base + col) =
          __floats2bfloat162_rn(k_lo * a.scale, k_hi * a.scale);
      *reinterpret_cast<__nv_bfloat162*>(dvp + base + col) =
          __floats2bfloat162_rn(v_lo, v_hi);
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
           void* stream, int threads = kThreads) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, threads, smem, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// bf16 takes the tensor-core kernel, f32 the CUDA-core one.
template <typename T, int HD>
int fwd(const FlashArgs& a, void* stream) {
  const dim3 grid((a.S + kTile - 1) / kTile, a.nq, a.B);
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return launch(flash_fwd_mma_kernel<HD>, grid, fwd_mma_smem<HD>(), a,
                  stream);
  else
    return launch(flash_fwd_kernel<float, HD>, grid, fwd_smem<HD>(), a,
                  stream);
}

// The backward likewise: bf16 on the tensor cores, f32 on the CUDA cores.
template <typename T, int HD>
int bwd_dq(const FlashArgs& a, void* stream) {
  const dim3 grid((a.S + kTile - 1) / kTile, a.nq, a.B);
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return launch(flash_bwd_dq_mma_kernel<HD>, grid, dq_mma_smem<HD>(), a,
                  stream);
  else
    return launch(flash_bwd_dq_kernel<float, HD>, grid, dq_smem<HD>(), a,
                  stream);
}

template <typename T, int HD>
int bwd_dkdv(const FlashArgs& a, void* stream) {
  const int n_kt = (a.T + kTile - 1) / kTile;
  if constexpr (std::is_same_v<T, __nv_bfloat16>)
    return launch(flash_bwd_dkdv_mma_kernel<HD>, dim3(a.nkv, a.B, n_kt),
                  dkdv_mma_smem<HD>(), a, stream, kDkdvThreads);
  else
    return launch(flash_bwd_dkdv_kernel<float, HD>, dim3(n_kt, a.nkv, a.B),
                  dkdv_smem<HD>(), a, stream);
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

// Dynamic shared memory of a launch: which = 0 forward, 1 dq, 2 dk/dv;
// bf16 = 1 for the bf16 (tensor-core) kernels, 0 for the f32 ones.
template <int HD>
int smem_bytes(int which, int bf16) {
  if (which == 0) return bf16 ? fwd_mma_smem<HD>() : fwd_smem<HD>();
  if (which == 1) return bf16 ? dq_mma_smem<HD>() : dq_smem<HD>();
  return bf16 ? dkdv_mma_smem<HD>() : dkdv_smem<HD>();
}

extern "C" int flash_attention_smem_bytes(int which, int hd, int bf16) {
  switch (hd) {
    case 16: return smem_bytes<16>(which, bf16);
    case 64: return smem_bytes<64>(which, bf16);
    case 128: return smem_bytes<128>(which, bf16);
  }
  return kBadHeadDim;
}

extern "C" const char* flash_attention_error_string(int code) {
  if (code == kBadHeadDim) return "head dim has no kernel (16, 64, 128)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
