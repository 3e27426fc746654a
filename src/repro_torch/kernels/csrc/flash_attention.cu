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
// Forward and backward in f32, on the CUDA cores: tensor cores take f32
// only as TF32, too coarse for the f32 checks (1e-4). Bound: at the path
// shape the products are 30.1 GFLOP (forward) and 75.2 (the backward's
// five; 105.3 for the seven that its kernels compute), 0.449, 1.122 and
// 1.571 ms at the H100 SXM's 67 f32 TFLOP/s, about 50 flops a byte: the
// FMA pipes' issue rate bounds them, so every other instruction in the
// main loops (shared-memory reads, the softmax, barriers) costs time.
//   * Blocks of 4 warps. A thread owns TM rows (8 in the forward at hd <=
//     64, else 4), 4 columns of each 32-wide streamed tile (cl + 8 j) and
//     hd / 8 output columns, so a product step is float4 shared-memory
//     reads of both operands (a float4 of 4 rows of the resident operand,
//     a float4 of 4 dims of a streamed row) for 4 TM or 8 TM FMAs; each
//     sum is one fmaf chain in a fixed order.
//   * The resident operand (Q, and dO in dq; K and V in dk/dv) is
//     transposed once into shared memory, through registers. The streamed
//     tiles (K and V in the forward and dq, Q, dO, lse and D in dk/dv)
//     arrive by 16-byte cp.async through a ring of two stages, rows past
//     S or T zero-filled: the next live tile's copy is in flight during
//     this tile's products. Dead tiles are not copied. Rows are padded to
//     16n + 4 words, so a warp's reads of 8 rows fall in 8 bank groups.
//   * P and dS go to the next product through a per-warp exchange tile
//     (a thread's float4 of 4 rows a column), behind __syncwarp: a warp
//     reads only what it wrote.
//   * Each warp skips the tiles with no live pair for its rows and picks
//     each tile's softmax as the bf16 kernels do: plain (one FFMA and one
//     ex2 an element), masked or softcapped. Plain and masked give a
//     valid element the same bits, a masked p is exactly 0 and a fully
//     masked tile rescales by exactly 1: a row's o and lse do not depend
//     on S or B. lse stays in base e, the denominator is clamped at
//     1e-30 and o is rounded once.
//   * Forward: one block per (q head, batch, q tile of 128 rows; 64 at hd
//     128), the longest rows first.
//   * Backward, three launches and no atomics (the same bits every call):
//     dq, one block per (q head, batch, 64-row q tile), longest first,
//     also writing D = rowsum(dO * O); dk/dv, one block per (q head,
//     batch, 64-key k tile), the k tiles with the most live queries
//     first, each writing its head's dK (unscaled) and dV to partials [B,
//     T, nq, hd]; then flash_bwd_dkdv_sum_f32_kernel sums each group's
//     partials in the order g = 0, 1, ... One block a kv head walking its
//     group's heads (tried once and slower, PERF.md) keeps the causal
//     mask's imbalance: the block at k0 = 0 walks 7 x 64 query tiles at
//     the path shape, the last 7 x 2.
//   * Measured on an H100 80GB HBM3 at 700 W (PERF.md): at the path
//     shape the forward takes 0.8125 ms (was 2.7060; SDPA 4.6555) and the
//     backward 2.9839 (was 8.7047; SDPA's 5.0319): dq 1.2878, dk/dv
//     1.6747, the sum 0.0285, 52-55% of their products' bound. What is
//     left is the FMA pipes' issue: 8 to 12 warps an SM (two forward
//     blocks, three of dq or dk/dv) hide the loops' shared-memory and
//     barrier latency only in part; 4 rows a thread in the forward (three
//     blocks an SM) was slower, and so was the other dk/dv grid.
//
// Shared memory per block (dynamic), hd = 64 / 128: forward 84 / 106 KB
// in f32 and 45 / 85 KB in bf16; dq 74 / 138 KB in f32 and 54 / 102 KB in
// bf16; dk/dv 74.5 / 138.5 KB in f32 and 92 / 103 KB in bf16.

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
  float* dk_part;       // f32 backward: [B,T,nq,hd] scratch, each query
  float* dv_part;       // head's dK (unscaled) and dV, summed by group
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
constexpr float kNegInf = -1e30f;  // the masked score, as in the TPU kernel

// A (q tile of bq rows, k tile of bk keys) pair holds a live score unless
// the causal or the window test rules the whole tile out
// (flash_attention.py:50-54).
__device__ __forceinline__ bool tile_live(const FlashArgs& a, int q0, int k0,
                                          int bq = kTile, int bk = kTile) {
  if (a.causal && k0 > q0 + bq - 1) return false;
  if (a.window > 0 && k0 + bk - 1 <= q0 - a.window) return false;
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
                                          int bq = kTile, int bk = kTile) {
  if (k0 + bk > a.T) return false;
  if (a.causal && k0 + bk - 1 > q0) return false;
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

// ---------------------------------------------- f32 on the CUDA cores
// The f32 kernels (design and bound in the note at the head of the file).
// Each block is 4 warps; a warp's lane is (rl, cl) = (lane / 8, lane % 8).
// A thread owns TM rows of its warp's 4 TM, rows 4 rl + (i % 4) + 16 (i /
// 4) (the keys in dk/dv); the streamed tile's columns cl + 8 j, j < 4 (keys,
// or queries in dk/dv); and output columns 4 cl + 32 g + e (2 cl + e at
// hd 16). Row reductions are shuffles over the 8 lanes of a row lane.
constexpr int kF32Stream = 32;   // keys (queries in dk/dv) a streamed tile

template <int HD, int TM>
struct F32Tile {
  static constexpr int kTM = TM;
  static constexpr int kWR = 4 * TM;                 // rows a warp
  static constexpr int kRows = 4 * kWR;              // rows a block
  static constexpr int kTO = HD / 8;                 // output columns a thread
  static constexpr int kLd = HD + 4;                 // streamed rows: 16n + 4
  // each warp's exchange tile of P^T or dS^T, [kF32Stream][kLdx]: padded
  // where a thread's float4 stores would otherwise share banks
  static constexpr int kLdx = kWR == 16 ? 16 : kWR + 4;
  static constexpr int kNat = kF32Stream * kLd;      // one streamed tile
  static constexpr int kX = 4 * kF32Stream * kLdx;   // the 4 exchange tiles
};
template <int HD>
using FwdTile = F32Tile<HD, (HD <= 64 ? 8 : 4)>;   // 128 rows (64 at hd 128)
template <int HD>
using BwdTile = F32Tile<HD, 4>;                     // 64 rows or keys

// Dynamic shared memory: the resident operands transposed, a ring of two
// streamed stages, the exchange tiles.
template <int HD>
constexpr int fwd_f32_smem() {   // Q^T; K, V
  using L = FwdTile<HD>;
  return (HD * L::kRows + 2 * 2 * L::kNat + L::kX) * 4;
}
template <int HD>
constexpr int dq_f32_smem() {    // Q^T, dO^T; K, V
  using L = BwdTile<HD>;
  return (2 * HD * L::kRows + 2 * 2 * L::kNat + L::kX) * 4;
}
template <int HD>  // Q, dO, lse and D of kF32Stream queries
__host__ __device__ constexpr int dkdv_f32_stage() {
  return 2 * BwdTile<HD>::kNat + 2 * kF32Stream;
}
template <int HD>
constexpr int dkdv_f32_smem() {  // K^T, V^T; Q, dO, lse, D; P, then dS
  using L = BwdTile<HD>;
  return (2 * HD * L::kRows + 2 * dkdv_f32_stage<HD>() + L::kX) * 4;
}
static_assert(fwd_f32_smem<64>() == 86016 && dq_f32_smem<64>() == 75776 &&
                  dkdv_f32_smem<64>() == 76288,
              "two forward, three dq and three dk/dv blocks an SM at hd 64");

__device__ __forceinline__ float elem(const float4& v, int e) {
  return e == 0 ? v.x : e == 1 ? v.y : e == 2 ? v.z : v.w;
}

// Rows 0 .. R-1 of a [len][HD] slab (row stride rs) into dst[d * R + r],
// transposed through registers, a float4 a thread at a time (consecutive
// threads take consecutive rows: their stores fall in consecutive banks);
// zeros past len. Once a block, for the operands it keeps.
template <int HD, int R>
__device__ __forceinline__ void load_t(float* dst, const float* src,
                                       long long rs, int len) {
  static_assert(R * HD / 4 % kThreads == 0, "whole rounds");
#pragma unroll 4
  for (int n = 0; n < R * HD / 4 / kThreads; ++n) {
    const int i = n * kThreads + threadIdx.x;
    const int r = i % R, c = i / R;
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (r < len)
      v = __ldg(reinterpret_cast<const float4*>(src + r * rs + 4 * c));
    dst[(4 * c) * R + r] = v.x;
    dst[(4 * c + 1) * R + r] = v.y;
    dst[(4 * c + 2) * R + r] = v.z;
    dst[(4 * c + 3) * R + r] = v.w;
  }
}

// Rows 0 .. kF32Stream-1 of a [len][HD] slab into dst[r * (HD + 4) + d] by
// 16-byte cp.async; rows past len are zero-filled and read nothing.
template <int HD>
__device__ __forceinline__ void load_stream(float* dst, const float* src,
                                            long long rs, int len) {
  constexpr int kV = HD / 4;
  static_assert(kF32Stream * kV % kThreads == 0, "whole rounds");
#pragma unroll
  for (int n = 0; n < kF32Stream * kV / kThreads; ++n) {
    const int i = n * kThreads + threadIdx.x;
    const int r = i / kV, c = i % kV;
    const bool ok = r < len;
    cp_async16(smem_u32(dst + r * (HD + 4) + 4 * c),
               src + (ok ? r * rs + 4 * c : 0), ok);
  }
}

// acc[i][j] += sum over d < HD of at[d * R + row i] * st[(cl + 8 j) * (HD +
// 4) + d]: the resident operand transposed (at: this thread's rows), the
// streamed one as it lies, read as float4 along d. Each sum is one fmaf
// chain over ascending d.
template <int HD, int TM, int R>
__device__ __forceinline__ void dot_rows(float (&acc)[TM][4], const float* at,
                                         const float* st, int cl) {
#pragma unroll 4
  for (int d = 0; d < HD; d += 4) {
    float4 b[4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
      b[j] = *reinterpret_cast<const float4*>(st + (cl + 8 * j) * (HD + 4) +
                                              d);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      float av[TM];
#pragma unroll
      for (int g = 0; g < TM / 4; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(at + (d + e) * R + 16 * g);
        av[4 * g] = v.x, av[4 * g + 1] = v.y;
        av[4 * g + 2] = v.z, av[4 * g + 3] = v.w;
      }
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          acc[i][j] = fmaf(av[i], elem(b[j], e), acc[i][j]);
    }
  }
}

// acc[i][c] += sum over k < kF32Stream of x[k * LDX + row i] * st[k * (HD +
// 4) + column c]: an exchange tile (x: this thread's rows) times a streamed
// tile (st: this thread's columns). One fmaf chain over ascending k a tile.
template <int HD, int TM, int LDX>
__device__ __forceinline__ void acc_cols(float (&acc)[TM][HD / 8],
                                         const float* x, const float* st) {
#pragma unroll 8
  for (int k = 0; k < kF32Stream; ++k) {
    float pv[TM], bv[HD / 8];
#pragma unroll
    for (int g = 0; g < TM / 4; ++g) {
      const float4 v = *reinterpret_cast<const float4*>(x + k * LDX + 16 * g);
      pv[4 * g] = v.x, pv[4 * g + 1] = v.y;
      pv[4 * g + 2] = v.z, pv[4 * g + 3] = v.w;
    }
    if constexpr (HD >= 32) {
#pragma unroll
      for (int g = 0; g < HD / 32; ++g) {
        const float4 v =
            *reinterpret_cast<const float4*>(st + k * (HD + 4) + 32 * g);
        bv[4 * g] = v.x, bv[4 * g + 1] = v.y;
        bv[4 * g + 2] = v.z, bv[4 * g + 3] = v.w;
      }
    } else {
      const float2 v = *reinterpret_cast<const float2*>(st + k * (HD + 4));
      bv[0] = v.x, bv[1] = v.y;
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        acc[i][c] = fmaf(pv[i], bv[c], acc[i][c]);
  }
}

// x[(cl + 8 j) * LDX + row i] = v[i][j]: a thread's tile, transposed, into
// its warp's exchange tile (x: this thread's rows).
template <int TM, int LDX>
__device__ __forceinline__ void put_t(float* x, const float (&v)[TM][4],
                                      int cl) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int g = 0; g < TM / 4; ++g)
      *reinterpret_cast<float4*>(x + (cl + 8 * j) * LDX + 16 * g) =
          make_float4(v[4 * g][j], v[4 * g + 1][j], v[4 * g + 2][j],
                      v[4 * g + 3][j]);
}

// The offset of a thread's first output column, and its columns' store.
template <int HD>
__device__ __forceinline__ int col0(int cl) {
  return HD >= 32 ? 4 * cl : 2 * cl;
}
template <int HD>
__device__ __forceinline__ void store_cols(float* dst, const float (&v)[HD / 8],
                                           float f) {
  if constexpr (HD >= 32) {
#pragma unroll
    for (int g = 0; g < HD / 32; ++g)
      *reinterpret_cast<float4*>(dst + 32 * g) =
          make_float4(v[4 * g] * f, v[4 * g + 1] * f, v[4 * g + 2] * f,
                      v[4 * g + 3] * f);
  } else {
    *reinterpret_cast<float2*>(dst) = make_float2(v[0] * f, v[1] * f);
  }
}

__device__ __forceinline__ int row_of(int i) { return (i & 3) + 16 * (i >> 2); }

__device__ __forceinline__ float row8_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 4));
}
__device__ __forceinline__ float row8_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  x += __shfl_xor_sync(0xffffffffu, x, 2);
  return x + __shfl_xor_sync(0xffffffffu, x, 4);
}

// One tile's online-softmax step, in base 2, for a thread's TM rows
// (row0 + row_of(i)) and keys k0 + 8 j: as softmax_step of the bf16
// forward. Rescales o and l by the change of the running max and leaves p
// in s; masked p are 0. Plain and masked tiles give a valid element the
// same bits, so a row's result does not depend on which of its tiles needed
// the mask, and a fully masked element adds exactly 0 with a factor of 1.
template <SoftmaxMode kMode, int TM, int TO>
__device__ __forceinline__ void softmax_f32(const FlashArgs& a,
                                            float (&s)[TM][4],
                                            float (&o)[TM][TO], float (&m)[TM],
                                            float (&l)[TM], int row0, int k0,
                                            float scale_log2) {
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qpos = row0 + row_of(i);
    uint32_t ok = 0;
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float& x = s[i][j];
      if (kMode != kPlain) {
        const bool valid = score_valid(a, qpos, k0 + 8 * j);
        ok |= static_cast<uint32_t>(valid) << j;
        float t;
        if (kMode == kSoftcap)
          x = valid ? score(a, x, &t) * kLog2e : kNegInf;
        else
          x = valid ? x : kNegInf;
      }
      mx = fmaxf(mx, x);
    }
    mx = row8_max(mx);
    if (kMode != kSoftcap) mx *= scale_log2;   // raw dots; -1e30 stays low
    const float m_new = fmaxf(m[i], mx);
    const float alpha = ex2(m[i] - m_new);
    float sum = 0.f;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float& x = s[i][j];
      const float p = kMode == kSoftcap ? ex2(x - m_new)
                                        : ex2(fmaf(x, scale_log2, -m_new));
      x = kMode == kPlain || (ok >> j) & 1u ? p : 0.f;
      sum += x;
    }
    l[i] = l[i] * alpha + sum;             // this thread's part of the row
    m[i] = m_new;
#pragma unroll
    for (int c = 0; c < TO; ++c) o[i][c] *= alpha;
  }
}

// P and dS in place for a thread's tile, as p_ds_tile of the bf16 backward:
// on entry s holds the raw dots and dp holds dP; element (i, j) has row
// row0 + row_of(i) and column c0 + 8 j; kT: rows are keys and columns
// queries (dk/dv). stats(i, j) gives the element's query's (lse * log2e, D).
template <SoftmaxMode kMode, bool kT, int TM, class Stats>
__device__ __forceinline__ void p_ds_f32(const FlashArgs& a, float (&s)[TM][4],
                                         float (&dp)[TM][4], int row0, int c0,
                                         float scale_log2, Stats stats) {
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int row = row0 + row_of(i), col = c0 + 8 * j;
      const float2 st = stats(i, j);
      float p, dcap = 1.f;
      if constexpr (kMode == kSoftcap) {
        float t;
        const float x = score(a, s[i][j], &t);
        dcap = 1.f - t * t;
        p = ex2(fmaf(x, kLog2e, -st.x));
      } else {
        p = ex2(fmaf(s[i][j], scale_log2, -st.x));
      }
      if (kMode != kPlain &&
          !(kT ? score_valid(a, col, row) : score_valid(a, row, col)))
        p = 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - st.y) * dcap;
    }
}

// Forward: one block per (q head, batch, q tile of 128 rows, 64 at hd 128),
// the longest rows first. Q^T stays in shared memory; K and V tiles of 32
// keys stream through two cp.async stages; each warp skips the tiles that
// hold no live pair for its rows and picks each tile's softmax mode for its
// rows. S = Q K^T and O += P V in f32 on the CUDA cores, P through the
// warp's exchange tile.
template <int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_fwd_f32_kernel(const FlashArgs a) {
  using L = FwdTile<HD>;
  constexpr int TM = L::kTM, TO = L::kTO;
  extern __shared__ __align__(16) float smem_f32[];
  float* const qt = smem_f32;                      // [HD][kRows]: Q^T
  float* const ring = qt + HD * L::kRows;          // [2][K, V][32][HD + 4]
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int rl = lane / 8, cl = lane % 8;
  float* const xp = ring + 4 * L::kNat + warp * kF32Stream * L::kLdx + 4 * rl;

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (a.S + L::kRows - 1) / L::kRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.z)) * L::kRows;
  const int w0 = q0 + warp * L::kWR;               // the warp's first row
  const int hk = h / (a.nq / a.nkv);
  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const int n_kt = (a.T + kF32Stream - 1) / kF32Stream;
  auto next_live = [&](int kt) {
    do ++kt;
    while (kt < n_kt &&
           !tile_live(a, q0, kt * kF32Stream, L::kRows, kF32Stream));
    return kt;
  };
  auto load_kv = [&](int st, int kt) {
    const int k0 = kt * kF32Stream;
    float* dst = ring + 2 * st * L::kNat;
    load_stream<HD>(dst, kp + static_cast<long long>(k0) * a.k_ss, a.k_ss,
                    a.T - k0);
    load_stream<HD>(dst + L::kNat, vp + static_cast<long long>(k0) * a.v_ss,
                    a.v_ss, a.T - k0);
  };

  int kt = next_live(-1);
  if (kt < n_kt) load_kv(0, kt);
  cp_async_commit();
  load_t<HD, L::kRows>(qt, qp + static_cast<long long>(q0) * a.q_ss, a.q_ss,
                       a.S - q0);

  float o[TM][TO], m[TM], l[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < TO; ++c) o[i][c] = 0.f;
  }
  const float scale_log2 = a.scale * kLog2e;
  const float* const qw = qt + warp * L::kWR + 4 * rl;   // this thread's rows
  for (int st = 0; kt < n_kt; st ^= 1) {
    cp_async_wait<0>();                    // tile kt has landed, and every
    __syncthreads();                       // warp is done with stage st ^ 1
    const int kt_next = next_live(kt);
    if (kt_next < n_kt) load_kv(st ^ 1, kt_next);
    cp_async_commit();
    const int k0 = kt * kF32Stream;
    if (tile_live(a, w0, k0, L::kWR, kF32Stream)) {   // warp-uniform
      const float* ks = ring + 2 * st * L::kNat;
      float s[TM][4] = {};
      dot_rows<HD, TM, L::kRows>(s, qw, ks, cl);
      if (a.softcap > 0.f)
        softmax_f32<kSoftcap>(a, s, o, m, l, w0 + 4 * rl, k0 + cl,
                              scale_log2);
      else if (tile_full(a, w0, k0, L::kWR, kF32Stream))
        softmax_f32<kPlain>(a, s, o, m, l, w0 + 4 * rl, k0 + cl, scale_log2);
      else
        softmax_f32<kMasked>(a, s, o, m, l, w0 + 4 * rl, k0 + cl,
                             scale_log2);
      put_t<TM, L::kLdx>(xp, s, cl);
      __syncwarp();
      acc_cols<HD, TM, L::kLdx>(o, xp, ks + L::kNat + col0<HD>(cl));
    }
    kt = kt_next;
  }
  cp_async_wait<0>();

  float* const op = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const float l_row = row8_sum(l[i]);
    const int qpos = w0 + 4 * rl + row_of(i);
    if (qpos < a.S) {
      const float inv = 1.f / fmaxf(l_row, 1e-30f);
      store_cols<HD>(op + ((static_cast<long long>(b) * a.S + qpos) * a.nq +
                           h) * HD + col0<HD>(cl),
                     o[i], inv);
      if (cl == 0)
        a.lse[(static_cast<long long>(b) * a.nq + h) * a.S + qpos] =
            (m[i] + log2f(l_row)) * kLn2;
    }
  }
}

// dq: one block per (q head, batch, q tile of 64 rows), the longest rows
// first; also writes D = rowsum(dO * O) for the dk/dv kernel. Q^T and dO^T
// stay in shared memory; K and V tiles of 32 keys stream through two
// cp.async stages. S = Q K^T, dP = dO V^T, then dQ += dS K with dS through
// the warp's exchange tile.
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 3 : 1)
flash_bwd_dq_f32_kernel(const FlashArgs a) {
  using L = BwdTile<HD>;
  constexpr int TM = L::kTM, TO = L::kTO;
  extern __shared__ __align__(16) float smem_f32[];
  __shared__ float d_s[L::kRows];
  float* const qt = smem_f32;                      // [HD][kRows]: Q^T
  float* const dot = qt + HD * L::kRows;           // [HD][kRows]: dO^T
  float* const ring = dot + HD * L::kRows;         // [2][K, V][32][HD + 4]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rl = lane / 8, cl = lane % 8;
  float* const xp = ring + 4 * L::kNat + warp * kF32Stream * L::kLdx + 4 * rl;

  const int h = blockIdx.x, b = blockIdx.y;
  const int n_qt = (a.S + L::kRows - 1) / L::kRows;
  const int q0 = (n_qt - 1 - static_cast<int>(blockIdx.z)) * L::kRows;
  const int w0 = q0 + warp * L::kWR;
  const int hk = h / (a.nq / a.nkv);
  const float* qp = static_cast<const float*>(a.q) + b * a.q_sb + h * a.q_sh;
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;
  const float* op = static_cast<const float*>(a.o) + b * a.o_sb + h * a.o_sh;
  const float* dop =
      static_cast<const float*>(a.dout) + b * a.do_sb + h * a.do_sh;
  const long long rowbase = (static_cast<long long>(b) * a.nq + h) * a.S;
  const int n_kt = (a.T + kF32Stream - 1) / kF32Stream;
  auto next_live = [&](int kt) {
    do ++kt;
    while (kt < n_kt &&
           !tile_live(a, q0, kt * kF32Stream, L::kRows, kF32Stream));
    return kt;
  };
  auto load_kv = [&](int st, int kt) {
    const int k0 = kt * kF32Stream;
    float* dst = ring + 2 * st * L::kNat;
    load_stream<HD>(dst, kp + static_cast<long long>(k0) * a.k_ss, a.k_ss,
                    a.T - k0);
    load_stream<HD>(dst + L::kNat, vp + static_cast<long long>(k0) * a.v_ss,
                    a.v_ss, a.T - k0);
  };

  int kt = next_live(-1);
  if (kt < n_kt) load_kv(0, kt);
  cp_async_commit();
  load_t<HD, L::kRows>(qt, qp + static_cast<long long>(q0) * a.q_ss, a.q_ss,
                       a.S - q0);
  load_t<HD, L::kRows>(dot, dop + static_cast<long long>(q0) * a.do_ss,
                       a.do_ss, a.S - q0);
  {  // D of the tile's rows: two threads a row, one half of hd each
    const int r = tid / 2, half = tid % 2;
    const int qpos = q0 + r;
    float part_d = 0.f;
    if (qpos < a.S) {
      const float* orow = op + static_cast<long long>(qpos) * a.o_ss;
      const float* drow = dop + static_cast<long long>(qpos) * a.do_ss;
#pragma unroll
      for (int c = 0; c < HD / 8; ++c) {
        const int d = half * (HD / 2) + 4 * c;
        const float4 ov = __ldg(reinterpret_cast<const float4*>(orow + d));
        const float4 dv = __ldg(reinterpret_cast<const float4*>(drow + d));
        part_d = fmaf(ov.x, dv.x, part_d);
        part_d = fmaf(ov.y, dv.y, part_d);
        part_d = fmaf(ov.z, dv.z, part_d);
        part_d = fmaf(ov.w, dv.w, part_d);
      }
    }
    part_d += __shfl_xor_sync(0xffffffffu, part_d, 1);
    if (half == 0) {
      d_s[r] = part_d;
      if (qpos < a.S) a.dsum[rowbase + qpos] = part_d;
    }
  }
  __syncthreads();
  // (lse * log2e, D) of this thread's rows; rows past S read Q = dO = 0
  // and lse = D = 0, so their dS is 0
  float2 stat[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qpos = w0 + 4 * rl + row_of(i);
    stat[i] = qpos < a.S ? make_float2(a.lse[rowbase + qpos] * kLog2e,
                                       d_s[qpos - q0])
                         : make_float2(0.f, 0.f);
  }
  auto stats = [&](int i, int) { return stat[i]; };

  float dq[TM][TO];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TO; ++c) dq[i][c] = 0.f;
  const float scale_log2 = a.scale * kLog2e;
  const float* const qw = qt + warp * L::kWR + 4 * rl;
  const float* const dw = dot + warp * L::kWR + 4 * rl;
  for (int st = 0; kt < n_kt; st ^= 1) {
    cp_async_wait<0>();
    __syncthreads();
    const int kt_next = next_live(kt);
    if (kt_next < n_kt) load_kv(st ^ 1, kt_next);
    cp_async_commit();
    const int k0 = kt * kF32Stream;
    if (tile_live(a, w0, k0, L::kWR, kF32Stream)) {
      const float* ks = ring + 2 * st * L::kNat;
      float s[TM][4] = {}, dp[TM][4] = {};
      dot_rows<HD, TM, L::kRows>(s, qw, ks, cl);
      dot_rows<HD, TM, L::kRows>(dp, dw, ks + L::kNat, cl);
      if (a.softcap > 0.f)
        p_ds_f32<kSoftcap, false>(a, s, dp, w0 + 4 * rl, k0 + cl, scale_log2,
                                  stats);
      else if (tile_full(a, w0, k0, L::kWR, kF32Stream))
        p_ds_f32<kPlain, false>(a, s, dp, w0 + 4 * rl, k0 + cl, scale_log2,
                                stats);
      else
        p_ds_f32<kMasked, false>(a, s, dp, w0 + 4 * rl, k0 + cl, scale_log2,
                                 stats);
      put_t<TM, L::kLdx>(xp, dp, cl);
      __syncwarp();
      acc_cols<HD, TM, L::kLdx>(dq, xp, ks + col0<HD>(cl));
    }
    kt = kt_next;
  }
  cp_async_wait<0>();

  float* const dqp = static_cast<float*>(a.dq);
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int qpos = w0 + 4 * rl + row_of(i);
    if (qpos < a.S)
      store_cols<HD>(dqp + ((static_cast<long long>(b) * a.S + qpos) * a.nq +
                            h) * HD + col0<HD>(cl),
                     dq[i], a.scale);
  }
}

// dk/dv: one block per (q head, batch, k tile of 64 keys), the k tiles with
// the most live queries first, so that no block walks more than one head's
// query tiles. K^T and V^T stay in shared memory; Q, dO, lse and D of 32
// queries stream through two cp.async stages. S^T = K Q^T, dP^T = V dO^T,
// then dV += P^T dO and dK += dS^T Q with P, then dS, through the warp's
// exchange tile (one tile for both leaves room for three blocks an SM at
// hd 64). Each block writes its head's dK (unscaled) and dV to the
// partials [B, T, nq, hd]; flash_bwd_dkdv_sum_f32_kernel sums them by group.
template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 3 : 1)
flash_bwd_dkdv_f32_kernel(const FlashArgs a) {
  using L = BwdTile<HD>;
  constexpr int TM = L::kTM, TO = L::kTO;
  constexpr int kStage = dkdv_f32_stage<HD>();
  extern __shared__ __align__(16) float smem_f32[];
  float* const kt_s = smem_f32;                    // [HD][kRows]: K^T
  float* const vt_s = kt_s + HD * L::kRows;        // [HD][kRows]: V^T
  float* const ring = vt_s + HD * L::kRows;        // [2][Q, dO, lse, D]
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int rl = lane / 8, cl = lane % 8;
  float* const px = ring + 2 * kStage + warp * kF32Stream * L::kLdx +
                    4 * rl;                        // this warp's P, then dS

  const int b = blockIdx.y, h = blockIdx.x, hk = h / (a.nq / a.nkv);
  const int k0 = static_cast<int>(blockIdx.z) * L::kRows;
  const int w0 = k0 + warp * L::kWR;               // the warp's first key
  const float* kp = static_cast<const float*>(a.k) + b * a.k_sb + hk * a.k_sh;
  const float* vp = static_cast<const float*>(a.v) + b * a.v_sb + hk * a.v_sh;

  // The live q tiles of this k tile are one range (the causal test keeps
  // tiles from some q0 on, the window's up to some q0).
  const int n_qt = (a.S + kF32Stream - 1) / kF32Stream;
  int qt_lo = 0;
  while (qt_lo < n_qt &&
         !tile_live(a, qt_lo * kF32Stream, k0, kF32Stream, L::kRows))
    ++qt_lo;
  int qt_hi = qt_lo;
  while (qt_hi < n_qt &&
         tile_live(a, qt_hi * kF32Stream, k0, kF32Stream, L::kRows))
    ++qt_hi;
  // step idx: q tile qt_lo + idx
  const int n_steps = qt_hi - qt_lo;
  auto load_q = [&](int st, int idx) {    // Q, dO, lse and D of step idx
    const int q0 = (qt_lo + idx) * kF32Stream;
    const long long rowbase = (static_cast<long long>(b) * a.nq + h) * a.S;
    float* dst = ring + st * kStage;
    load_stream<HD>(dst, static_cast<const float*>(a.q) + b * a.q_sb +
                             h * a.q_sh +
                             static_cast<long long>(q0) * a.q_ss,
                    a.q_ss, a.S - q0);
    load_stream<HD>(dst + L::kNat, static_cast<const float*>(a.dout) +
                                       b * a.do_sb + h * a.do_sh +
                                       static_cast<long long>(q0) * a.do_ss,
                    a.do_ss, a.S - q0);
    if (tid < 2 * kF32Stream) {            // zeros past S
      const int qr = tid % kF32Stream;
      const bool ok = q0 + qr < a.S;
      cp_async4(smem_u32(dst + 2 * L::kNat + tid),
                (tid < kF32Stream ? a.lse : a.dsum) + rowbase +
                    (ok ? q0 + qr : 0),
                ok);
    }
  };

  int idx = 0;
  if (idx < n_steps) load_q(0, idx);
  cp_async_commit();
  load_t<HD, L::kRows>(kt_s, kp + static_cast<long long>(k0) * a.k_ss, a.k_ss,
                       a.T - k0);
  load_t<HD, L::kRows>(vt_s, vp + static_cast<long long>(k0) * a.v_ss, a.v_ss,
                       a.T - k0);

  float dk[TM][TO], dv[TM][TO];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TO; ++c) dk[i][c] = dv[i][c] = 0.f;
  const float scale_log2 = a.scale * kLog2e;
  const float* const kw = kt_s + warp * L::kWR + 4 * rl;  // this thread's keys
  const float* const vw = vt_s + warp * L::kWR + 4 * rl;
  for (int st = 0; idx < n_steps; st ^= 1, ++idx) {
    cp_async_wait<0>();
    __syncthreads();
    if (idx + 1 < n_steps) load_q(st ^ 1, idx + 1);
    cp_async_commit();
    const int q0 = (qt_lo + idx) * kF32Stream;
    if (tile_live(a, q0, w0, kF32Stream, L::kWR)) {
      const float* qs = ring + st * kStage;
      const float* dos = qs + L::kNat;
      const float* lse_s = dos + L::kNat;
      float s[TM][4] = {}, dp[TM][4] = {};
      dot_rows<HD, TM, L::kRows>(s, kw, qs, cl);
      dot_rows<HD, TM, L::kRows>(dp, vw, dos, cl);
      float2 stat[4];
#pragma unroll
      for (int j = 0; j < 4; ++j)
        stat[j] = make_float2(lse_s[cl + 8 * j] * kLog2e,
                              lse_s[kF32Stream + cl + 8 * j]);
      auto stats = [&](int, int j) { return stat[j]; };
      if (a.softcap > 0.f)
        p_ds_f32<kSoftcap, true>(a, s, dp, w0 + 4 * rl, q0 + cl, scale_log2,
                                 stats);
      else if (tile_full(a, q0, w0, kF32Stream, L::kWR))
        p_ds_f32<kPlain, true>(a, s, dp, w0 + 4 * rl, q0 + cl, scale_log2,
                               stats);
      else
        p_ds_f32<kMasked, true>(a, s, dp, w0 + 4 * rl, q0 + cl, scale_log2,
                                stats);
      put_t<TM, L::kLdx>(px, s, cl);
      __syncwarp();
      acc_cols<HD, TM, L::kLdx>(dv, px, dos + col0<HD>(cl));
      __syncwarp();
      put_t<TM, L::kLdx>(px, dp, cl);
      __syncwarp();
      acc_cols<HD, TM, L::kLdx>(dk, px, qs + col0<HD>(cl));
    }
  }
  cp_async_wait<0>();

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int kpos = w0 + 4 * rl + row_of(i);
    if (kpos >= a.T) continue;
    const long long at =
        ((static_cast<long long>(b) * a.T + kpos) * a.nq + h) * HD +
        col0<HD>(cl);
    store_cols<HD>(a.dk_part + at, dk[i], 1.f);
    store_cols<HD>(a.dv_part + at, dv[i], 1.f);
  }
}

// dK = scale * the sum of the partials of query heads hk * group + g over
// g = 0, 1, ... in that order, dV likewise unscaled: a float4 of each a
// thread; grid (B * T * hd / 4 / kSumThreads, nkv).
constexpr int kSumThreads = 256;
template <int HD>
__global__ void __launch_bounds__(kSumThreads)
flash_bwd_dkdv_sum_f32_kernel(const FlashArgs a) {
  constexpr int kV = HD / 4;
  const long long i =
      static_cast<long long>(blockIdx.x) * kSumThreads + threadIdx.x;
  if (i >= static_cast<long long>(a.B) * a.T * kV) return;
  const long long bt = i / kV;             // b * T + t
  const int c = static_cast<int>(i % kV), hk = blockIdx.y;
  const int group = a.nq / a.nkv;
  const long long src = (bt * a.nq + hk * group) * kV + c;
  const float4* pk = reinterpret_cast<const float4*>(a.dk_part) + src;
  const float4* pv = reinterpret_cast<const float4*>(a.dv_part) + src;
  float4 sk = pk[0], sv = pv[0];
  for (int g = 1; g < group; ++g) {
    const float4 k4 = pk[g * kV], v4 = pv[g * kV];
    sk.x += k4.x, sk.y += k4.y, sk.z += k4.z, sk.w += k4.w;
    sv.x += v4.x, sv.y += v4.y, sv.z += v4.z, sv.w += v4.w;
  }
  const long long dst = (bt * a.nkv + hk) * kV + c;
  reinterpret_cast<float4*>(a.dk)[dst] = make_float4(
      sk.x * a.scale, sk.y * a.scale, sk.z * a.scale, sk.w * a.scale);
  reinterpret_cast<float4*>(a.dv)[dst] = sv;
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

// bf16 takes the tensor-core kernel, f32 the CUDA-core one (grid (q head,
// batch, q tile), the longest rows first).
template <typename T, int HD>
int fwd(const FlashArgs& a, void* stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const dim3 grid((a.S + kTile - 1) / kTile, a.nq, a.B);
    return launch(flash_fwd_mma_kernel<HD>, grid, fwd_mma_smem<HD>(), a,
                  stream);
  } else {
    constexpr int kRows = FwdTile<HD>::kRows;
    return launch(flash_fwd_f32_kernel<HD>,
                  dim3(a.nq, a.B, (a.S + kRows - 1) / kRows),
                  fwd_f32_smem<HD>(), a, stream);
  }
}

// The backward likewise: bf16 on the tensor cores, f32 on the CUDA cores.
template <typename T, int HD>
int bwd_dq(const FlashArgs& a, void* stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const dim3 grid((a.S + kTile - 1) / kTile, a.nq, a.B);
    return launch(flash_bwd_dq_mma_kernel<HD>, grid, dq_mma_smem<HD>(), a,
                  stream);
  } else {
    constexpr int kRows = BwdTile<HD>::kRows;
    return launch(flash_bwd_dq_f32_kernel<HD>,
                  dim3(a.nq, a.B, (a.S + kRows - 1) / kRows),
                  dq_f32_smem<HD>(), a, stream);
  }
}

template <typename T, int HD>
int bwd_dkdv(const FlashArgs& a, void* stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    const int n_kt = (a.T + kTile - 1) / kTile;
    return launch(flash_bwd_dkdv_mma_kernel<HD>, dim3(a.nkv, a.B, n_kt),
                  dkdv_mma_smem<HD>(), a, stream, kDkdvThreads);
  } else {
    constexpr int kRows = BwdTile<HD>::kRows;
    return launch(flash_bwd_dkdv_f32_kernel<HD>,
                  dim3(a.nq, a.B, (a.T + kRows - 1) / kRows),
                  dkdv_f32_smem<HD>(), a, stream);
  }
}

constexpr int kNoSumPass = -2;

// The f32 backward's third launch; the bf16 dk/dv kernel sums its group
// itself.
template <typename T, int HD>
int bwd_sum(const FlashArgs& a, void* stream) {
  if constexpr (std::is_same_v<T, __nv_bfloat16>) {
    return kNoSumPass;
  } else {
    const long long n = static_cast<long long>(a.B) * a.T * (HD / 4);
    return launch(flash_bwd_dkdv_sum_f32_kernel<HD>,
                  dim3(static_cast<unsigned>((n + kSumThreads - 1) /
                                             kSumThreads),
                       a.nkv),
                  0, a, stream, kSumThreads);
  }
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
template <typename T, int HD>
struct BwdSum {
  static int run(const FlashArgs& a, void* s) { return bwd_sum<T, HD>(a, s); }
};

}  // namespace

// Plain C entry points for ctypes. Each launches one kernel on `stream`
// and returns cudaGetLastError() after the launch (0 = cudaSuccess), -1
// for a head dim that has no instantiation, or -2 for the sum pass in
// bf16.
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

// f32: writes each query head's dK and dV to dk_part and dv_part, which
// flash_attention_bwd_sum then sums into dk and dv.
extern "C" int flash_attention_bwd_dkdv(const FlashArgs* a, int hd, int bf16,
                                        void* stream) {
  return dispatch<BwdDkdv>(*a, hd, bf16, stream);
}

// f32 only, after flash_attention_bwd_dkdv on the same stream.
extern "C" int flash_attention_bwd_sum(const FlashArgs* a, int hd, int bf16,
                                       void* stream) {
  return dispatch<BwdSum>(*a, hd, bf16, stream);
}

// Dynamic shared memory of a launch: which = 0 forward, 1 dq, 2 dk/dv;
// bf16 = 1 for the bf16 (tensor-core) kernels, 0 for the f32 ones.
template <int HD>
int smem_bytes(int which, int bf16) {
  if (which == 0) return bf16 ? fwd_mma_smem<HD>() : fwd_f32_smem<HD>();
  if (which == 1) return bf16 ? dq_mma_smem<HD>() : dq_f32_smem<HD>();
  return bf16 ? dkdv_mma_smem<HD>() : dkdv_f32_smem<HD>();
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
  if (code == kNoSumPass) return "the bf16 backward has no sum pass";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
