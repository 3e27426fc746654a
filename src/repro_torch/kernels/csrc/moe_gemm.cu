// Grouped (per-expert) matmul for Hopper, out[e] = x[e] @ w[e], and its
// two gradients (dx, dw; see "Backward" below).
//
// Replaces the TPU kernel repro/kernels/moe_gemm.py:_moe_gemm_kernel
// (launched by moe_gemm_pallas). Plain version:
// repro_torch/kernels/ref.py:moe_gemm_ref. Wrapper, checks, padding and
// launch count: repro_torch/kernels/moe_gemm.py.
//
// x [E,C,D], w [E,D,F], out [E,C,F], row-major and contiguous; bf16 or
// f32 in and out, f32 accumulation, output rounded once at the end. Two
// kernels, picked by dtype:
//   * bf16: moe_gemm_wgmma_kernel, on the tensor cores (wgmma fed by TMA).
//     bf16 products are exact in f32, and the JAX kernel casts to f32
//     before its dot, so this is the same function; only the order of
//     the sums differs.
//   * f32: moe_gemm_f32_kernel, on the CUDA cores. Tensor cores would
//     take f32 only as TF32 (about 10 mantissa bits).
//
// Bound. Serving decode: C = 4 slots x capacity 4 = 16 rows an expert,
// 2*C = 32 flops a weight element, 16 flops a byte in bf16, far below the
// ~295 flops a byte at which the H100's bf16 tensor cores become the
// limit: the weights' bytes bound the call (qwen2-moe gate/up: 369 MB of
// weights, ~0.11 ms at 3.35 TB/s). Prefill (Jamba, C = 640 rows an
// expert, d = 4096, f = 14336): 1,280 flops a weight byte, so the
// products bound it: 1.2 TFLOP a call, 1.2 ms at 989 TFLOP/s.
//
// bf16 design (one launch a call, no split-K):
//   * One block per (row tile of C, 128 columns of F, expert). Row tiles
//     are 128 rows (two consumer warpgroups of 64) where C >= 128, else
//     64 rows (one warpgroup; at C = 16 three quarters of the rows are
//     zero fill, which costs nothing that matters: the call is bound by
//     the weights' bytes and the tensor cores have ~4x of slack). Row
//     tiles vary fastest in the grid, so the blocks that share a weight
//     tile run together and the weights come from memory about once.
//   * The contraction runs in 64-element (128 B) steps through a ring of
//     4 shared-memory stages. One producer warp issues TMA loads
//     (3-D tensor maps [E,C,D] and [E,D,F], expert outermost, so TMA's
//     zero fill, not the next expert's rows, pads ragged C, D and F) and
//     signals a "full" mbarrier per stage; the consumers release a stage
//     through its "empty" mbarrier once the wgmma that read it is done,
//     so loads run a stage or more ahead of the products.
//   * Consumers run wgmma.m64n128k16 (f32 += bf16 x bf16) with the f32
//     accumulator in registers: A (x) is K-major, B (w, f contiguous) is
//     MN-major through the transpose bit; both tiles use TMA's 128-byte
//     swizzle, which the shared-memory descriptors name.
//   * The epilogue maps the accumulator fragment to (row, column), rounds
//     to bf16 once and stores with masks for ragged C and F.
//   * TMA needs 16-byte row strides: the wrapper pads d and f of bf16
//     operands to multiples of 8 (as the JAX wrapper pads to its blocks).
//
// f32 design: moe_gemm_f32_kernel, one tiled and pipelined CUDA-core GEMM
// for the forward and both gradients (the three differ only in which
// operand is contiguous along the contraction; template parameters).
// Bound: a training call (C = 640, d = 2048, f = 1408) does 2*C = 1,280
// flops a weight element, 320 a byte, far above the ~20 flops a byte at
// which the 67 TFLOP/s of f32 FMAs become the limit; so the FMA pipes,
// not memory, must set its pace. Decode (C = 16) does 8 a byte and is
// bound by the weights' bytes.
//   * One block per (row tile, column tile, expert), row tiles varying
//     fastest, so the blocks that share an expert's B tile run together
//     and its slabs stay in L2. No split-K and no atomics.
//   * 128 x 128 output tiles, 256 threads, each 8 x 8 outputs as two
//     4 x 4 sub-tiles 16 rows and 32 columns apart (a warp owns 32 x 64).
//     Both operands are staged in shared memory as [k][m] and [k][n], so
//     each k costs a thread four 16-byte reads for 64 FMAs, and a warp's
//     16-byte reads touch at most 128 bytes (one wavefront).
//   * The contraction runs in chunks of 16 through a ring of 2 stages:
//     the next chunk loads while this chunk's 1,024 FMAs a thread run
//     (chunks of 8, and 3 or 4 stages, were no faster on the card).
//     Operands contiguous along M or N (the forward's w, dw's x and dy)
//     go to shared memory by 16-byte cp.async, zero-filled past the
//     edges. Operands contiguous along K (the forward's x, dx's dy and w)
//     cannot be transposed by a copy engine: each thread loads its
//     16-byte pieces of the next chunk into registers while the current
//     chunk's FMAs run, then stores them transposed into rows padded to
//     16n + 4 words (at most two-way bank conflicts). Staging them as
//     they lie and reading 4 k at once was slower (more registers).
//   * 128 registers a thread at most (two blocks an SM), no spills.
//   * Few rows an expert (decode): the same kernel in 16 x 256 tiles,
//     4 x 4 outputs a thread (moe_gemm_f32_narrow), so that C = 16 does
//     not pay for 128 rows of FMAs and the weights stream from memory
//     about once; the wrapper picks the tile by C.
//   * Order: each output is one thread's fmaf chain over k = 0 .. K-1
//     from 0, whatever the tile, the route or C. So two calls agree bit
//     for bit, a row's result does not depend on the other rows of its
//     expert (batch invariance: the tiny f32 engine equals greedy decode
//     at another C), and an expert whose rows are all zero gets exact
//     zeros in dw. Zero padding adds exact zeros to the chain's end.
//   * cp.async and float4 need 16-byte rows: the wrapper pads d and f of
//     f32 operands to multiples of 4 and slices the output back.
// On the TPU the contraction was a sequential grid axis carrying an f32
// VMEM accumulator. Blocks here run in no order, so the contraction is
// a loop inside the block.
//
// Backward (no TPU counterpart: the JAX package differentiates its jnp
// oracle, repro/kernels/ref.py:moe_gemm_ref). Plain version:
// repro_torch/kernels/ref.py:moe_gemm_bwd_ref. From the forward's x, w
// and the output gradient dy [E,C,F]:
//   dx [E,C,D] = dy w^T   (per expert: M = C, N = D, K = F)
//   dw [E,D,F] = x^T dy   (per expert: M = D, N = F, K = C)
// Bound: each is one more grouped GEMM of the forward's 2*E*C*D*F flops,
// bound by the products. One MoE train layer's three calls (gate, up,
// down at E = 64, C = 640, d = 2048, f = 1408): 0.7166 ms for dx and as
// much for dw at 989 bf16 TFLOP/s; Jamba's (E = 16, C = 1280, d = 4096,
// f = 14336): 7.30 ms each. Designs, one launch a gradient, f32 sums
// rounded once:
//   * bf16: moe_gemm_dx_wgmma_kernel and moe_gemm_dw_wgmma_kernel
//     (persistent_bwd). The first design ran them on the forward's body,
//     one block a 128 x 128 tile. Timing dw at E = 64, d = 2048, f = 1408
//     and C = 320 ... 2560 (an H100 80GB HBM3 at 700 W) gave 0.318 ms +
//     0.0334 ms a 64-deep k-step: per wave of 132 tiles, 3.7 us of fixed
//     cost (barriers, a cold ring, its drain, register stores, the block's
//     exit, with the tensor cores idle) beside 0.39 us a k-step (0.28 at
//     peak), so at C = 640 (10 k-steps) half of dw was fixed cost. Now:
//     - persistent: one block an SM (a cluster of two for dw), each
//       walking its tiles in a banded raster, barriers set up once;
//     - one producer thread keeps the TMA ring full across tiles;
//     - two consumer warpgroups in ping-pong, one tile each: one
//       multiplies while the other stores its tile through shared memory
//       and TMA (whole lines, asynchronous, clipped at ragged edges);
//       setmaxnreg moves registers from the producer (40) to them (232);
//     - tiles of 128 accumulators a thread: dx 64 x 256 (m64n256k16, the
//       fewest shared-memory reads a product); dw 128 x 128 (two
//       m64n128k16), whose B tile the cluster's two CTAs share by TMA
//       multicast. 64 x 256 tiles need a quarter more operand bytes a
//       product than 128 x 128, which slowed dw's main loop; 128 x 128
//       slowed dx on Jamba's long-K layer (K = 14,336 and 4,096). Each
//       product keeps the layout that was faster for it.
//     After: 0.018 ms + 0.0379 ms a k-step, 0.2 us of fixed cost a wave;
//     the main loop (0.44 us a k-step) is what is left, with the card at
//     its power limit (1.3-1.7 GHz under these products). No split-K and
//     no atomics: each output element is one thread's sum over K in
//     ascending order, so two calls agree bit for bit (and with the first
//     design), and an expert that no token reaches (all its rows zero)
//     gets exact zeros in dw.
//   * f32: moe_gemm_f32_kernel<128, false, false> (dx) and <128, true,
//     true> (dw), the forward's tiled CUDA-core GEMM (f32 design above).

#include <cuda.h>  // CUtensorMap and its types; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <atomic>
#include <climits>
#include <cstdint>
#include <cstdio>

namespace {

// ------------------------------------------------ f32: CUDA-core tiles
// One template for the three f32 products: out[e] (M x N) = A[e] (M x K)
// x B[e] (K x N), with A stored [M][K] or, kAmn, [K][M], and B stored
// [N][K] or, kBmn, [K][N]:
//   forward  A = x  [C][d]                B = w  [d][f]          <false, true>
//   dx       A = dy [C][f]                B = w  [d][f] as [N][K] <false, false>
//   dw       A = x  [C][d] as [K][M]      B = dy [C][f]          <true, true>
// Both operands are staged in shared memory as [k][m] and [k][n], so that
// each k costs a thread four 16-byte reads (two of A, two of B) for 64
// FMAs. See the note at the top for the design and its bound.
//
// A block's output tile: a thread's kSubM x kSubN sub-tiles of 4 x 4
// outputs, the sub-tiles of a warp's 4 x 8 lanes side by side (so that a
// warp's 16-byte reads of a k touch 64 bytes of A and 128 of B, one
// wavefront each), kWarpsM x kWarpsN warps; 256 threads, two blocks an SM
// (at most 128 registers a thread).
template <int kSubM_, int kSubN_, int kWarpsM_>
struct F32Shape {
  static constexpr int kSubM = kSubM_, kSubN = kSubN_;
  static constexpr int kLanesM = 4, kLanesN = 8;
  static constexpr int kWM = 4 * kSubM * kLanesM;      // a warp's rows
  static constexpr int kWN = 4 * kSubN * kLanesN;      // a warp's columns
  static constexpr int kWarpsM = kWarpsM_, kWarpsN = 8 / kWarpsM_;
  static constexpr int kBM = kWarpsM * kWM, kBN = kWarpsN * kWN;
  static constexpr int kThreads = 256;
};
// the tile by rows a block: 128 x 128 (8 x 8 outputs a thread), or for
// few rows an expert 16 x 256 (4 x 4 a thread)
template <int kRows>
struct F32Tile;
template <>
struct F32Tile<128> : F32Shape<2, 2, 4> {};
template <>
struct F32Tile<16> : F32Shape<1, 1, 1> {};
static_assert(F32Tile<128>::kBM == 128 && F32Tile<16>::kBM == 16, "rows");
constexpr int kFK = 16;       // contraction chunk
constexpr int kFStages = 2;   // chunks in the shared-memory ring: the
                              // next chunk loads while this one's FMAs
                              // run (1,024 a thread at 128 rows)
constexpr int kFPad = 4;      // words after each staged row: with rows of
                              // 16n + 4 words, the transposed stores of
                              // a K-contiguous operand conflict at most
                              // two ways

// Dynamic shared memory of moe_gemm_f32_kernel<kRows, ...>, the ring of A
// and B chunks: 33,792 bytes at 128 rows, 35,840 at 16 (under the 48 KB
// a launch gets without opting in).
template <int kRows>
constexpr int f32_smem_bytes() {
  using L = F32Tile<kRows>;
  return kFStages * kFK * (L::kBM + L::kBN + 2 * kFPad) * 4;
}
static_assert(f32_smem_bytes<128>() <= 48 * 1024 &&
              f32_smem_bytes<16>() <= 48 * 1024, "no opt-in");

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           bool ok) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  // src-size 0 fills the 16 bytes with zeros and reads nothing
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d),
               "l"(src), "r"(ok ? 16 : 0) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
}

// Chunk k0 of an MN-contiguous operand ([K][rows], rows a multiple of 4)
// at tile rows r0 .. r0 + R - 1 into dst [kFK][R + kFPad], by 16-byte
// cp.async; zeros past K and past `rows`. A warp copies whole k-rows.
template <int R, int T>
__device__ __forceinline__ void stage_mn(float* dst, const float* src,
                                         int rows, int K, int r0, int k0,
                                         int tid) {
  constexpr int kVecs = kFK * R / 4;
#pragma unroll
  for (int j = 0; j < (kVecs + T - 1) / T; ++j) {
    const int i = j * T + tid;
    if (kVecs % T != 0 && i >= kVecs) break;
    const int kk = i / (R / 4), c = i % (R / 4) * 4;
    const bool ok = k0 + kk < K && r0 + c < rows;
    cp_async16(dst + kk * (R + kFPad) + c,
               ok ? src + static_cast<size_t>(k0 + kk) * rows + r0 + c : src,
               ok);
  }
}

// A K-contiguous operand ([rows][K], K a multiple of 4): a thread loads
// its 16-byte pieces of the next chunk into registers (`load`) and stores
// them transposed into dst [kFK][R + kFPad] (`store`), one piece at a
// time (two a thread at R = 128: one for each half of the chunk's FMAs,
// so that a piece holds four registers, not eight). Piece i is row i / 4,
// k 4 (i % 4): four neighbouring threads read a row's 64 bytes, a warp 8
// rows; its transposed stores conflict at most two ways (pieces 0 and 2
// of a row share banks).
template <int R, int T>
struct KMajor {
  static constexpr int kVecs = R * kFK / 4;
  static constexpr int kN = (kVecs + T - 1) / T;     // pieces a thread
  float4 v;

  __device__ __forceinline__ void load(int j, const float* src, int rows,
                                       int K, int r0, int k0, int tid) {
    static_assert(kN <= 2, "a piece for each half of a chunk");
    const int i = j * T + tid;
    const int r = r0 + i / (kFK / 4), k = k0 + i % (kFK / 4) * 4;
    v = (i < kVecs && r < rows && k < K)
            ? __ldg(reinterpret_cast<const float4*>(
                  src + static_cast<size_t>(r) * K + k))
            : make_float4(0.f, 0.f, 0.f, 0.f);
  }

  __device__ __forceinline__ void store(int j, float* dst, int tid) const {
    const int i = j * T + tid;
    if (kVecs % T != 0 && i >= kVecs) return;
    float* d = dst + i % (kFK / 4) * 4 * (R + kFPad) + i / (kFK / 4);
    d[0] = v.x;
    d[R + kFPad] = v.y;
    d[2 * (R + kFPad)] = v.z;
    d[3 * (R + kFPad)] = v.w;
  }
};

template <int kRows, bool kAmn, bool kBmn>
__global__ void __launch_bounds__(256, 2)
moe_gemm_f32_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, int M, int N, int K) {
  using L = F32Tile<kRows>;
  constexpr int kTM = 4 * L::kSubM, kTN = 4 * L::kSubN;  // a thread's tile
  constexpr int kPA = L::kBM + kFPad, kPB = L::kBN + kFPad;  // row pitch
  // the ring, in dynamic shared memory (f32_smem_bytes): one buffer (two
  // static arrays compiled to a slower dx)
  extern __shared__ __align__(16) float smem_f32[];
  float* const as = smem_f32;                     // [S][kFK][kPA]
  float* const bs = as + kFStages * kFK * kPA;    // [S][kFK][kPB]
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  // row tiles vary fastest: the blocks that share a B tile run together
  const int m0 = blockIdx.x * L::kBM, n0 = blockIdx.y * L::kBN;
  const int e = blockIdx.z;
  const float* ae = a + static_cast<size_t>(e) * M * K;
  const float* be = b + static_cast<size_t>(e) * K * N;
  // this thread's outputs: rows am + s kWM / kSubM + {0..3}, columns
  // bn + s kWN / kSubN + {0..3} of the block's tile
  const int am = warp % L::kWarpsM * L::kWM + lane / L::kLanesN * 4;
  const int bn = warp / L::kWarpsM * L::kWN + lane % L::kLanesN * 4;
  const int nk = (K + kFK - 1) / kFK;

  constexpr int T = L::kThreads;
  KMajor<L::kBM, T> ra;   // used where A is K-contiguous
  KMajor<L::kBN, T> rb;   // and B
  // cp.async of the MN-contiguous operands' chunk kt, one group a chunk
  auto stage_async = [&](int kt) {
    if (kt < nk) {
      if constexpr (kAmn)
        stage_mn<L::kBM, T>(as + kt % kFStages * kFK * kPA, ae, M, K, m0,
                            kt * kFK, tid);
      if constexpr (kBmn)
        stage_mn<L::kBN, T>(bs + kt % kFStages * kFK * kPB, be, N, K, n0,
                            kt * kFK, tid);
    }
    cp_async_commit();
  };

  float acc[kTM][kTN];
#pragma unroll
  for (int i = 0; i < kTM; ++i)
#pragma unroll
    for (int j = 0; j < kTN; ++j) acc[i][j] = 0.f;

  for (int s = 0; s < kFStages - 1; ++s) stage_async(s);
  for (int j = 0; j < 2; ++j) {
    if constexpr (!kAmn) {
      if (j < ra.kN) {
        ra.load(j, ae, M, K, m0, 0, tid);
        ra.store(j, as, tid);
      }
    }
    if constexpr (!kBmn) {
      if (j < rb.kN) {
        rb.load(j, be, N, K, n0, 0, tid);
        rb.store(j, bs, tid);
      }
    }
  }
  for (int kt = 0; kt < nk; ++kt) {
    // chunk kt is in shared memory, and every thread is done with the
    // stage that the next chunk overwrites (read in iteration kt - 1)
    cp_async_wait<kFStages - 2>();
    __syncthreads();
    stage_async(kt + kFStages - 1);
    const bool next = kt + 1 < nk;
    const int k1 = (kt + 1) * kFK, st1 = (kt + 1) % kFStages;
    const float* at = as + kt % kFStages * kFK * kPA + am;
    const float* bt = bs + kt % kFStages * kFK * kPB + bn;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      // piece h of the next chunk of each K-contiguous operand: loaded
      // before this half chunk's FMAs, stored after them
      if constexpr (!kAmn)
        if (next && h < ra.kN) ra.load(h, ae, M, K, m0, k1, tid);
      if constexpr (!kBmn)
        if (next && h < rb.kN) rb.load(h, be, N, K, n0, k1, tid);
#pragma unroll
      for (int k = h * kFK / 2; k < (h + 1) * kFK / 2; ++k) {
        float av[kTM], bv[kTN];
#pragma unroll
        for (int s = 0; s < L::kSubM; ++s) {
          const float4 v = *reinterpret_cast<const float4*>(
              at + k * kPA + s * (L::kWM / L::kSubM));
          av[4 * s] = v.x, av[4 * s + 1] = v.y;
          av[4 * s + 2] = v.z, av[4 * s + 3] = v.w;
        }
#pragma unroll
        for (int s = 0; s < L::kSubN; ++s) {
          const float4 v = *reinterpret_cast<const float4*>(
              bt + k * kPB + s * (L::kWN / L::kSubN));
          bv[4 * s] = v.x, bv[4 * s + 1] = v.y;
          bv[4 * s + 2] = v.z, bv[4 * s + 3] = v.w;
        }
        // a thread's row i runs its columns forward for even i, backward
        // for odd, so that consecutive FMAs share an operand register
#pragma unroll
        for (int i = 0; i < kTM; ++i)
#pragma unroll
          for (int jj = 0; jj < kTN; ++jj) {
            const int j = i % 2 ? kTN - 1 - jj : jj;
            acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
          }
      }
      if constexpr (!kAmn)
        if (next && h < ra.kN)
          ra.store(h, as + st1 * kFK * kPA, tid);
      if constexpr (!kBmn)
        if (next && h < rb.kN)
          rb.store(h, bs + st1 * kFK * kPB, tid);
    }
  }
  cp_async_wait<0>();   // no copy in flight at exit (the last are empty)

  float* oe = out + static_cast<size_t>(e) * M * N;
#pragma unroll
  for (int i = 0; i < kTM; ++i) {
    const int m = m0 + am + i / 4 * (L::kWM / L::kSubM) + i % 4;
    if (m >= M) continue;
#pragma unroll
    for (int s = 0; s < L::kSubN; ++s) {
      const int n = n0 + bn + s * (L::kWN / L::kSubN);
      if (n < N)    // N is a multiple of 4: a float4 is all in or all out
        *reinterpret_cast<float4*>(oe + static_cast<size_t>(m) * N + n) =
            make_float4(acc[i][4 * s], acc[i][4 * s + 1], acc[i][4 * s + 2],
                        acc[i][4 * s + 3]);
    }
  }
}

// ------------------------------------------------ bf16: wgmma fed by TMA
constexpr int kBN = 128;                   // output columns of a block
constexpr int kBK = 64;                    // contraction step: 128 B of bf16
constexpr int kHalfB = kBK * 64 * 2;       // one 64 x 64 box of bf16
constexpr int kSwizzleAlign = 1024;        // 8 rows x 128 B swizzle atom

// Block layout for WG consumer warpgroups (64 rows of x each) and one
// producer warp after them. The ring holds 4 stages: 128 KB at WG = 2
// (one block an SM; 3 stages and two blocks an SM measured 14% slower on
// the Jamba prefill layer), 96 KB at WG = 1 (two blocks an SM).
template <int WG>
struct Tile {
  static constexpr int kStages = 4;
  static constexpr int kBM = 64 * WG;
  static constexpr int kBytesA = kBM * kBK * 2;
  static constexpr int kBytesB = 2 * kHalfB;
  static constexpr int kStage = kBytesA + kBytesB;
  static constexpr int kThreads = WG * 128 + 32;
  // stages, then kStages "full" and kStages "empty" barriers; slack to
  // align the first stage to the swizzle atom
  static constexpr int kSmem = kStages * kStage + 2 * kStages * 8 +
                               kSwizzleAlign;
  static_assert(kBytesA % kSwizzleAlign == 0 && kStage % kSwizzleAlign == 0,
                "tiles must start on a swizzle atom");
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar), "r"(bytes) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// One TMA load of a box at (c0, c1, c2), innermost first, into shared
// memory; completion is counted in bytes on `bar`.
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0),
        "r"(c1), "r"(c2)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets, each in 16-byte units.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo,
                                              uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

// Keeps the compiler from moving reads or writes of an accumulator
// register across the asynchronous wgmma that owns it.
__device__ __forceinline__ void fence_acc(float (&d)[64]) {
#pragma unroll
  for (int i = 0; i < 64; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[64] += A (64 x 16) x B (16 x 128), both from shared memory, f32
// accumulators. An operand is K-major (the contraction dim contiguous)
// unless its transpose bit, kTA or kTB, marks it MN-major. scale_d = 0
// overwrites d instead.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n128k16(float (&d)[64], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %67, %68;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
}

// out[e] (M x N) = A[e] (M x K) x B[e] (K x N) for one block's 64 * WG
// rows and 128 columns of one expert: the forward, out = x w (M = C, N =
// F, K = D). A = x [C,D] K-major (the contraction dim contiguous), one
// box of 64 (D) x 64 * WG rows (C); B = w [D,F] MN-major, two boxes of 64
// (F) x 64 rows (D), read through the transpose bit. TMA's zero fill pads
// a ragged M, N or K. In the K-major tile rows are 128 B, 8-row groups
// 1024 B apart (the descriptor's stride byte offset), and a k16 slice is
// 32 B further along the (swizzled) row. In the MN-major tile rows run
// along K: the leading byte offset is the step between 64-element (128
// B) chunks along N, the stride byte offset the step between 8-row
// groups along K, and a k16 slice is 16 rows (2 KB) further.
template <int WG>
__device__ __forceinline__ void grouped_wgmma(const CUtensorMap* map_a,
                                              const CUtensorMap* map_b,
                                              __nv_bfloat16* __restrict__ out,
                                              int M, int N, int K) {
  using L = Tile<WG>;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + kSwizzleAlign - 1) &
                        ~static_cast<uint32_t>(kSwizzleAlign - 1);
  const uint32_t bars = base + L::kStages * L::kStage;
  auto tile_a = [&](int s) { return base + s * L::kStage; };
  auto tile_b = [&](int s) { return base + s * L::kStage + L::kBytesA; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (L::kStages + s); };

  const int m0 = blockIdx.x * L::kBM;
  const int n0 = blockIdx.y * kBN;
  const int e = blockIdx.z;
  const int n_k = (K + kBK - 1) / kBK;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < L::kStages; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), WG * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == WG * 4) {                    // the producer warp
    if (lane == 0) {
      for (int k = 0; k < n_k; ++k) {
        const int s = k % L::kStages;
        if (k >= L::kStages) mbar_wait(empty(s), (k / L::kStages - 1) & 1);
        mbar_expect_tx(full(s), L::kStage);
        tma_load_3d(tile_a(s), map_a, full(s), k * kBK, m0, e);
        tma_load_3d(tile_b(s), map_b, full(s), n0, k * kBK, e);
        tma_load_3d(tile_b(s) + kHalfB, map_b, full(s), n0 + 64, k * kBK, e);
      }
    }
    return;
  }

  // Consumers: warpgroup g owns rows m0 + 64g .. m0 + 64g + 63.
  const int g = warp / 4;
  float acc[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = 0.f;
  for (int k = 0; k < n_k; ++k) {
    const int s = k % L::kStages;
    mbar_wait(full(s), (k / L::kStages) & 1);
    fence_acc(acc);
    asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      const uint64_t da =
          smem_desc(tile_a(s) + g * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t db = smem_desc(tile_b(s) + kk * 16 * 128, kHalfB, 1024);
      wgmma_m64n128k16<false, true>(acc, da, db, 1);
    }
    asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
    fence_acc(acc);
    // the previous step's products are done: release its stage
    asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
    fence_acc(acc);
    if (k > 0) mbar_arrive(empty((k - 1) % L::kStages));
  }
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
  fence_acc(acc);

  // Accumulator fragment of m64n128: register 4j + 2i + c holds row
  // 16 * (warp % 4) + lane / 4 + 8i, column 8j + 2 * (lane % 4) + c.
  const int row0 = m0 + g * 64 + 16 * (warp % 4) + lane / 4;
  __nv_bfloat16* oe = out + static_cast<size_t>(e) * M * N;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + 8 * i;
    if (row >= M) continue;
    __nv_bfloat16* orow = oe + static_cast<size_t>(row) * N;
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j) {
      const int col = n0 + 8 * j + 2 * (lane % 4);
      const float v0 = acc[4 * j + 2 * i], v1 = acc[4 * j + 2 * i + 1];
      if (col + 1 < N) {
        *reinterpret_cast<__nv_bfloat162*>(orow + col) =
            __floats2bfloat162_rn(v0, v1);
      } else if (col < N) {
        orow[col] = __float2bfloat16(v0);
      }
    }
  }
}

template <int WG>
__global__ void __launch_bounds__(Tile<WG>::kThreads)
moe_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w,
                      __nv_bfloat16* __restrict__ out, int C, int D, int F) {
  grouped_wgmma<WG>(&map_x, &map_w, out, C, F, D);
}

// One TMA store of a box from shared memory to (c0, c1, c2); TMA clips
// the part of the box past the tensor's edges. Completion is tracked by
// the issuing thread's bulk groups.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map,
                                             uint32_t src, int c0, int c1,
                                             int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group"
      " [%0, {%2, %3, %4}], [%1];"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(src), "r"(c0), "r"(c1),
        "r"(c2)
      : "memory");
}

// As tma_load_3d, with the box written to the same shared-memory offset
// in every CTA of the cluster named in `mask`, and its bytes counted on
// the barrier at `bar`'s offset in each of them.
__device__ __forceinline__ void tma_load_3d_multicast(uint32_t dst,
                                                      const CUtensorMap* map,
                                                      uint32_t bar,
                                                      uint16_t mask, int c0,
                                                      int c1, int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes.multicast::cluster [%0], [%1, {%4, %5, %6}], [%2], %3;"
      ::"r"(dst), "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "h"(mask),
        "r"(c0), "r"(c1), "r"(c2)
      : "memory");
}

// Arrives on the barrier at `bar`'s offset in CTA `cta` of the cluster
// (with the default release at CTA scope, as for a local arrival).
__device__ __forceinline__ void mbar_arrive_cta(uint32_t bar, uint32_t cta) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}"
      ::"r"(bar), "r"(cta) : "memory");
}

// This CTA's rank in its cluster, the cluster's index in the grid and the
// grid's number of clusters (clusters along x).
__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%cluster_ctarank;" : "=r"(v));
  return v;
}

__device__ __forceinline__ uint32_t cluster_index() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%clusterid.x;" : "=r"(v));
  return v;
}

__device__ __forceinline__ uint32_t cluster_count() {
  uint32_t v;
  asm volatile("mov.u32 %0, %%nclusterid.x;" : "=r"(v));
  return v;
}

// Every thread of every CTA in the cluster, with release and acquire.
__device__ __forceinline__ void cluster_sync() {
  asm volatile(
      "barrier.cluster.arrive.release.aligned;\n"
      "barrier.cluster.wait.acquire.aligned;" ::: "memory");
}

// fence_acc for the m64n256 accumulator.
__device__ __forceinline__ void fence_acc(float (&d)[128]) {
#pragma unroll
  for (int i = 0; i < 128; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// d[128] += A (64 x 16) x B (16 x 256), as wgmma_m64n128k16 with twice
// the columns. Fragment: register 4j + 2i + c holds row 16 * (warp % 4) +
// lane / 4 + 8i, column 8j + 2 * (lane % 4) + c, for j < 32.
template <int kTA, int kTB>
__device__ __forceinline__ void wgmma_m64n256k16(float (&d)[128], uint64_t a,
                                                 uint64_t b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %130, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63, "
      "%64, %65, %66, %67, %68, %69, %70, %71, "
      "%72, %73, %74, %75, %76, %77, %78, %79, "
      "%80, %81, %82, %83, %84, %85, %86, %87, "
      "%88, %89, %90, %91, %92, %93, %94, %95, "
      "%96, %97, %98, %99, %100, %101, %102, %103, "
      "%104, %105, %106, %107, %108, %109, %110, %111, "
      "%112, %113, %114, %115, %116, %117, %118, %119, "
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "%128, %129, p, 1, 1, %131, %132;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "l"(a), "l"(b), "r"(scale_d), "n"(kTA), "n"(kTB));
}

// ------------------------ bf16 backward: persistent, warp-specialised
// The layout of dx (kDw false) or dw (kDw true). A consumer warpgroup's
// output tile is kPM x kPN = 16,384 outputs, kSub wgmma row blocks of 64
// (m64nNk16, N = kPN), 128 f32 accumulators a thread: dx 64 x 256, dw
// 128 x 128 (the faster of the two for each on the card). For dw the two
// CTAs of a cluster take the two row tiles of a tile pair and share its
// B tile: each loads half of it and multicasts that half to both.
template <bool kDw>
struct Bwd {
  static constexpr int kPM = kDw ? 128 : 64;
  static constexpr int kPN = 16384 / kPM;
  static constexpr int kSub = kPM / 64;
  static constexpr int kCluster = kDw ? 2 : 1;
  static constexpr int kBytesA = kPM * kBK * 2;
  static constexpr int kBytesB = kPN * kBK * 2;
  static constexpr int kStage = kBytesA + kBytesB;   // 40 or 32 KB
  static constexpr int kOut = kPM * kPN * 2;         // one bf16 tile, 32 KB
  static constexpr int kColBox = kPM * 128;          // 64 columns of a tile
  // as many stages as fit beside two output tiles, the barriers and the
  // slack that aligns the ring to the swizzle atom: 4 or 5
  static constexpr int kStages =
      (232448 - 2 * kOut - kSwizzleAlign - 16 * 8) / kStage;
  // the ring, two output tiles, kStages "full" and "empty" barriers and
  // two "turn" barriers; slack to align to the swizzle atom
  static constexpr int kSmem =
      kStages * kStage + 2 * kOut + (2 * kStages + 2) * 8 + kSwizzleAlign;
  // row tiles of a raster band: 1,536 rows
  static constexpr int kBandM = 1536 / kPM;
  static_assert(kSmem <= 232448 && kStages >= 4 && 2 * kStages + 2 <= 16,
                "shared memory");
  static_assert(kStage % kSwizzleAlign == 0 && kBytesA % kSwizzleAlign == 0,
                "tiles must start on a swizzle atom");
  static_assert(kBandM % kCluster == 0, "a band holds whole tile pairs");
};
// consumer warpgroups 0 and 1, then the producer warpgroup
constexpr int kPThreads = 3 * 128;
// registers a thread after setmaxnreg: 2 x 128 x 232 + 128 x 40 = 64,512
// of the SM's 65,536, what 384 threads get at launch (168 each)
constexpr int kConsumerRegs = 232;
constexpr int kProducerRegs = 40;
static_assert(2 * 128 * kConsumerRegs + 128 * kProducerRegs <= 65536,
              "more registers than an SM has");

struct TileAt {
  int e, m0, n0;
};

// The expert, first row and first column of the tile that CTA `rank`
// takes of tile group t (kCluster row tiles of layout L), in an E x tpm x
// tn grid of groups: experts outermost; within an expert, bands of kBandM
// row tiles, and within a band the group's row varies fastest.
template <typename L>
__device__ __forceinline__ TileAt tile_at(int t, int tpm, int tn, int rank) {
  constexpr int kBand = L::kBandM / L::kCluster;
  const int e = t / (tpm * tn);
  int r = t - e * tpm * tn;
  const int band = r / (kBand * tn);
  r -= band * kBand * tn;
  const int rows = min(kBand, tpm - band * kBand);
  return {e, ((band * kBand + r % rows) * L::kCluster + rank) * L::kPM,
          (r / rows) * L::kPN};
}

__device__ __forceinline__ void named_sync(int id) {
  asm volatile("bar.sync %0, 128;" ::"r"(id) : "memory");
}

// d += A (64 x 16) x B (16 x N) for N = 128 or 256 by d's size.
template <int kT, int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N], uint64_t a, uint64_t b,
                                        int scale_d) {
  if constexpr (N == 64)
    wgmma_m64n128k16<kT, kT>(d, a, b, scale_d);
  else
    wgmma_m64n256k16<kT, kT>(d, a, b, scale_d);
}

// out[e] (M x N) = A[e] (M x K) x B[e] (K x N) for every expert, in
// persistent CTAs (clusters of kCluster) that walk the tile groups t =
// cluster, cluster + clusters, ... (tile_at):
//   * dx = dy w^T (M = C, N = D, K = F; kDw false): A = dy [C,F] K-major,
//     one box of 64 (F) x 64 rows (C); B = w [D,F] K-major, one box of 64
//     (F) x 256 rows (D);
//   * dw = x^T dy (M = D, N = F, K = C; kDw true): A = x [C,D] MN-major,
//     two boxes of 64 (D) x 64 rows (C), through the transpose bit; B =
//     dy [C,F] MN-major, two boxes of 64 (F) x 64 rows (C), one from each
//     CTA of the cluster.
// Descriptors as in grouped_wgmma. One producer thread a CTA fills the
// ring of kPStages stages in tile order without stopping between tiles:
// ring position p (stage p % kPStages, phase p / kPStages) counts k-steps
// over all the CTA's tiles, the same in every CTA of a cluster. A stage
// is full when its A and all of its B have landed; it is free again when
// the consuming warpgroup of every CTA of the cluster has released it
// (each warp arrives on the "empty" barrier of each), since each CTA's
// producer writes every CTA's copy of its share of B. Consumer warpgroup
// g takes the tiles 2j + g of its CTA, so its tile j starts at position
// (2j + g) * n_k. The two "turn" barriers let one warpgroup issue its
// products at a time, in tile order: g waits on turn[g] before its main
// loop and arrives on turn[g ^ 1] once its last wgmma is issued, then
// stores its tile while the other multiplies. The store: the fragments,
// rounded to bf16, into the warpgroup's own shared tile in TMA's 128-byte
// swizzle (conflict-free), then TMA stores of 64 columns x kPM rows,
// clipped at a ragged M or N. Each output element is one thread's sum
// over K in ascending order: no split-K and no atomics.
template <bool kDw>
__device__ __forceinline__ void persistent_bwd(const CUtensorMap* map_a,
                                               const CUtensorMap* map_b,
                                               const CUtensorMap* map_out,
                                               int E, int M, int N, int K) {
  using L = Bwd<kDw>;
  constexpr int kPM = L::kPM, kPN = L::kPN, kSub = L::kSub;
  constexpr int kCluster = L::kCluster, kPStages = L::kStages;
  constexpr int kPStage = L::kStage, kPBytesA = L::kBytesA;
  constexpr int kPBytesB = L::kBytesB;
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + kSwizzleAlign - 1) &
                        ~static_cast<uint32_t>(kSwizzleAlign - 1);
  const uint32_t staged = base + kPStages * kPStage;
  const uint32_t bars = staged + 2 * L::kOut;
  auto tile_a = [&](int s) { return base + s * kPStage; };
  auto tile_b = [&](int s) { return base + s * kPStage + kPBytesA; };
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kPStages + s); };
  auto turn = [&](int g) { return bars + 8 * (2 * kPStages + g); };

  const int tm = (M + kPM - 1) / kPM, tn = (N + kPN - 1) / kPN;
  const int tpm = (tm + kCluster - 1) / kCluster;
  const int groups = E * tpm * tn;
  const int n_k = (K + kBK - 1) / kBK;
  const int wg = threadIdx.x / 128;
  const int rank = static_cast<int>(cluster_rank());
  const int cluster = static_cast<int>(cluster_index());
  const int clusters = static_cast<int>(cluster_count());

  if (threadIdx.x == 0) {
    for (int s = 0; s < kPStages; ++s) {
      mbar_init(full(s), 1);
      // each consumer warp of each CTA
      mbar_init(empty(s), 4 * kCluster);
    }
    mbar_init(turn(0), 128);
    mbar_init(turn(1), 128);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  // every CTA's barriers are ready before any multicast or remote arrival
  cluster_sync();

  if (wg == 2) {                             // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;" ::"n"(kProducerRegs));
    if (threadIdx.x == 256) {
      int p = 0;
      for (int t = cluster; t < groups; t += clusters) {
        const TileAt at = tile_at<L>(t, tpm, tn, rank);
        for (int k = 0; k < n_k; ++k, ++p) {
          const int s = p % kPStages;
          if (p >= kPStages) mbar_wait(empty(s), (p / kPStages - 1) & 1);
          mbar_expect_tx(full(s), kPStage);
          // this CTA's share of B, into every CTA of the cluster
          auto load_b = [&](uint32_t dst, int c0, int c1) {
            if (kCluster == 1)
              tma_load_3d(dst, map_b, full(s), c0, c1, at.e);
            else
              tma_load_3d_multicast(dst, map_b, full(s), (1 << kCluster) - 1,
                                    c0, c1, at.e);
          };
          if (kDw) {
#pragma unroll
            for (int u = 0; u < kSub; ++u)
              tma_load_3d(tile_a(s) + u * kHalfB, map_a, full(s),
                          at.m0 + 64 * u, k * kBK, at.e);
            constexpr int kBoxes = kPN / 64 / kCluster;
#pragma unroll
            for (int h = 0; h < kBoxes; ++h)
              load_b(tile_b(s) + (rank * kBoxes + h) * kHalfB,
                     at.n0 + 64 * (rank * kBoxes + h), k * kBK);
          } else {
            tma_load_3d(tile_a(s), map_a, full(s), k * kBK, at.m0, at.e);
            load_b(tile_b(s) + rank * (kPBytesB / kCluster), k * kBK,
                   at.n0 + rank * (kPN / kCluster));
          }
        }
      }
      // Wait until every CTA has released every stage: after that no
      // arrival from another CTA reaches this one, which may exit.
      for (int i = 0; i < kPStages; ++i, ++p)
        if (p >= kPStages)
          mbar_wait(empty(p % kPStages), (p / kPStages - 1) & 1);
    }
  } else {                                   // consumer warpgroup g
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;" ::"n"(kConsumerRegs));
    const int g = wg, warp = (threadIdx.x / 32) % 4, lane = threadIdx.x % 32;
    const bool leader = threadIdx.x % 128 == 0;
    const uint32_t out = staged + g * L::kOut;
    // this warp's products from stage s are done: free it in every CTA
    auto release = [&](int s) {
      if (lane == 0) {
        mbar_arrive(empty(s));
        if (kCluster == 2) mbar_arrive_cta(empty(s), rank ^ 1);
      }
    };
    float acc[kSub][kPN / 2];
#pragma unroll
    for (int u = 0; u < kSub; ++u)
#pragma unroll
      for (int i = 0; i < kPN / 2; ++i) acc[u][i] = 0.f;
    int j = 0;
    for (int t = cluster + g * clusters; t < groups;
         t += 2 * clusters, ++j) {
      const TileAt at = tile_at<L>(t, tpm, tn, rank);
      // the other warpgroup has issued its previous tile's products
      mbar_wait(turn(g), (j & 1) ^ (g == 0));
      int p = (2 * j + g) * n_k;
      for (int k = 0; k < n_k; ++k, ++p) {
        const int s = p % kPStages;
        mbar_wait(full(s), (p / kPStages) & 1);
#pragma unroll
        for (int u = 0; u < kSub; ++u) fence_acc(acc[u]);
        asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t db =
              kDw ? smem_desc(tile_b(s) + kk * 16 * 128, kHalfB, 1024)
                  : smem_desc(tile_b(s) + kk * 32, 16, 1024);
#pragma unroll
          for (int u = 0; u < kSub; ++u) {
            const uint64_t da =
                kDw ? smem_desc(tile_a(s) + u * kHalfB + kk * 16 * 128,
                                kHalfB, 1024)
                    : smem_desc(tile_a(s) + u * 64 * 128 + kk * 32, 16,
                                1024);
            // the tile's first product overwrites the last tile's sums
            wgmma_n<kDw>(acc[u], da, db, k > 0 || kk > 0);
          }
        }
        asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
#pragma unroll
        for (int u = 0; u < kSub; ++u) fence_acc(acc[u]);
        // the previous step's products are done: release its stage
        asm volatile("wgmma.wait_group.sync.aligned 1;" ::: "memory");
#pragma unroll
        for (int u = 0; u < kSub; ++u) fence_acc(acc[u]);
        if (k > 0) release((p - 1) % kPStages);
      }
      mbar_arrive(turn(g ^ 1));
      asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
#pragma unroll
      for (int u = 0; u < kSub; ++u) fence_acc(acc[u]);
      release((p - 1) % kPStages);

      // the store: this warpgroup's previous TMA store has read its tile
      if (leader) asm volatile("cp.async.bulk.wait_group.read 0;" ::: "memory");
      named_sync(1 + g);
      // Fragment of row block u: register 4j + 2i + c holds row 64u +
      // 16 * warp + lane / 4 + 8i (so row % 8 == lane / 4), column 8j +
      // 2 * (lane % 4) + c. Column chunk j of 16 bytes lands in 64-column
      // box j / 8, at chunk (j % 8) ^ (row % 8) of its 128-byte row.
#pragma unroll
      for (int u = 0; u < kSub; ++u) {
        const int r = 64 * u + 16 * warp + lane / 4;
#pragma unroll
        for (int jj = 0; jj < kPN / 8; ++jj) {
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            const __nv_bfloat162 v = __floats2bfloat162_rn(
                acc[u][4 * jj + 2 * i], acc[u][4 * jj + 2 * i + 1]);
            const uint32_t addr = out + (jj / 8) * L::kColBox +
                                  (r + 8 * i) * 128 +
                                  (((jj % 8) ^ (lane / 4)) << 4) +
                                  4 * (lane % 4);
            asm volatile("st.shared.b32 [%0], %1;" ::"r"(addr),
                         "r"(*reinterpret_cast<const uint32_t*>(&v))
                         : "memory");
          }
        }
      }
      asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
      named_sync(1 + g);
      // a group's last row tile past a ragged M has nothing to store
      if (leader && at.m0 < M) {
#pragma unroll
        for (int h = 0; h < kPN / 64; ++h)
          if (at.n0 + 64 * h < N)
            tma_store_3d(map_out, out + h * L::kColBox, at.n0 + 64 * h,
                         at.m0, at.e);
      }
      if (leader) asm volatile("cp.async.bulk.commit_group;" ::: "memory");
    }
    if (leader) asm volatile("cp.async.bulk.wait_group 0;" ::: "memory");
  }
}

// One kernel name for each product, so that a profile tells them apart.
__global__ void __launch_bounds__(kPThreads, 1)
moe_gemm_dx_wgmma_kernel(const __grid_constant__ CUtensorMap map_dy,
                         const __grid_constant__ CUtensorMap map_w,
                         const __grid_constant__ CUtensorMap map_dx, int E,
                         int C, int D, int F) {
  persistent_bwd<false>(&map_dy, &map_w, &map_dx, E, C, D, F);
}

__global__ void __cluster_dims__(Bwd<true>::kCluster, 1, 1)
__launch_bounds__(kPThreads, 1)
moe_gemm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_dy,
                         const __grid_constant__ CUtensorMap map_dw, int E,
                         int C, int D, int F) {
  persistent_bwd<true>(&map_x, &map_dy, &map_dw, E, D, F, C);
}

// ------------------------------------------------------- host side
constexpr int kErrLayout = -1;    // d or f not 16-byte rows, or unaligned
constexpr int kErrEntry = -2;     // cuTensorMapEncodeTiled not found
constexpr int kErrTensorMap = -3; // cuTensorMapEncodeTiled refused a map
constexpr int kErrTiles = -4;     // more tiles than an int counts

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up through the CUDA runtime, so that the
// library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err != cudaSuccess || q != cudaDriverEntryPointSuccess) return nullptr;
    fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A 3-D bf16 tensor map over [E, rows, cols] (cols contiguous) with
// boxes of box_cols x box_rows x 1 and the 128-byte swizzle; reads past
// an edge fill zeros.
int last_map_error = 0;  // the CUresult of the last refused map

bool make_map(EncodeTiled enc, CUtensorMap* map, const void* ptr, int E,
              int rows, int cols, int box_rows, int box_cols) {
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows),
                              static_cast<cuuint64_t>(E)};
  const cuuint64_t strides[2] = {static_cast<cuuint64_t>(cols) * 2,
                                 static_cast<cuuint64_t>(rows) * cols * 2};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  const CUresult res = enc(
      map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3, const_cast<void*>(ptr), dims,
      strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  if (res != CUDA_SUCCESS) last_map_error = static_cast<int>(res);
  return res == CUDA_SUCCESS;
}

// One launch of the forward's wgmma kernel on x [E,C,D] and w [E,D,F].
// The tensor maps' boxes are those grouped_wgmma loads; the grid covers
// the output's [C, F] tiles and the experts.
template <int WG>
int launch_wgmma(const void* x, const void* w, void* out, int E, int C,
                 int D, int F, cudaStream_t stream) {
  using L = Tile<WG>;
  // A runtime-API call before cuTensorMapEncodeTiled: it makes the
  // device's primary context current on this thread (autograd runs the
  // backward on a thread of its own, where the encoder refused the maps
  // without it).
  const cudaError_t err = cudaFuncSetAttribute(
      moe_gemm_wgmma_kernel<WG>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kErrEntry;
  CUtensorMap map_x, map_w;
  if (!(make_map(enc, &map_x, x, E, C, D, L::kBM, kBK) &&
        make_map(enc, &map_w, w, E, D, F, kBK, 64)))
    return kErrTensorMap;
  const dim3 grid((C + L::kBM - 1) / L::kBM, (F + kBN - 1) / kBN, E);
  moe_gemm_wgmma_kernel<WG><<<grid, L::kThreads, L::kSmem, stream>>>(
      map_x, map_w, static_cast<__nv_bfloat16*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

constexpr int kMaxDevices = 64;

// The clusters of a backward wgmma kernel that the current device runs
// at once (one CTA an SM by its shared memory; for dw, pairs of SMs that
// can host a cluster), found on the first launch on each device.
template <bool kDw>
cudaError_t resident_clusters(int dev, int* resident) {
  using L = Bwd<kDw>;
  static std::atomic<int> known[kMaxDevices];   // 0 until found
  if (dev < kMaxDevices) {
    *resident = known[dev].load(std::memory_order_acquire);
    if (*resident > 0) return cudaSuccess;
  }
  int sms = 0;
  cudaError_t err =
      cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (L::kCluster == 1) {
    *resident = sms;
  } else if (err == cudaSuccess) {
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(sms / L::kCluster * L::kCluster);
    cfg.blockDim = dim3(kPThreads);
    cfg.dynamicSmemBytes = L::kSmem;
    err = cudaOccupancyMaxActiveClusters(
        resident, kDw ? moe_gemm_dw_wgmma_kernel : moe_gemm_dx_wgmma_kernel,
        &cfg);
  }
  if (err != cudaSuccess) return err;
  if (*resident < 1) return cudaErrorInvalidConfiguration;
  if (dev < kMaxDevices) known[dev].store(*resident, std::memory_order_release);
  return cudaSuccess;
}

// The grid (in blocks) of a backward wgmma kernel for dx (M = C, N = D)
// or, kDw, dw (M = D, N = F): one cluster for each cluster the card runs
// at once, or one a tile pair where there are fewer. Returns 0 or an
// error code.
template <bool kDw>
int bwd_grid(int E, int C, int D, int F, int* grid) {
  using L = Bwd<kDw>;
  // A runtime-API call before cuTensorMapEncodeTiled, as in launch_wgmma;
  // it also sets the attribute that resident_clusters' query needs
  cudaError_t err = cudaFuncSetAttribute(
      kDw ? moe_gemm_dw_wgmma_kernel : moe_gemm_dx_wgmma_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  int dev = 0, resident = 0;
  if (err == cudaSuccess) err = cudaGetDevice(&dev);
  if (err == cudaSuccess) err = resident_clusters<kDw>(dev, &resident);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int M = kDw ? D : C, N = kDw ? F : D;
  const int tm = (M + L::kPM - 1) / L::kPM;
  const long long groups = static_cast<long long>(E) *
                           ((tm + L::kCluster - 1) / L::kCluster) *
                           ((N + L::kPN - 1) / L::kPN);
  if (groups > INT_MAX / 2) return kErrTiles;
  *grid = static_cast<int>(groups < resident ? groups : resident) *
          L::kCluster;
  return 0;
}

// One launch of a backward wgmma kernel: dx from (dy, w) or, kDw, dw
// from (x, dy), with x [E,C,D], w [E,D,F] and dy [E,C,F]. The tensor
// maps' boxes are those persistent_bwd loads and stores.
template <bool kDw>
int launch_bwd_wgmma(const void* a, const void* b, void* out, int E, int C,
                     int D, int F, cudaStream_t stream) {
  int grid = 0;
  const int err = bwd_grid<kDw>(E, C, D, F, &grid);
  if (err != 0) return err;
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kErrEntry;
  CUtensorMap map_a, map_b, map_out;
  const bool ok =
      kDw ? make_map(enc, &map_a, a, E, C, D, kBK, 64) &&
                make_map(enc, &map_b, b, E, C, F, kBK, 64) &&
                make_map(enc, &map_out, out, E, D, F, Bwd<true>::kPM, 64)
          : make_map(enc, &map_a, a, E, C, F, Bwd<false>::kPM, kBK) &&
                make_map(enc, &map_b, b, E, D, F,
                         Bwd<false>::kPN / Bwd<false>::kCluster, kBK) &&
                make_map(enc, &map_out, out, E, C, D, Bwd<false>::kPM, 64);
  if (!ok) return kErrTensorMap;
  const auto kernel =
      kDw ? moe_gemm_dw_wgmma_kernel : moe_gemm_dx_wgmma_kernel;
  kernel<<<grid, kPThreads, Bwd<kDw>::kSmem, stream>>>(map_a, map_b, map_out,
                                                     E, C, D, F);
  return static_cast<int>(cudaGetLastError());
}

// Rows a multiple of `align` elements (16 bytes) and 16-byte-aligned
// operands and output: what TMA (bf16) and cp.async and float4 (f32) need.
bool layout_ok(const void* a, const void* b, const void* out, int D, int F,
               int align) {
  return D % align == 0 && F % align == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
           reinterpret_cast<uintptr_t>(out)) & 15) == 0;
}

// One launch of moe_gemm_f32_kernel: out[e] (M x N) = A[e] x B[e] over K.
template <int kRows, bool kAmn, bool kBmn>
int launch_f32(const void* a, const void* b, void* out, int E, int M, int N,
               int K, cudaStream_t stream) {
  using L = F32Tile<kRows>;
  const dim3 grid((M + L::kBM - 1) / L::kBM, (N + L::kBN - 1) / L::kBN, E);
  moe_gemm_f32_kernel<kRows, kAmn, kBmn>
      <<<grid, L::kThreads, f32_smem_bytes<kRows>(), stream>>>(
          static_cast<const float*>(a), static_cast<const float*>(b),
          static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each launches one kernel on `stream`
// and returns cudaGetLastError() after the launch (0 = cudaSuccess), or
// one of the negative codes above; the launch is asynchronous. Every
// entry needs d and f multiples of 16 bytes (8 bf16, 4 f32 elements) and
// 16-byte-aligned operands and output.
extern "C" int moe_gemm_bf16(const void* x, const void* w, void* out, int E,
                             int C, int D, int F, void* stream) {
  if (!layout_ok(x, w, out, D, F, 8)) return kErrLayout;
  const auto s = static_cast<cudaStream_t>(stream);
  return C >= 128 ? launch_wgmma<2>(x, w, out, E, C, D, F, s)
                  : launch_wgmma<1>(x, w, out, E, C, D, F, s);
}

// The f32 forward in 128 x 128 output tiles.
extern "C" int moe_gemm_f32(const void* x, const void* w, void* out, int E,
                            int C, int D, int F, void* stream) {
  if (!layout_ok(x, w, out, D, F, 4)) return kErrLayout;
  return launch_f32<128, false, true>(x, w, out, E, C, F, D,
                                      static_cast<cudaStream_t>(stream));
}

// The f32 forward in 16 x 256 output tiles, for few rows an expert
// (decode): the same sums in the same order as moe_gemm_f32.
extern "C" int moe_gemm_f32_narrow(const void* x, const void* w, void* out,
                                   int E, int C, int D, int F,
                                   void* stream) {
  if (!layout_ok(x, w, out, D, F, 4)) return kErrLayout;
  return launch_f32<16, false, true>(x, w, out, E, C, F, D,
                                     static_cast<cudaStream_t>(stream));
}

// The backward, for the forward's x [E,C,D], w [E,D,F] and the output
// gradient dy [E,C,F]: dx [E,C,D] = dy w^T and dw [E,D,F] = x^T dy.
extern "C" int moe_gemm_bwd_dx_bf16(const void* dy, const void* w, void* dx,
                                    int E, int C, int D, int F,
                                    void* stream) {
  if (!layout_ok(dy, w, dx, D, F, 8)) return kErrLayout;
  return launch_bwd_wgmma<false>(dy, w, dx, E, C, D, F,
                                 static_cast<cudaStream_t>(stream));
}

extern "C" int moe_gemm_bwd_dw_bf16(const void* x, const void* dy, void* dw,
                                    int E, int C, int D, int F,
                                    void* stream) {
  if (!layout_ok(x, dy, dw, D, F, 8)) return kErrLayout;
  return launch_bwd_wgmma<true>(x, dy, dw, E, C, D, F,
                                static_cast<cudaStream_t>(stream));
}

extern "C" int moe_gemm_bwd_dx_f32(const void* dy, const void* w, void* dx,
                                   int E, int C, int D, int F, void* stream) {
  if (!layout_ok(dy, w, dx, D, F, 4)) return kErrLayout;
  return launch_f32<128, false, false>(dy, w, dx, E, C, D, F,
                                       static_cast<cudaStream_t>(stream));
}

extern "C" int moe_gemm_bwd_dw_f32(const void* x, const void* dy, void* dw,
                                   int E, int C, int D, int F, void* stream) {
  if (!layout_ok(x, dy, dw, D, F, 4)) return kErrLayout;
  return launch_f32<128, true, true>(x, dy, dw, E, D, F, C,
                                     static_cast<cudaStream_t>(stream));
}

extern "C" const char* moe_gemm_error_string(int code) {
  switch (code) {
    case kErrLayout:
      return "moe_gemm needs d and f multiples of 16 bytes (8 bf16, 4 f32 "
             "elements) and 16-byte-aligned operands";
    case kErrEntry:
      return "cuTensorMapEncodeTiled not found";
    case kErrTiles:
      return "bf16 moe_gemm backward: more output tiles than it counts";
    case kErrTensorMap: {
      static char msg[64];
      snprintf(msg, sizeof msg,
               "cuTensorMapEncodeTiled refused a tensor map (CUresult %d)",
               last_map_error);
      return msg;
    }
  }
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
