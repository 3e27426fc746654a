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
//   * f32: moe_gemm_kernel<float>, on the CUDA cores. Tensor cores would
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
// f32 design (unchanged from the first port): read each weight element
// once per 16-row tile of x, on the CUDA cores.
//   * One block per (expert, tile of 64 output columns).
//   * The block stages a tile of x (16 rows x 128 of the contraction
//     dim) in shared memory as f32; threads read it by broadcast.
//   * The 32 lanes of a warp own neighbouring f columns (two each, 32
//     apart), so every load of a w row is one coalesced transaction.
//     Each thread keeps 16 rows x 2 columns of f32 sums in registers.
//   * The block's 8 warps split the contraction dim (rows d of w) and
//     add their partial sums through shared memory at the end, so no
//     weight element is loaded by two threads.
//   * Ragged C, D and F are masked. C above 16 loops over row tiles in
//     the block, and each tile reads the expert's weights again.
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
// Bound: each is one more grouped GEMM of the forward's 2*E*C*D*F flops.
// At the MoE training shape (E = 64, C = 640, d = 2048, f = 1408) that is
// 0.236 TFLOP a call, 0.239 ms at 989 bf16 TFLOP/s, against 0.65 GB of
// operands (0.195 ms at 3.35 TB/s): the products bound it, close to
// balance. Designs, one launch a gradient, f32 sums rounded once:
//   * bf16: moe_gemm_dx_wgmma_kernel and moe_gemm_dw_wgmma_kernel, the
//     forward's producer warp, TMA ring and wgmma consumers with the
//     operands' major-ness flipped (see grouped_wgmma). dx tiles (C, D) and
//     loops over F; dw tiles (D, F) and loops over all of C inside the
//     block. No split-K and no atomics: each output element is one
//     thread's sum in a fixed order, so two calls agree bit for bit, and
//     an expert that no token reaches (all its rows zero) gets exact zeros
//     in dw. dw's K = C is short (10 steps of 64 at C = 640), so filling
//     and draining the ring costs a larger share than in the forward.
//   * f32: moe_gemm_bwd_kernel<kAmn, kBmn>, a tiled CUDA-core GEMM with
//     the operand layouts as template parameters (see there).

#include <cuda.h>  // CUtensorMap and its types; no -lcuda needed
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <cstdio>

namespace {

constexpr int kLanes = 32;                     // threads along f (a warp)
constexpr int kColsPerLane = 2;                // f columns per thread
constexpr int kTileF = kLanes * kColsPerLane;  // f columns per block
constexpr int kWarps = 8;                      // split of the contraction
constexpr int kThreads = kLanes * kWarps;
constexpr int kTileC = 16;                     // x rows per pass
constexpr int kTileD = 128;                    // contraction chunk in smem
constexpr int kRowsPerStep = 4;                // d rows a warp takes a step

static_assert(kTileD % (kWarps * kRowsPerStep) == 0, "chunk split");

// The CUDA-core kernel is instantiated for f32 only; bf16 takes the
// tensor-core kernel below.
__device__ __forceinline__ float to_f32(float v) { return v; }

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) { return v; }

template <typename T>
__global__ void __launch_bounds__(kThreads)
moe_gemm_kernel(const T* __restrict__ x, const T* __restrict__ w,
                T* __restrict__ out, int C, int D, int F) {
  __shared__ __align__(16) float xs[kTileC][kTileD];
  __shared__ float part[kWarps][kTileC][kTileF];

  const int lane = threadIdx.x;
  const int warp = threadIdx.y;
  const int tid = warp * kLanes + lane;
  const int e = blockIdx.y;
  const int f0 = blockIdx.x * kTileF;

  const T* xe = x + static_cast<size_t>(e) * C * D;
  const T* we = w + static_cast<size_t>(e) * D * F;
  T* oe = out + static_cast<size_t>(e) * C * F;

  bool f_ok[kColsPerLane];
#pragma unroll
  for (int j = 0; j < kColsPerLane; ++j) f_ok[j] = f0 + lane + j * kLanes < F;

  for (int c0 = 0; c0 < C; c0 += kTileC) {
    float acc[kTileC][kColsPerLane];
#pragma unroll
    for (int c = 0; c < kTileC; ++c)
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j) acc[c][j] = 0.f;

    for (int d0 = 0; d0 < D; d0 += kTileD) {
      __syncthreads();  // every thread is done with the previous chunk
      for (int i = tid; i < kTileC * kTileD; i += kThreads) {
        const int c = i / kTileD, dd = i % kTileD;
        xs[c][dd] = (c0 + c < C && d0 + dd < D)
                        ? to_f32(xe[static_cast<size_t>(c0 + c) * D + d0 + dd])
                        : 0.f;
      }
      __syncthreads();
      const int dn = min(kTileD, D - d0);
      for (int dd = warp * kRowsPerStep; dd < dn;
           dd += kWarps * kRowsPerStep) {
        float wv[kRowsPerStep][kColsPerLane];
#pragma unroll
        for (int r = 0; r < kRowsPerStep; ++r) {
          const bool d_ok = dd + r < dn;
          const T* wrow = we + static_cast<size_t>(d0 + dd + r) * F + f0 + lane;
#pragma unroll
          for (int j = 0; j < kColsPerLane; ++j)
            wv[r][j] = (d_ok && f_ok[j]) ? to_f32(wrow[j * kLanes]) : 0.f;
        }
#pragma unroll
        for (int c = 0; c < kTileC; ++c) {
          // rows past D were staged as 0, so the masked w values meet 0s
          const float4 xv = *reinterpret_cast<const float4*>(&xs[c][dd]);
#pragma unroll
          for (int j = 0; j < kColsPerLane; ++j) {
            acc[c][j] += xv.x * wv[0][j];
            acc[c][j] += xv.y * wv[1][j];
            acc[c][j] += xv.z * wv[2][j];
            acc[c][j] += xv.w * wv[3][j];
          }
        }
      }
    }
    // Sum the warps' partials. The next row tile writes `part` only after
    // the barrier at the top of its first contraction chunk.
#pragma unroll
    for (int c = 0; c < kTileC; ++c)
#pragma unroll
      for (int j = 0; j < kColsPerLane; ++j)
        part[warp][c][lane + j * kLanes] = acc[c][j];
    __syncthreads();
    for (int i = tid; i < kTileC * kTileF; i += kThreads) {
      const int c = i / kTileF, fl = i % kTileF;
      if (c0 + c < C && f0 + fl < F) {
        float s = 0.f;
#pragma unroll
        for (int k = 0; k < kWarps; ++k) s += part[k][c][fl];
        oe[static_cast<size_t>(c0 + c) * F + f0 + fl] = from_f32<T>(s);
      }
    }
  }
}

// f32 backward on the CUDA cores: out[e] (M x N) = A[e] (M x K) x B[e]
// (K x N), for dx = dy w^T (A = dy [C,f], B = w [d,f] read as [N,K]) and
// dw = x^T dy (A = x [C,d] read as [K,M], B = dy [C,f]). A is stored
// [M][K] or, kAmn, [K][M]; B is stored [N][K] or, kBmn, [K][N].
//   * One block per (64 x 64 output tile, expert); 16 x 16 threads, each
//     4 x 4 outputs 16 apart, so a warp's shared-memory reads are
//     broadcasts or consecutive words.
//   * The contraction runs in chunks of 16 staged in shared memory as
//     [k][m] and [k][n], rows padded to 65 words, so that a warp storing
//     a K-major operand (k varying fastest) conflicts at most two ways.
//     Global loads run along each operand's contiguous dim, so they
//     coalesce in both layouts.
//   * Every output is one thread's sum in a fixed k order: no atomics, two
//     calls agree bit for bit, and an expert whose rows are all zero gets
//     exact zeros.
constexpr int kGT = 64;                        // output tile, rows and cols
constexpr int kGK = 16;                        // contraction chunk
constexpr int kGThreads = 256;

template <bool kAmn, bool kBmn>
__global__ void __launch_bounds__(kGThreads)
moe_gemm_bwd_kernel(const float* __restrict__ a, const float* __restrict__ b,
                    float* __restrict__ out, int M, int N, int K) {
  __shared__ float as[kGK][kGT + 1];
  __shared__ float bs[kGK][kGT + 1];
  const int tx = threadIdx.x % 16, ty = threadIdx.x / 16;
  const int m0 = blockIdx.x * kGT, n0 = blockIdx.y * kGT, e = blockIdx.z;
  const float* ae = a + static_cast<size_t>(e) * M * K;
  const float* be = b + static_cast<size_t>(e) * K * N;

  float acc[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += kGK) {
    __syncthreads();  // every thread is done with the previous chunk
    for (int i = threadIdx.x; i < kGK * kGT; i += kGThreads) {
      const int kk = kAmn ? i / kGT : i % kGK;
      const int mm = kAmn ? i % kGT : i / kGK;
      const int m = m0 + mm, k = k0 + kk;
      as[kk][mm] = (m < M && k < K)
                       ? ae[kAmn ? static_cast<size_t>(k) * M + m
                                 : static_cast<size_t>(m) * K + k]
                       : 0.f;
    }
    for (int i = threadIdx.x; i < kGK * kGT; i += kGThreads) {
      const int kk = kBmn ? i / kGT : i % kGK;
      const int nn = kBmn ? i % kGT : i / kGK;
      const int n = n0 + nn, k = k0 + kk;
      bs[kk][nn] = (n < N && k < K)
                       ? be[kBmn ? static_cast<size_t>(k) * N + n
                                 : static_cast<size_t>(n) * K + k]
                       : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < kGK; ++kk) {
      float av[4], bv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) av[i] = as[kk][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < 4; ++j) bv[j] = bs[kk][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = fmaf(av[i], bv[j], acc[i][j]);
    }
  }
  float* oe = out + static_cast<size_t>(e) * M * N;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int m = m0 + ty + 16 * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int n = n0 + tx + 16 * j;
      if (n < N) oe[static_cast<size_t>(m) * N + n] = acc[i][j];
    }
  }
}

// ------------------------------------------------ bf16: wgmma fed by TMA
constexpr int kBN = 128;                   // output columns of a block
constexpr int kBK = 64;                    // contraction step: 128 B of bf16
constexpr int kHalfB = kBK * 64 * 2;       // one 64-column half of a w tile
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
// rows and 128 columns of one expert, with each operand's major-ness a
// template parameter (K-major: the contraction dim contiguous):
//   * forward, out = x w (M = C, N = F, K = D): A = x [C,D] K-major, one
//     box of 64 (D) x 64 * WG rows (C); B = w [D,F] MN-major, two boxes of
//     64 (F) x 64 rows (D), read through the transpose bit;
//   * dx = dy w^T (M = C, N = D, K = F): A = dy [C,F] K-major as x above;
//     B = w [D,F] K-major, one box of 64 (F) x 128 rows (D);
//   * dw = x^T dy (M = D, N = F, K = C): A = x [C,D] MN-major, one box of
//     64 (D) x 64 rows (C) a warpgroup, through the transpose bit; B = dy
//     [C,F] MN-major as w in the forward.
// TMA's zero fill pads a ragged M, N or K (a ragged C in dw: in both
// operands). In a K-major tile rows are 128 B, 8-row groups 1024 B apart
// (the descriptor's stride byte offset), and a k16 slice is 32 B further
// along the (swizzled) row. In an MN-major tile rows run along K: the
// leading byte offset is the step between 64-element (128 B) chunks along
// M or N, the stride byte offset the step between 8-row groups along K,
// and a k16 slice is 16 rows (2 KB) further.
template <int WG, bool kAmn, bool kBmn>
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
        if (kAmn) {
#pragma unroll
          for (int h = 0; h < WG; ++h)
            tma_load_3d(tile_a(s) + h * kHalfB, map_a, full(s), m0 + 64 * h,
                        k * kBK, e);
        } else {
          tma_load_3d(tile_a(s), map_a, full(s), k * kBK, m0, e);
        }
        if (kBmn) {
          tma_load_3d(tile_b(s), map_b, full(s), n0, k * kBK, e);
          tma_load_3d(tile_b(s) + kHalfB, map_b, full(s), n0 + 64, k * kBK,
                      e);
        } else {
          tma_load_3d(tile_b(s), map_b, full(s), k * kBK, n0, e);
        }
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
          kAmn ? smem_desc(tile_a(s) + g * kHalfB + kk * 16 * 128, kHalfB,
                           1024)
               : smem_desc(tile_a(s) + g * 64 * 128 + kk * 32, 16, 1024);
      const uint64_t db =
          kBmn ? smem_desc(tile_b(s) + kk * 16 * 128, kHalfB, 1024)
               : smem_desc(tile_b(s) + kk * 32, 16, 1024);
      wgmma_m64n128k16<kAmn, kBmn>(acc, da, db, 1);
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

// One kernel name for each product, so that a profile tells them apart.
template <int WG>
__global__ void __launch_bounds__(Tile<WG>::kThreads)
moe_gemm_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                      const __grid_constant__ CUtensorMap map_w,
                      __nv_bfloat16* __restrict__ out, int C, int D, int F) {
  grouped_wgmma<WG, false, true>(&map_x, &map_w, out, C, F, D);
}

template <int WG>
__global__ void __launch_bounds__(Tile<WG>::kThreads)
moe_gemm_dx_wgmma_kernel(const __grid_constant__ CUtensorMap map_dy,
                         const __grid_constant__ CUtensorMap map_w,
                         __nv_bfloat16* __restrict__ dx, int C, int D,
                         int F) {
  grouped_wgmma<WG, false, false>(&map_dy, &map_w, dx, C, D, F);
}

template <int WG>
__global__ void __launch_bounds__(Tile<WG>::kThreads)
moe_gemm_dw_wgmma_kernel(const __grid_constant__ CUtensorMap map_x,
                         const __grid_constant__ CUtensorMap map_dy,
                         __nv_bfloat16* __restrict__ dw, int C, int D,
                         int F) {
  grouped_wgmma<WG, true, true>(&map_x, &map_dy, dw, D, F, C);
}

// ------------------------------------------------------- host side
constexpr int kErrLayout = -1;    // d or f not a multiple of 8, or unaligned
constexpr int kErrEntry = -2;     // cuTensorMapEncodeTiled not found
constexpr int kErrTensorMap = -3; // cuTensorMapEncodeTiled refused a map

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

enum class Product { kForward, kDx, kDw };

// One launch of the wgmma kernel of product P on its operands (a, b): the
// forward (x, w), dx (dy, w) or dw (x, dy), with x [E,C,D], w [E,D,F]
// and dy [E,C,F]. The tensor maps' boxes are those grouped_wgmma loads; the
// grid covers the output's [M, N] tiles and the experts.
template <int WG, Product P>
int launch_wgmma(const void* a, const void* b, void* out, int E, int C,
                 int D, int F, cudaStream_t stream) {
  using L = Tile<WG>;
  const auto kernel = P == Product::kForward ? moe_gemm_wgmma_kernel<WG>
                      : P == Product::kDx    ? moe_gemm_dx_wgmma_kernel<WG>
                                             : moe_gemm_dw_wgmma_kernel<WG>;
  // A runtime-API call before cuTensorMapEncodeTiled: it makes the
  // device's primary context current on this thread (autograd runs the
  // backward on a thread of its own, where the encoder refused the maps
  // without it).
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::kSmem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const EncodeTiled enc = encode_tiled();
  if (enc == nullptr) return kErrEntry;
  CUtensorMap map_a, map_b;
  bool ok;
  int M, N;
  if (P == Product::kForward) {
    ok = make_map(enc, &map_a, a, E, C, D, L::kBM, kBK) &&
         make_map(enc, &map_b, b, E, D, F, kBK, 64);
    M = C;
    N = F;
  } else if (P == Product::kDx) {
    ok = make_map(enc, &map_a, a, E, C, F, L::kBM, kBK) &&
         make_map(enc, &map_b, b, E, D, F, kBN, kBK);
    M = C;
    N = D;
  } else {
    ok = make_map(enc, &map_a, a, E, C, D, kBK, 64) &&
         make_map(enc, &map_b, b, E, C, F, kBK, 64);
    M = D;
    N = F;
  }
  if (!ok) return kErrTensorMap;
  const dim3 grid((M + L::kBM - 1) / L::kBM, (N + kBN - 1) / kBN, E);
  kernel<<<grid, L::kThreads, L::kSmem, stream>>>(
      map_a, map_b, static_cast<__nv_bfloat16*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

template <bool kDw>
int launch_bwd_f32(const void* a, const void* b, void* out, int E, int C,
                   int D, int F, cudaStream_t stream) {
  const int M = kDw ? D : C, N = kDw ? F : D, K = kDw ? C : F;
  const dim3 grid((M + kGT - 1) / kGT, (N + kGT - 1) / kGT, E);
  moe_gemm_bwd_kernel<kDw, kDw><<<grid, kGThreads, 0, stream>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<float*>(out), M, N, K);
  return static_cast<int>(cudaGetLastError());
}

bool bf16_layout_ok(const void* a, const void* b, int D, int F) {
  return D % 8 == 0 && F % 8 == 0 &&
         ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

int launch_f32(const void* x, const void* w, void* out, int E, int C, int D,
               int F, cudaStream_t stream) {
  const dim3 grid((F + kTileF - 1) / kTileF, E);
  const dim3 block(kLanes, kWarps);
  moe_gemm_kernel<float><<<grid, block, 0, stream>>>(
      static_cast<const float*>(x), static_cast<const float*>(w),
      static_cast<float*>(out), C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each launches one kernel on `stream`
// and returns cudaGetLastError() after the launch (0 = cudaSuccess), or
// one of the negative codes above; the launch is asynchronous.
// bf16 needs d and f multiples of 8 and 16-byte-aligned x and w.
extern "C" int moe_gemm_bf16(const void* x, const void* w, void* out, int E,
                             int C, int D, int F, void* stream) {
  if (!bf16_layout_ok(x, w, D, F)) return kErrLayout;
  const auto s = static_cast<cudaStream_t>(stream);
  constexpr Product P = Product::kForward;
  return C >= 128 ? launch_wgmma<2, P>(x, w, out, E, C, D, F, s)
                  : launch_wgmma<1, P>(x, w, out, E, C, D, F, s);
}

extern "C" int moe_gemm_f32(const void* x, const void* w, void* out, int E,
                            int C, int D, int F, void* stream) {
  return launch_f32(x, w, out, E, C, D, F, static_cast<cudaStream_t>(stream));
}

// The backward, for the forward's x [E,C,D], w [E,D,F] and the output
// gradient dy [E,C,F]: dx [E,C,D] = dy w^T and dw [E,D,F] = x^T dy.
extern "C" int moe_gemm_bwd_dx_bf16(const void* dy, const void* w, void* dx,
                                    int E, int C, int D, int F,
                                    void* stream) {
  if (!bf16_layout_ok(dy, w, D, F)) return kErrLayout;
  const auto s = static_cast<cudaStream_t>(stream);
  return C >= 128 ? launch_wgmma<2, Product::kDx>(dy, w, dx, E, C, D, F, s)
                  : launch_wgmma<1, Product::kDx>(dy, w, dx, E, C, D, F, s);
}

extern "C" int moe_gemm_bwd_dw_bf16(const void* x, const void* dy, void* dw,
                                    int E, int C, int D, int F,
                                    void* stream) {
  if (!bf16_layout_ok(x, dy, D, F)) return kErrLayout;
  const auto s = static_cast<cudaStream_t>(stream);
  return D >= 128 ? launch_wgmma<2, Product::kDw>(x, dy, dw, E, C, D, F, s)
                  : launch_wgmma<1, Product::kDw>(x, dy, dw, E, C, D, F, s);
}

extern "C" int moe_gemm_bwd_dx_f32(const void* dy, const void* w, void* dx,
                                   int E, int C, int D, int F, void* stream) {
  return launch_bwd_f32<false>(dy, w, dx, E, C, D, F,
                               static_cast<cudaStream_t>(stream));
}

extern "C" int moe_gemm_bwd_dw_f32(const void* x, const void* dy, void* dw,
                                   int E, int C, int D, int F, void* stream) {
  return launch_bwd_f32<true>(x, dy, dw, E, C, D, F,
                              static_cast<cudaStream_t>(stream));
}

extern "C" const char* moe_gemm_error_string(int code) {
  switch (code) {
    case kErrLayout:
      return "bf16 moe_gemm needs d and f multiples of 8 and 16-byte-aligned "
             "operands";
    case kErrEntry:
      return "cuTensorMapEncodeTiled not found";
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
