// Grouped (per-expert) matmul for Hopper: out[e] = x[e] @ w[e].
//
// Replaces the TPU kernel repro/kernels/moe_gemm.py:_moe_gemm_kernel
// (launched by moe_gemm_pallas). Plain version:
// repro_torch/kernels/ref.py:moe_gemm_ref. Wrapper, checks and launch
// count: repro_torch/kernels/moe_gemm.py.
//
// x [E,C,D], w [E,D,F], out [E,C,F], row-major and contiguous; bf16 or
// f32 in and out, f32 accumulation, output rounded once at the end.
//
// Bound. On the serving path C is small: 4 batch slots x capacity 4 = 16
// rows per expert against a 2048x1408 expert matrix. That is 2*C = 32
// flops per weight element read, 16 flops per byte in bf16, far below
// the ~295 flops per byte at which the H100's bf16 tensor cores become
// the limit, so the weights' bytes bound the kernel: a gate/up launch
// reads 64*2048*1408*2 B = 369 MB of weights plus ~4 MB of activations
// and writes ~3 MB, about 0.11 ms at the H100 SXM's 3.35 TB/s; the 72
// launches of one decode step (3 per MoE layer, 24 layers) about 8 ms.
//
// Design: read each weight element once per launch.
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
//     the block, and each tile reads the expert's weights again: right
//     while C is small; a tensor-core kernel is the fix for large C.
// On the TPU the contraction was a sequential grid axis carrying an f32
// VMEM accumulator. Blocks here run in no order, so the contraction is
// a loop inside the block. The products run on the CUDA cores in f32;
// at 16 rows their 67 TFLOP/s (H100 SXM) take about as long as the
// bytes do. wgmma, TMA and tensor cores are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

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

template <typename T>
int launch(const void* x, const void* w, void* out, int E, int C, int D,
           int F, void* stream) {
  const dim3 grid((F + kTileF - 1) / kTileF, E);
  const dim3 block(kLanes, kWarps);
  moe_gemm_kernel<T><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(x), static_cast<const T*>(w), static_cast<T*>(out),
      C, D, F);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each returns cudaGetLastError() after
// the launch (0 = cudaSuccess); the launch is asynchronous on `stream`.
extern "C" int moe_gemm_bf16(const void* x, const void* w, void* out, int E,
                             int C, int D, int F, void* stream) {
  return launch<__nv_bfloat16>(x, w, out, E, C, D, F, stream);
}

extern "C" int moe_gemm_f32(const void* x, const void* w, void* out, int E,
                            int C, int D, int F, void* stream) {
  return launch<float>(x, w, out, E, C, D, F, stream);
}

extern "C" const char* moe_gemm_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
