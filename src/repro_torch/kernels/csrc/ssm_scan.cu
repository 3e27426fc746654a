// Mamba's selective scan and the generic linear scan, for Hopper.
//
// Replaces the TPU kernels repro/kernels/ssm_scan.py:_sel_scan_kernel
// (launched by selective_scan_pallas) and _lin_scan_kernel (launched by
// ssm_scan_pallas). Plain versions: repro_torch/kernels/ref.py:
// selective_scan_ref and ssm_scan_ref. Wrapper, checks and launch counts:
// repro_torch/kernels/ssm_scan.py.
//
// Selective scan, for each batch row b, channel d and state n:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,  A = -exp(a_log)
//   y_t = sum_n h_t * C_t + D * x_t
// x, dt [B,S,D] and B, C [B,S,N] in bf16 or f32, read through their batch
// and time strides (unit stride along D or N: B and C are column slices of
// the x_proj output); a_log [D,N], D [D], h0 and h_last [B,D,N] in f32;
// y [B,S,D] contiguous, in x's dtype, rounded once. The state and all
// arithmetic are f32.
//
// Bound. On the Jamba prefill path (B=1, S=4096, D=8192, N=16, bf16) the
// scan must read x and dt and write y, 3 x 2 B x 33.5 M = 201 MB (B, C,
// a_log, D and h_last add 0.8 MB): 0.060 ms at the H100 SXM's 3.35 TB/s.
// It must also take B*S*D*N = 537 M exponentials; the SFU gives 16 a clock
// on each of the 132 SMs, 4.2 T/s at 1.98 GHz: 0.13 ms if every one runs
// there. That is an upper estimate of the floor: exp2 can also run on the
// FMA pipes as a range reduction and a polynomial (~5 instructions), as
// FlashAttention-3/4 split it. With the other f32 work (~6 flops per
// (t, d, n), 3.2 GFLOP at 67 TFLOP/s) sharing those pipes, the best split
// puts ~38% of the exponentials there: ~0.08 ms. The operations bind
// either way, above the bytes' 0.060 ms (arithmetic; chip_smoke.py
// computes all three from the card's clock).
//
// Design, simple and right first (no wgmma, TMA or chunked parallel scan):
//   * The TPU walked time as a sequential grid axis with the state in
//     VMEM scratch. Blocks here run in no order, so each block owns a set
//     of channels of one batch row and loops over all of time itself.
//   * One thread per (channel, state n): the NL = 8 (N <= 8) or 16
//     (N <= 16, Mamba's) lanes of a channel are neighbours in a warp, so a
//     block of 256 threads holds 256 / NL channels and B x D x NL threads
//     fill the card (131,072 at the path's shape, not the 8,192 of one
//     thread per channel). Lanes n >= N carry h = 0 and add nothing.
//   * Time goes in chunks of 32 steps. The block stages the chunk's x and
//     dt (coalesced along D) and B and C (shared by all its channels) in
//     shared memory as f32, and loads the next chunk into registers while
//     it computes this one.
//   * y_t needs a sum over the NL lanes of a channel. After NL steps each
//     lane holds NL products h_t * C_t; a transposing butterfly of NL - 1
//     shuffles leaves lane n with the sum for step n of the group (about
//     one shuffle per (t, d, n), not log2(NL)). The sums go to shared
//     memory and out as coalesced rows, with D * x added there.
//   * A ragged S and D are masked: steps past S are staged with dt = 0 and
//     x = 0, so exp(0) = 1 leaves h as it is; channels past D are computed
//     on zeros and never stored. Nothing asks S or D to divide a tile.
//   * exp(dt * A) is exp2(dt * A * log2(e)), one SFU op a step.
//
// Linear scan: h_t = a_t * h_{t-1} + bx_t over axis 1, a and bx [B,S,D]
// contiguous of one dtype, h0 [B,D] f32, every h_t out in that dtype. One
// thread per (b, d), coalesced along D; 16 steps of loads are issued
// before their 16 dependent FMAs. Bound: the bytes of a, bx and the
// output (no model calls it; ops.ssm_scan is its only entry point).

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// Arguments of a selective-scan launch; mirrored by ctypes.Structure in
// ssm_scan.py (pointers, then 64-bit strides, then ints).
struct SelScanArgs {
  const void* x;
  const void* dt;
  const float* a_log;
  const void* b;
  const void* c;
  const float* d;
  const float* h0;
  void* y;
  float* h_last;
  long long x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
  int B, S, D, N;
};

namespace {

constexpr int kThreads = 256;   // threads of a selective-scan block
constexpr int kChunk = 32;      // time steps staged per pass
constexpr int kLinThreads = 64;   // 128 blocks at D = 8192: one an SM
constexpr int kLinSteps = 16;   // linear scan: loads in flight per thread
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBadStateDim = 1000;   // N outside 1..16 (not a cudaError_t)

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

// Transposing butterfly over the NL lanes of a channel: at width W a lane
// keeps the half of its pairs (i, i + W) that its bit W selects and
// receives the other half from lane n ^ W. Slot i then stands for step
// i + (n & W) + the bits already fixed, so at the end v[0] of lane n is
// the sum over the NL lanes of their step-n values. A recursion on W, so
// that every index into v is a constant and v stays in registers.
template <int W, int NL>
__device__ __forceinline__ void butterfly(float (&v)[NL], int n) {
  if constexpr (W >= 1) {
    const bool upper = (n & W) != 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float send = upper ? v[i] : v[i + W];
      const float keep = upper ? v[i + W] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
    }
    butterfly<W / 2>(v, n);
  }
}

template <typename T, int NL>
__global__ void __launch_bounds__(kThreads)
sel_scan_kernel(const SelScanArgs p) {
  constexpr int CH = kThreads / NL;                      // channels a block
  constexpr int kLoadX = kChunk * CH / kThreads;         // x, dt per thread
  constexpr int kLoadB = (kChunk * NL + kThreads - 1) / kThreads;  // B, C
  static_assert(kChunk % NL == 0 && kChunk * CH % kThreads == 0, "tiles");

  __shared__ float2 s_xdt[kChunk][CH];        // (dt, x) of a step, channel
  __shared__ float2 s_bc[kChunk][NL];         // (B, C) of a step, state
  __shared__ float s_y[kChunk][CH + 1];       // sum_n h C; +1: fewer bank
                                              // conflicts on the column write
  __shared__ float s_d[CH];

  const int tid = threadIdx.x;
  const int n = tid % NL;
  const int ch = tid / NL;
  const int bi = blockIdx.y;
  const int d0 = blockIdx.x * CH;
  const int dd = d0 + ch;
  const int S = p.S, D = p.D, N = p.N;
  const bool live = dd < D && n < N;

  const T* x = static_cast<const T*>(p.x) + bi * p.x_sb;
  const T* dt = static_cast<const T*>(p.dt) + bi * p.dt_sb;
  const T* bm = static_cast<const T*>(p.b) + bi * p.b_sb;
  const T* cm = static_cast<const T*>(p.c) + bi * p.c_sb;
  T* y = static_cast<T*>(p.y) + static_cast<size_t>(bi) * S * D;
  const size_t h_off = (static_cast<size_t>(bi) * D + dd) * N + n;

  float h = live ? p.h0[h_off] : 0.f;
  const float a2 = live ? -expf(p.a_log[static_cast<size_t>(dd) * N + n])
                              * kLog2e
                        : 0.f;
  if (tid < CH) s_d[tid] = d0 + tid < D ? p.d[d0 + tid] : 0.f;

  // next chunk, loaded into registers while the current one is computed
  T rx[kLoadX], rdt[kLoadX], rb[kLoadB], rc[kLoadB];
  const T zero = from_f32<T>(0.f);
  auto load = [&](int t0) {
#pragma unroll
    for (int k = 0; k < kLoadX; ++k) {
      const int i = tid + k * kThreads, t = t0 + i / CH, c = d0 + i % CH;
      const bool ok = t < S && c < D;
      rx[k] = ok ? x[t * p.x_ss + c] : zero;
      rdt[k] = ok ? dt[t * p.dt_ss + c] : zero;
    }
#pragma unroll
    for (int k = 0; k < kLoadB; ++k) {
      const int i = tid + k * kThreads, t = t0 + i / NL, m = i % NL;
      const bool ok = i < kChunk * NL && t < S && m < N;
      rb[k] = ok ? bm[t * p.b_ss + m] : zero;
      rc[k] = ok ? cm[t * p.c_ss + m] : zero;
    }
  };

  load(0);
  for (int t0 = 0; t0 < S; t0 += kChunk) {
    // the previous pass ended in a barrier: the tiles are free to write
#pragma unroll
    for (int k = 0; k < kLoadX; ++k) {
      const int i = tid + k * kThreads;
      s_xdt[i / CH][i % CH] = make_float2(to_f32(rdt[k]), to_f32(rx[k]));
    }
#pragma unroll
    for (int k = 0; k < kLoadB; ++k) {
      const int i = tid + k * kThreads;
      if (i < kChunk * NL)
        s_bc[i / NL][i % NL] = make_float2(to_f32(rb[k]), to_f32(rc[k]));
    }
    __syncthreads();
    if (t0 + kChunk < S) load(t0 + kChunk);

#pragma unroll 1
    for (int tb = 0; tb < kChunk; tb += NL) {
      float v[NL];
#pragma unroll
      for (int j = 0; j < NL; ++j) {
        const float2 xd = s_xdt[tb + j][ch];
        const float2 bc = s_bc[tb + j][n];
        const float da = exp2f(xd.x * a2);
        h = fmaf(da, h, (xd.x * xd.y) * bc.x);
        v[j] = h * bc.y;
      }
      butterfly<NL / 2>(v, n);
      s_y[tb + n][ch] = v[0];
    }
    __syncthreads();

    for (int i = tid; i < kChunk * CH; i += kThreads) {
      const int t = i / CH, c = i % CH;
      if (t0 + t < S && d0 + c < D)
        y[static_cast<size_t>(t0 + t) * D + d0 + c] =
            from_f32<T>(s_y[t][c] + s_d[c] * s_xdt[t][c].y);
    }
    __syncthreads();
  }
  if (live) p.h_last[h_off] = h;
}

template <typename T>
__global__ void __launch_bounds__(kLinThreads)
lin_scan_kernel(const T* __restrict__ a, const T* __restrict__ bx,
                const float* __restrict__ h0, T* __restrict__ out, int S,
                int D) {
  const int dd = blockIdx.x * kLinThreads + threadIdx.x;
  if (dd >= D) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * S * D + dd;
  float h = h0[static_cast<size_t>(blockIdx.y) * D + dd];
  for (int t0 = 0; t0 < S; t0 += kLinSteps) {
    float av[kLinSteps], bv[kLinSteps];
#pragma unroll
    for (int j = 0; j < kLinSteps; ++j) {
      const bool ok = t0 + j < S;
      const size_t off = base + static_cast<size_t>(t0 + j) * D;
      av[j] = ok ? to_f32(a[off]) : 0.f;
      bv[j] = ok ? to_f32(bx[off]) : 0.f;
    }
#pragma unroll
    for (int j = 0; j < kLinSteps; ++j) {
      h = fmaf(av[j], h, bv[j]);
      if (t0 + j < S)
        out[base + static_cast<size_t>(t0 + j) * D] = from_f32<T>(h);
    }
  }
}

template <typename T, int NL>
int launch_sel(const SelScanArgs& a, cudaStream_t stream) {
  const dim3 grid((a.D + kThreads / NL - 1) / (kThreads / NL), a.B);
  sel_scan_kernel<T, NL><<<grid, kThreads, 0, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch_sel(const SelScanArgs& a, void* stream) {
  const auto s = static_cast<cudaStream_t>(stream);
  if (a.N < 1) return kBadStateDim;
  if (a.N <= 8) return launch_sel<T, 8>(a, s);
  if (a.N <= 16) return launch_sel<T, 16>(a, s);
  return kBadStateDim;
}

template <typename T>
int launch_lin(const void* a, const void* bx, const float* h0, void* out,
               int B, int S, int D, void* stream) {
  const dim3 grid((D + kLinThreads - 1) / kLinThreads, B);
  lin_scan_kernel<T><<<grid, kLinThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const T*>(a), static_cast<const T*>(bx), h0,
      static_cast<T*>(out), S, D);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each returns cudaGetLastError() after
// the launch (0 = cudaSuccess) or kBadStateDim; the launch is
// asynchronous on `stream`.
extern "C" int selective_scan_bf16(const SelScanArgs* a, void* stream) {
  return dispatch_sel<__nv_bfloat16>(*a, stream);
}

extern "C" int selective_scan_f32(const SelScanArgs* a, void* stream) {
  return dispatch_sel<float>(*a, stream);
}

extern "C" int ssm_scan_bf16(const void* a, const void* bx, const float* h0,
                             void* out, int B, int S, int D, void* stream) {
  return launch_lin<__nv_bfloat16>(a, bx, h0, out, B, S, D, stream);
}

extern "C" int ssm_scan_f32(const void* a, const void* bx, const float* h0,
                            void* out, int B, int S, int D, void* stream) {
  return launch_lin<float>(a, bx, h0, out, B, S, D, stream);
}

extern "C" const char* ssm_scan_error_string(int code) {
  if (code == kBadStateDim) return "state dim N has no kernel (1..16)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
