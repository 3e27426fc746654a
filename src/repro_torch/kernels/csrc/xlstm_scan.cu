// xLSTM's two recurrences over a whole sequence, for Hopper: the mLSTM
// (matrix memory) and sLSTM (scalar memory, recurrent weights) scans.
//
// No TPU kernel is replaced: the JAX package runs both as lax.scan bodies
// (repro/models/ssm.py:_mlstm_step and _slstm_step inside chunked_scan),
// which XLA compiles into one device loop. A loop of plain ops here would
// take about 12 launches a step, 32,768 steps a layer. Plain versions:
// repro_torch/kernels/ref.py: mlstm_scan_ref and slstm_scan_ref (and the
// step functions they loop, which the models' decode calls). Wrapper,
// checks and launch counts: repro_torch/kernels/xlstm_scan.py. Inputs and
// outputs are f32 and contiguous; the head dim hd is a multiple of 16 up
// to 256 (one instantiation of each kernel for each hd / 16).
//
// ---------------------------------------------------------------------
// mLSTM, for each batch row b and head h, from C = 0, n = 0, m = 0:
//   m' = max(log_sigmoid(f_t) + m, i_t)
//   f' = exp(log_sigmoid(f_t) + m - m'),  i' = exp(i_t - m')
//   C  = f' C + i' v_t k_t^T       [hd, hd]     n = f' n + i' k_t   [hd]
//   y_t = C q_t / max(|n . q_t|, 1)
// q (pre-scaled by hd^-0.5), k, v [B,S,H,hd]; i, f [B,S,H]; y [B,S,H,hd].
//
// Bound. On the xlstm-125m prefill path (B=8, S=32,768, H=4, hd=192) a
// call reads q, k, v, i, f and writes y, 3.23 GB: 0.96 ms at 3.35 TB/s.
// Its operations, with C kept scaled as below: each entry of C takes one
// FMA a step and C q one more (4 flops), and n and n . q 4 flops a
// column: 156 GFLOP, 2.32 ms at 67 f32 TFLOP/s. It is bound by
// operations, on the CUDA cores (the f32 recurrence has no tensor-core
// form that keeps its rounding).
//
// Design. Only the scalar chain m is serial across steps in a way that
// stops parallel work: every entry of C then needs one FMA a step of its
// own, and the reductions C q and n . q feed y but not the next step. So
// a block owns a band of kMBand = 16 rows of C of one (b, h) in registers
// and walks all of time itself; the grid is (hd / 16 bands, B * H), 384
// blocks of kMWarps = 4 warps at the path shape. A half-warp holds
// kMRowsT = 2 rows of C by all hd columns (hd / 16 a lane: contiguous, as
// 16-byte loads of q and k, where hd / 16 is a multiple of 4), so C q is a
// 4-shuffle reduction; every block keeps all of n itself (hd values, one
// more FMA a column), so n . q is one too and no block waits for another.
// q, k, the band's v and i, f come by 16-byte cp.async in chunks of
// kMChunk steps into two stages; warp 0 walks the chunk's m chain (a
// shuffle-fed serial max) and leaves the step's coefficients in shared
// memory. C and n are held divided by F, the running product of f': a
// step is then C += (i' / F) v k^T, one FMA an entry where f' C + i' v k^T
// took two, and y = F (C q) / max(|F (n . q)|, 1). Where F would fall
// below kMFloor, that step folds F into C and n (the plain recurrence's
// step), so C stays within 2^30 of its true scale. The step loop is
// unrolled by two, so one step's reductions overlap the next step's
// products; the outputs' divisions and stores are one pass a chunk.
// Fixed orders throughout: two calls give the same bits. (Two or one
// warps a block with 4 or 8 rows a thread, and chunks of 20 steps, which
// hold 3 blocks an SM, were no faster on an H100 SXM.)
//
// ---------------------------------------------------------------------
// sLSTM, for each batch row b, head h and row v, from c = n = h = m = 0:
//   pre_g = x_{t,g} + sum_w W_g[v, w] h_{t-1}[w] + bias_g   (g = i, f, z, o)
//   m' = max(log_sigmoid(pre_f) + m, pre_i)
//   f' = exp(log_sigmoid(pre_f) + m - m'),  i' = exp(pre_i - m')
//   c = f' c + i' tanh(pre_z);  n = f' n + i'
//   h_t = sigmoid(pre_o) c / max(n, 1)
// x (pre) [B,S,4,H,hd]; W = w_r [4,H,hd,hd]; bias [4,H,hd]; the h trail
// [B,S,H,hd].
//
// Bound. At the path shape a call reads pre (3.22 GB) and writes the h
// trail (0.81 GB): 1.20 ms at 3.35 TB/s. The recurrent products are 4 hd^2
// FMAs a (b, h, step) and the cell update about 31 operations a row: 316
// GFLOP, 4.71 ms at 67 f32 TFLOP/s. Bound by operations.
//
// Design. Every step needs the head's whole previous h, so the chain is a
// serial matvec [4 hd x hd] x [hd] a step. A head's W is 4 x 192^2 x 4 B =
// 576 KiB, more than an SM holds, and every batch row of the head shares
// it. A cluster of kSCluster = 8 blocks takes one head and kSBatch = 4
// batch rows (8 clusters, 64 SMs, at the path shape: an H100 SXM holds
// 15 such clusters at once, so 2 batch rows a cluster would need two
// waves): block j owns rows [j hd/8, (j+1) hd/8) of all four gates, a
// warp a row, and keeps its slice of W in registers, lane l holding the
// four gates' W[r, w] for w = 32 jj + l. A step:
//   * waits on this block's mbarrier for the buffer that holds h_{t-1}
//     (the previous step's h of all rows, from all 8 blocks);
//   * reads h[w][0..3] as one 16-byte load a w, each feeding 16 FMAs (4
//     gates x 4 batch rows; read once a gate, h made shared-memory
//     bandwidth, not the FMAs, the bound);
//   * reduces the 16 sums over the warp in 16 shuffles (a transposing
//     butterfly) and writes x + rec + bias of each (gate, batch row) to
//     shared memory;
//   * after one block barrier, 96 threads (a row and batch row each) do
//     the cell update (in every lane of every warp its issue cost bound
//     the step), store y and stage the block's h rows;
//   * those threads send the rows to every block of the cluster as 16-byte
//     st.async pieces into the other of two h buffers, each counted as
//     transaction bytes on the receiving block's mbarrier, so the step
//     ends without a cluster barrier (one a step, whose release also
//     waits on the prefetch loads, costs more than the step's work).
// x is loaded kSAhead steps ahead into registers. The cell update rounds
// as the plain version does (no contraction into FMAs); the matvec's
// order is fixed, so two calls give the same bits.
//
// Under autograd the wrapper launches slstm_scan_kernel<D16, true>, which
// also keeps the trails its backward (csrc/xlstm_scan_bwd.cu) reads: each
// step's full pre-activations x + W h + bias [B,S,4,H,hd] and c, n, m
// after it [B,S,H,hd] (plain version: ref.slstm_scan_trails_ref). The
// mLSTM's backward needs no trail: mlstm_scan_kernel is the same on both
// paths.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

// Mirrors of the ctypes structures in repro_torch/kernels/xlstm_scan.py.
struct MlstmScanArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* i;
  const float* f;
  float* y;
  int B, S, H, hd;
};

struct SlstmScanArgs {
  const float* pre;
  const float* w_r;
  const float* bias;
  float* y;
  // the trails (all null, or all set: then the <D16, true> kernel runs)
  float* p_trail;
  float* c_trail;
  float* n_trail;
  float* m_trail;
  int B, S, H, hd;
};

namespace {

constexpr int kBadHeadDim = 1000;   // hd not a multiple of 16 in 16..256
constexpr int kBadGrid = 1001;      // B * H (mLSTM) or B (sLSTM) too large

constexpr int kMWarps = 4;
constexpr int kMThreads = 32 * kMWarps;
constexpr int kMBand = 16;                        // rows of C a block
constexpr int kMRowsT = kMBand / (2 * kMWarps);   // rows of C a thread: 2
constexpr int kMChunk = 16;                       // steps a stage
// C and n are kept divided by F, the product of f' since they were last
// rescaled; a step whose F would fall below this folds F into them
constexpr float kMFloor = 0x1p-30f;

constexpr int kSCluster = 8;               // blocks of one head, batch group
constexpr int kSBatch = 4;                 // batch rows a cluster
constexpr int kSAhead = 4;                 // steps of x loads in flight
constexpr int kMaxGridYZ = 65535;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory: the first `bytes` (0 or 16) from
// src, zeros after them.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(dst),
               "l"(src), "r"(bytes) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

__device__ __forceinline__ void cp_async_wait1() {
  asm volatile("cp.async.wait_group 1;" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}

// This block's one arrival on `bar` for its current phase, which then
// also waits for `bytes` of st.async transactions.
__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

// Wait for the phase of `bar` of this parity to complete; acquire at
// cluster scope, so that what other blocks' st.async wrote is visible.
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(bar), "r"(parity) : "memory");
  } while (!done);
}

// The address of this block's shared-memory word `addr` in block `rank`
// of the cluster.
__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

// Four floats into another block's shared memory, 16 bytes on its `bar`.
__device__ __forceinline__ void st_async4(uint32_t addr, float a, float b,
                                          float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr), "f"(a), "f"(b), "f"(c), "f"(d),
      "r"(bar) : "memory");
}

// Barrier `id` among the first `count` threads of the block.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------------ mLSTM
// Shared memory of an mLSTM block, in floats: two stages of
// q, k [kMChunk][HD], v [kMChunk][kMBand] (the band's rows), i, f
// [kMChunk]; then, a step of the chunk being walked, the factor that C
// and n are rescaled by before it (1 but where F is folded in), the
// coefficient i' / F of v k^T and F itself; then the chunk's outputs:
// F (C q) a row [kMChunk][kMBand] and max(|F (n . q)|, 1).
template <int D16>
struct MSmem {
  static constexpr int HD = 16 * D16;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kMChunk * HD;
  static constexpr int kV = kK + kMChunk * HD;
  static constexpr int kI = kV + kMChunk * kMBand;
  static constexpr int kF = kI + kMChunk;
  static constexpr int kStage = kF + kMChunk;     // a multiple of 4 floats
  static constexpr int kRs = 2 * kStage;
  static constexpr int kA = kRs + kMChunk;
  static constexpr int kFs = kA + kMChunk;
  static constexpr int kNum = kFs + kMChunk;
  static constexpr int kDen = kNum + kMChunk * kMBand;
  static constexpr int kBytes = (kDen + kMChunk) * 4;
};

// The chunk of steps [t0, t0 + kMChunk) of (b, h) into stage `st`,
// zero-filled past S.
template <int D16>
__device__ __forceinline__ void m_load(const MlstmScanArgs& a, float* st,
                                       int b, int h, int band, int t0) {
  using L = MSmem<D16>;
  constexpr int HD = L::HD;
  constexpr int kRow4 = HD / 4;
  for (int p = threadIdx.x; p < kMChunk * kRow4; p += kMThreads) {
    const int s = p / kRow4, c4 = p % kRow4, t = t0 + s;
    const bool ok = t < a.S;
    const long long off =
        ok ? ((static_cast<long long>(b) * a.S + t) * a.H + h) * HD + 4 * c4
           : 0;
    cp_async16(smem_addr(st + L::kQ + s * HD + 4 * c4), a.q + off,
               ok ? 16 : 0);
    cp_async16(smem_addr(st + L::kK + s * HD + 4 * c4), a.k + off,
               ok ? 16 : 0);
  }
  for (int p = threadIdx.x; p < kMChunk * kMBand / 4; p += kMThreads) {
    const int s = p / (kMBand / 4), c4 = p % (kMBand / 4), t = t0 + s;
    const bool ok = t < a.S;
    const long long off =
        ok ? ((static_cast<long long>(b) * a.S + t) * a.H + h) * HD
                 + band * kMBand + 4 * c4
           : 0;
    cp_async16(smem_addr(st + L::kV + s * kMBand + 4 * c4), a.v + off,
               ok ? 16 : 0);
  }
  for (int s = threadIdx.x; s < kMChunk; s += kMThreads) {
    const int t = t0 + s;
    const bool ok = t < a.S;
    const long long off =
        ok ? (static_cast<long long>(b) * a.S + t) * a.H + h : 0;
    cp_async4(smem_addr(st + L::kI + s), a.i + off, ok ? 4 : 0);
    cp_async4(smem_addr(st + L::kF + s), a.f + off, ok ? 4 : 0);
  }
}

// The D16 columns of a step's q or k row that lane l16 holds: contiguous
// (as 16-byte loads) when D16 is a multiple of 4, else every 16th.
template <int D16>
__device__ __forceinline__ void m_cols(const float* row, int l16,
                                       float (&out)[D16]) {
  if constexpr (D16 % 4 == 0) {
    const float4* r4 = reinterpret_cast<const float4*>(row + l16 * D16);
#pragma unroll
    for (int j = 0; j < D16 / 4; ++j) {
      const float4 v = r4[j];
      out[4 * j] = v.x;
      out[4 * j + 1] = v.y;
      out[4 * j + 2] = v.z;
      out[4 * j + 3] = v.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < D16; ++j) out[j] = row[16 * j + l16];
  }
}

template <int D16>
__global__ void __launch_bounds__(kMThreads)
mlstm_scan_kernel(const MlstmScanArgs a) {
  using L = MSmem<D16>;
  constexpr int HD = L::HD;
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  const int band = blockIdx.x;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int l16 = lane & 15;
  const int rloc = (warp * 2 + (lane >> 4)) * kMRowsT;   // row in the band
  float c[kMRowsT][D16], n[D16];
#pragma unroll
  for (int jj = 0; jj < D16; ++jj) {
    n[jj] = 0.f;
#pragma unroll
    for (int j = 0; j < kMRowsT; ++j) c[j][jj] = 0.f;
  }
  float m_run = 0.f, f_run = 1.f;        // warp 0: the stabiliser m, F
  float* yb = a.y + (static_cast<long long>(b) * a.S * a.H + h) * HD
              + band * kMBand;
  const long long ystep = static_cast<long long>(a.H) * HD;
  const int chunks = (a.S + kMChunk - 1) / kMChunk;

  m_load<D16>(a, sm, b, h, band, 0);
  cp_async_commit();
  for (int ci = 0; ci < chunks; ++ci) {
    const int t0 = ci * kMChunk;
    if (ci + 1 < chunks)
      m_load<D16>(a, sm + ((ci + 1) & 1) * L::kStage, b, h, band,
                  t0 + kMChunk);
    cp_async_commit();                   // empty past the last chunk
    cp_async_wait1();
    __syncthreads();
    const float* st = sm + (ci & 1) * L::kStage;
    const int nt = min(kMChunk, a.S - t0);
    if (warp == 0) {
      // the chunk's m chain, in step order, as the plain version takes it
      const float iv = lane < kMChunk ? st[L::kI + lane] : 0.f;
      const float lf = log_sigmoid(lane < kMChunk ? st[L::kF + lane] : 0.f);
      float m_prev = 0.f, m_new = 0.f;
#pragma unroll
      for (int t = 0; t < kMChunk; ++t) {
        const float lft = __shfl_sync(0xffffffffu, lf, t);
        const float it = __shfl_sync(0xffffffffu, iv, t);
        const float mp = m_run;
        if (t < nt) m_run = fmaxf(lft + m_run, it);
        if (lane == t) {
          m_prev = mp;
          m_new = m_run;
        }
      }
      const float fp = expf(lf + m_prev - m_new);
      const float ip = expf(iv - m_new);
      // F, and where it would fall below kMFloor fold it into C and n
      // (that step is then the plain recurrence's: C = f' C + i' v k^T)
      float rs = 1.f, f_t = 1.f;
#pragma unroll
      for (int t = 0; t < kMChunk; ++t) {
        const float fpt = __shfl_sync(0xffffffffu, fp, t);
        const float cand = f_run * fpt;
        const bool fold = cand < kMFloor;
        if (lane == t) {
          rs = fold ? cand : 1.f;
          f_t = fold ? 1.f : cand;
        }
        if (t < nt) f_run = fold ? 1.f : cand;
      }
      if (lane < kMChunk) {
        sm[L::kRs + lane] = rs;
        sm[L::kA + lane] = ip / f_t;
        sm[L::kFs + lane] = f_t;
      }
    }
    __syncthreads();
#pragma unroll 2
    for (int tt = 0; tt < nt; ++tt) {
      const float rs = sm[L::kRs + tt], at = sm[L::kA + tt];
      if (rs != 1.f) {                   // the same for the whole block
#pragma unroll
        for (int jj = 0; jj < D16; ++jj) {
          n[jj] *= rs;
#pragma unroll
          for (int j = 0; j < kMRowsT; ++j) c[j][jj] *= rs;
        }
      }
      float kk[D16], qq[D16];
      m_cols<D16>(st + L::kK + tt * HD, l16, kk);
      m_cols<D16>(st + L::kQ + tt * HD, l16, qq);
      float av[kMRowsT], num[kMRowsT];
#pragma unroll
      for (int j = 0; j < kMRowsT; ++j) {
        av[j] = at * st[L::kV + tt * kMBand + rloc + j];
        num[j] = 0.f;
      }
      float dn = 0.f;
#pragma unroll
      for (int jj = 0; jj < D16; ++jj) {
        n[jj] = fmaf(at, kk[jj], n[jj]);
        dn = fmaf(n[jj], qq[jj], dn);
#pragma unroll
        for (int j = 0; j < kMRowsT; ++j) {
          c[j][jj] = fmaf(av[j], kk[jj], c[j][jj]);
          num[j] = fmaf(c[j][jj], qq[jj], num[j]);
        }
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1) {
        dn += __shfl_xor_sync(0xffffffffu, dn, off);
#pragma unroll
        for (int j = 0; j < kMRowsT; ++j)
          num[j] += __shfl_xor_sync(0xffffffffu, num[j], off);
      }
      const float ft = sm[L::kFs + tt];
      if (l16 < kMRowsT) {
        float out = num[0];
#pragma unroll
        for (int j = 1; j < kMRowsT; ++j)
          if (l16 == j) out = num[j];
        sm[L::kNum + tt * kMBand + rloc + l16] = ft * out;
      }
      if (threadIdx.x == 0) sm[L::kDen + tt] = fmaxf(fabsf(ft * dn), 1.f);
    }
    __syncthreads();                     // the stage and the outputs
    // y of the chunk: a row of the band's 16 floats a step
    for (int e = threadIdx.x; e < nt * kMBand; e += kMThreads)
      yb[(t0 + e / kMBand) * ystep + e % kMBand] =
          sm[L::kNum + e] / sm[L::kDen + e / kMBand];
  }
}

template <int D16>
int launch_mlstm(const MlstmScanArgs& a, cudaStream_t s) {
  using L = MSmem<D16>;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_scan_kernel<D16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_scan_kernel<D16><<<dim3(D16, a.B * a.H), kMThreads, L::kBytes, s>>>(
      a);
  return static_cast<int>(cudaGetLastError());
}

template <int D16>
int mlstm_blocks_per_sm_t() {
  using L = MSmem<D16>;
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_scan_kernel<D16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, mlstm_scan_kernel<D16>, kMThreads, L::kBytes);
  return err == cudaSuccess ? n : 0;
}

template <int D16>
int mlstm_smem_t() {
  return MSmem<D16>::kBytes;
}

// ------------------------------------------------------------------ sLSTM
template <int D16>
constexpr int kSThreads = 32 * 2 * D16;    // a warp a row: hd / 8 rows

template <int D16, bool kTrail>
__global__ void __launch_bounds__(kSThreads<D16>, 1)
    slstm_scan_kernel(const SlstmScanArgs a) {
  constexpr int HD = 16 * D16;
  constexpr int RB = HD / kSCluster;       // rows a block, a warp each
  constexpr int kCells = RB * kSBatch;     // (row, batch row) cells a block
  constexpr int kCellThreads = (kCells + 31) / 32 * 32;
  constexpr int kPieces = kCells / 4;      // 16-byte pieces of its h
  constexpr int kBytes = HD * kSBatch * 4; // h a step, from all blocks
  __shared__ __align__(16) float hbuf[2][HD][kSBatch];
  __shared__ __align__(16) float hloc[RB][kSBatch];
  __shared__ float pre_s[kSBatch][4][RB];
  __shared__ __align__(8) uint64_t mbar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // matvec: a warp owns row r of all four gates; lane holds W_g[r, w] for
  // w = 32 jj + lane (zero past hd), so each h[w] it reads feeds 4 kSBatch
  // FMAs. The transposing reduction leaves lane l with sum kV * l / 32 of
  // the kV = 4 kSBatch, index = gate kSBatch + batch row.
  constexpr int kW = (HD + 31) / 32;       // w a lane
  constexpr int kV = 4 * kSBatch;          // sums a warp
  const int vi = lane * kV / 32, g = vi / kSBatch, hi = vi % kSBatch;
  const bool writer = lane % (32 / kV) == 0;
  const int r = rank * RB + warp;          // this warp's row of the head
  const int h = blockIdx.z;
  const int b0 = blockIdx.y * kSBatch;
  const bool valid = b0 + hi < a.B;
  const long long ghr = (static_cast<long long>(g) * a.H + h) * HD + r;

  float wt[4][kW];
#pragma unroll
  for (int gg = 0; gg < 4; ++gg)
#pragma unroll
    for (int jj = 0; jj < kW; ++jj) {
      const int w = 32 * jj + lane;
      wt[gg][jj] = w < HD ? a.w_r[((static_cast<long long>(gg) * a.H + h) * HD
                                   + r) * HD + w]
                          : 0.f;
    }
  const float bias = a.bias[ghr];
  for (int e = threadIdx.x; e < HD * kSBatch; e += blockDim.x)
    (&hbuf[0][0][0])[e] = 0.f;
  const auto bar0 = smem_addr(&mbar[0]), bar1 = smem_addr(&mbar[1]);
  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar1, 1);
    mbar_expect(bar0, kBytes);
    mbar_expect(bar1, kBytes);
  }

  // pre[b][t][g][h][r] for this lane's (b0 + hi, g, r)
  const long long xstep = 4LL * a.H * HD;
  const float* xp =
      a.pre + (static_cast<long long>(valid ? b0 + hi : 0) * a.S * 4 + g)
                  * a.H * HD
      + static_cast<long long>(h) * HD + r;
  // the cell thread of (row rank RB + cr, batch row b0 + cb): its state
  // and its y[b][t][h][r]
  const int cr = threadIdx.x % RB, cb = threadIdx.x / RB;
  const bool cell = threadIdx.x < kCells;
  const bool cvalid = cell && b0 + cb < a.B;
  float* yp = a.y + (static_cast<long long>(cvalid ? b0 + cb : 0) * a.S * a.H
                     + h) * HD + rank * RB + cr;
  const long long ystep = static_cast<long long>(a.H) * HD;
  // x of the next kSAhead steps; a register each once the loop unrolls, so
  // no step waits on a load issued in the step before
  float xr[kSAhead];
#pragma unroll
  for (int j = 0; j < kSAhead; ++j)
    xr[j] = valid && j < a.S ? xp[j * xstep] : 0.f;
  float c = 0.f, n = 0.f, m = 0.f;
  cluster.sync();              // barriers set up and buffer 0 zero everywhere
  for (int t0 = 0; t0 < a.S; t0 += kSAhead) {
#pragma unroll
    for (int j = 0; j < kSAhead; ++j) {
      const int t = t0 + j;
      if (t >= a.S) break;
      const float x = xr[j];
      xr[j] = valid && t + kSAhead < a.S ? xp[(t + kSAhead) * xstep] : 0.f;
      if (t > 0) {
        // buffer t & 1 holds h_{t-1} once every block's rows have landed;
        // then this block arms the buffer's next phase (h_{t+1})
        const auto bar = t & 1 ? bar1 : bar0;
        mbar_wait(bar, ((t - 1) >> 1) & 1);
        if (threadIdx.x == 0) mbar_expect(bar, kBytes);
      }
      float v[kV];
#pragma unroll
      for (int e = 0; e < kV; ++e) v[e] = 0.f;
#pragma unroll
      for (int jj = 0; jj < kW; ++jj) {
        const int w = min(32 * jj + lane, HD - 1);   // past hd: weight 0
        const float4 q = *reinterpret_cast<const float4*>(&hbuf[t & 1][w][0]);
        const float hv[kSBatch] = {q.x, q.y, q.z, q.w};
#pragma unroll
        for (int gg = 0; gg < 4; ++gg)
#pragma unroll
          for (int bb = 0; bb < kSBatch; ++bb)
            v[gg * kSBatch + bb] =
                fmaf(wt[gg][jj], hv[bb], v[gg * kSBatch + bb]);
      }
      // transposing reduction: at offset o, lanes with bit o keep the upper
      // half of their sums and take their partner's; then sum the rest
      int cnt = kV;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        if (cnt > 1) {
          const bool up = lane & o;
#pragma unroll
          for (int e = 0; e < kV / 2; ++e) {
            if (e < cnt / 2) {
              const float mine = up ? v[e + cnt / 2] : v[e];
              const float give = up ? v[e] : v[e + cnt / 2];
              v[e] = mine + __shfl_xor_sync(0xffffffffu, give, o);
            }
          }
          cnt /= 2;
        } else {
          v[0] += __shfl_xor_sync(0xffffffffu, v[0], o);
        }
      }
      const float keep = v[0];
      if (writer) pre_s[hi][g][warp] = __fadd_rn(__fadd_rn(x, keep), bias);
      __syncthreads();
      if (threadIdx.x < kCellThreads) {
        if (cell) {
          const float pi = pre_s[cb][0][cr], pf = pre_s[cb][1][cr];
          const float pz = pre_s[cb][2][cr], po = pre_s[cb][3][cr];
          const float lf = log_sigmoid(pf);
          const float mf = __fadd_rn(lf, m);
          const float m_new = fmaxf(mf, pi);
          const float ip = expf(__fsub_rn(pi, m_new));
          const float fp = expf(__fsub_rn(mf, m_new));
          c = __fadd_rn(__fmul_rn(fp, c), __fmul_rn(ip, tanhf(pz)));
          n = __fadd_rn(__fmul_rn(fp, n), ip);
          const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-po)));
          const float hn = __fdiv_rn(__fmul_rn(sig, c), fmaxf(n, 1.f));
          m = m_new;
          hloc[cr][cb] = hn;
          if (cvalid) yp[t * ystep] = hn;
          if (kTrail && cvalid) {
            // trails at the offsets of y: [b][t][h][r]; p [b][t][g][h][r]
            const long long off = yp - a.y + t * ystep;
            const long long poff = off + (off / ystep) * 3 * ystep;
            a.p_trail[poff] = pi;
            a.p_trail[poff + ystep] = pf;
            a.p_trail[poff + 2 * ystep] = pz;
            a.p_trail[poff + 3 * ystep] = po;
            a.c_trail[off] = c;
            a.n_trail[off] = n;
            a.m_trail[off] = m_new;
          }
        }
        // the block's rows of h_t, RB x kSBatch floats, to every block of
        // the cluster, into buffer (t + 1) & 1 (nobody reads the last
        // step's)
        named_barrier(1, kCellThreads);
        if (t + 1 < a.S) {
          const auto bar = t & 1 ? bar0 : bar1;
          float* dst0 = &hbuf[(t + 1) & 1][rank * RB][0];
          for (int e = threadIdx.x; e < kPieces * kSCluster;
               e += kCellThreads) {
            const int to = e / kPieces, pc = e % kPieces;
            const float4 v = reinterpret_cast<const float4*>(&hloc[0][0])[pc];
            st_async4(map_rank(smem_addr(dst0 + 4 * pc), to), v.x, v.y, v.z,
                      v.w, map_rank(bar, to));
          }
        }
      }
    }
  }
  cluster.sync();              // no block leaves while the others run
}

template <int D16>
cudaLaunchConfig_t slstm_config(int batch, int heads, cudaStream_t s,
                                cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSCluster, (batch + kSBatch - 1) / kSBatch, heads);
  cfg.blockDim = dim3(kSThreads<D16>);
  cfg.stream = s;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = kSCluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

template <int D16>
int launch_slstm(const SlstmScanArgs& a, cudaStream_t s) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = slstm_config<D16>(a.B, a.H, s, &attr);
  const cudaError_t err =
      a.c_trail != nullptr
          ? cudaLaunchKernelEx(&cfg, slstm_scan_kernel<D16, true>, a)
          : cudaLaunchKernelEx(&cfg, slstm_scan_kernel<D16, false>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int D16>
int slstm_max_clusters_t(int batch, int heads) {
  int n = 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      slstm_config<D16>(batch, heads, nullptr, &attr);
  const cudaError_t err = cudaOccupancyMaxActiveClusters(
      &n, slstm_scan_kernel<D16, false>, &cfg);
  return err == cudaSuccess ? n : 0;
}

#define XLSTM_HD_CASES(F, ...)                                              \
  switch (hd / 16) {                                                        \
    case 1: return F<1>(__VA_ARGS__);                                       \
    case 2: return F<2>(__VA_ARGS__);                                       \
    case 3: return F<3>(__VA_ARGS__);                                       \
    case 4: return F<4>(__VA_ARGS__);                                       \
    case 5: return F<5>(__VA_ARGS__);                                       \
    case 6: return F<6>(__VA_ARGS__);                                       \
    case 7: return F<7>(__VA_ARGS__);                                       \
    case 8: return F<8>(__VA_ARGS__);                                       \
    case 9: return F<9>(__VA_ARGS__);                                       \
    case 10: return F<10>(__VA_ARGS__);                                     \
    case 11: return F<11>(__VA_ARGS__);                                     \
    case 12: return F<12>(__VA_ARGS__);                                     \
    case 13: return F<13>(__VA_ARGS__);                                     \
    case 14: return F<14>(__VA_ARGS__);                                     \
    case 15: return F<15>(__VA_ARGS__);                                     \
    case 16: return F<16>(__VA_ARGS__);                                     \
    default: break;                                                         \
  }

bool good_hd(int hd) { return hd % 16 == 0 && hd >= 16 && hd <= 256; }

}  // namespace

// Plain C entry points for ctypes. A launch returns cudaGetLastError()
// after it (0 = cudaSuccess), kBadHeadDim or kBadGrid; it is asynchronous
// on `stream`.
extern "C" int mlstm_scan_f32(const MlstmScanArgs* a, void* stream) {
  const int hd = a->hd;
  if (!good_hd(hd)) return kBadHeadDim;
  if (static_cast<long long>(a->B) * a->H > kMaxGridYZ) return kBadGrid;
  XLSTM_HD_CASES(launch_mlstm, *a, static_cast<cudaStream_t>(stream))
  return kBadHeadDim;
}

extern "C" int slstm_scan_f32(const SlstmScanArgs* a, void* stream) {
  const int hd = a->hd;
  if (!good_hd(hd)) return kBadHeadDim;
  if ((a->B + kSBatch - 1) / kSBatch > kMaxGridYZ || a->H > kMaxGridYZ)
    return kBadGrid;
  XLSTM_HD_CASES(launch_slstm, *a, static_cast<cudaStream_t>(stream))
  return kBadHeadDim;
}

// mLSTM blocks an SM holds at once, and its dynamic shared memory a block
// in bytes, at head dim hd (0 on error).
extern "C" int mlstm_scan_blocks_per_sm(int hd) {
  if (!good_hd(hd)) return 0;
  XLSTM_HD_CASES(mlstm_blocks_per_sm_t)
  return 0;
}

extern "C" int mlstm_scan_smem_bytes(int hd) {
  if (!good_hd(hd)) return 0;
  XLSTM_HD_CASES(mlstm_smem_t)
  return 0;
}

// sLSTM clusters of kSCluster blocks the card holds at once for a call of
// `batch` rows and `heads` heads at head dim hd (0 on error).
extern "C" int slstm_scan_max_active_clusters(int hd, int batch, int heads) {
  if (!good_hd(hd)) return 0;
  XLSTM_HD_CASES(slstm_max_clusters_t, batch, heads)
  return 0;
}

// The layouts built: which 0 gives the mLSTM's warps a block, 1 its rows
// of C a thread, 2 the sLSTM's blocks a cluster, 3 its batch rows a
// cluster.
extern "C" int xlstm_scan_layout(int which) {
  const int v[4] = {kMWarps, kMRowsT, kSCluster, kSBatch};
  return which >= 0 && which < 4 ? v[which] : 0;
}

extern "C" const char* xlstm_scan_error_string(int code) {
  if (code == kBadHeadDim)
    return "head dim has no kernel (a multiple of 16 up to 256)";
  if (code == kBadGrid) return "too many batch rows or heads for the grid";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
