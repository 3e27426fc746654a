// The backward of xLSTM's two recurrences (csrc/xlstm_scan.cu), for
// Hopper: the mLSTM's in three kernels, the sLSTM's in one.
//
// No TPU kernel is replaced: the JAX package differentiates its lax.scan
// bodies (repro/models/ssm.py:_mlstm_step and _slstm_step inside
// chunked_scan) with jax.grad. Plain versions, which split the work into
// the same passes: repro_torch/kernels/ref.py: mlstm_scan_bwd_ref and
// slstm_scan_dpre_ref. Wrapper, autograd Functions, checks and launch
// counts: repro_torch/kernels/xlstm_scan.py. Inputs and outputs are f32
// and contiguous; hd is a multiple of 16 up to 256.
//
// ---------------------------------------------------------------------
// mLSTM (forward: C = f' C + i' v k^T, n = f' n + i' k, y = C q / den,
// den = max(|n . q|, 1); see xlstm_scan.cu). With log f' and log i' taken
// as the variables, the gates need no C: their gradients are
//   a_t = sum_{u>=t} (q_u . dq_u - k_u . dk_u)   and   b_t = k_t . dk_t,
// and the stabiliser chain m_t = max(log_sigmoid(f_t) + m_{t-1}, i_t)
// carries them to i and f as a scalar reverse walk. The passes:
//   mlstm_bwd_prep_kernel, a block a (b, h), forward: the m chain, f',
//     i' and which arm each max took; n from zero, n . q and dy . y, then
//     den_t and g_t = -(dy_t . y_t) / den_t sign(n . q) [|n . q| >= 1];
//   mlstm_bwd_kernel, a block a (16-column band of C, (b, h)):
//     A, forward: C from zero, dq_t = C_t^T dy_t / den_t + g_t n_t (sums
//       over C's rows: local to a column band);
//     B, reverse: dC_t = f'_{t+1} dC_{t+1} + (dy_t / den_t) q_t^T and
//       dn_t = f'_{t+1} dn_{t+1} + g_t q_t; dk_t = i'_t (dC_t^T v_t + dn_t)
//       (local) and the band's part of dv_t = i'_t dC_t k_t (a sum over
//       C's columns, which no band holds whole), and each band's part of
//       q . dq and k . dk;
//   mlstm_bwd_reduce_kernel: dv as the sum of the bands' parts in band
//     order, and, a warp a (b, h), the gates' reverse walk over the
//     bands' sums (an affine scan over a warp's 32 steps a chunk).
// No state is saved by the forward: pass A recomputes C from zero.
//
// Bound. At the xlstm-125m train shape (B=8, S=2048, H=4, hd=192; 65,536
// (b, s, h) and 36,864 entries of C) pass A takes 2 FMAs an entry of C a
// step, pass B 3: 24.3 GFLOP with the n chains and sums, 0.36 ms at 67
// f32 TFLOP/s; the bytes the function must move (q, k, v, y, dy, i, f
// read, dq, dk, dv, di, df written) 0.40 GB, 0.12 ms at 3.35 TB/s. This
// design also writes and reads the bands' dv parts, 1.2 GB more (0.36
// ms), so its own traffic passes the operations' time.
//
// Design of mlstm_bwd_kernel. A block (4 warps) holds its band's 16
// columns of C by all hd rows in registers: a thread 2 columns (lane & 7)
// by hd / 16 rows (rows rslot + 16 j, rslot = 4 warp + lane / 8). The
// column sums (dq, dk) are 2 shuffles and a per-warp partial in shared
// memory a step; dv's 16-column sums a padded transposing butterfly over
// the 8 lanes of a row. C and n are kept divided by F, the running product
// of f' (pass A), and dC and dn by P, the reverse product (pass B), folded
// in where it would fall below kMFloor, as the forward does: one FMA an
// entry a step. q, k (the band), v, dy (whole rows) and the prep's
// scalars come by cp.async in chunks of kBChunk steps into two stages;
// the outputs are written once a chunk. Fixed orders throughout: two
// calls give the same bits.
//
// ---------------------------------------------------------------------
// sLSTM (forward: pre_g = x_g + W_g h_{t-1} + bias_g; the cell; see
// xlstm_scan.cu). In reverse, with dp_t the gradient of the four gates'
// pre-activations at step t:
//   dh_t = dy_t + sum_g W_g^T dp_{g,t+1}
// then back through h = sigmoid(o) c / max(n, 1), the c, n and m chains
// (dc, dn, dm carried a row) and the gates, recomputing each step's cell
// from the forward's trails (p, and c, n, m of the step before) with the
// forward's own rounding. dp is the kernel's output, dpre; dW = sum dp
// h_{t-1}^T and dbias = sum dp are plain products outside the kernel.
//
// Bound. At the train shape the transposed products are 4 hd^2 FMAs a
// (b, h, step) and the cell about 60 operations a row: 20.1 GFLOP, 0.30
// ms at 67 f32 TFLOP/s; the bytes (the p trail, c, n, m, dy and W read,
// dpre written) 0.61 GB, 0.18 ms.
//
// Design of slstm_scan_bwd_kernel: the forward's, transposed. A cluster
// of kSCluster = 8 blocks takes one head and kSBatch = 4 batch rows;
// block j owns rows [j hd/8, (j+1) hd/8) of the cell and keeps the column
// slice W_g[:, j hd/8 ...] of all four gates in registers, a warp two
// output rows w (lane l holds W_g[v, w] for v = 32 jj + l). A step:
//   * 8 hd/16 threads (a row and batch row each) do the cell's backward
//     with dh = dy + the recurrent sum of the step before, store dpre and
//     stage the block's dp (4 gates x its rows x 4 batch rows);
//   * they send it to every block of the cluster as 16-byte st.async
//     pieces into the other of two buffers, counted on that block's
//     mbarrier (4 times the forward's h a step);
//   * every warp waits for the buffer, then sums W_g^T dp over v and the
//     four gates for its two rows, 8 sums reduced by a transposing
//     butterfly, into shared memory for the next step's cells.
// The trails are loaded kSAhead steps ahead into registers; the matvec's
// order is fixed, so two calls give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace cg = cooperative_groups;

// Mirrors of the ctypes structures in repro_torch/kernels/xlstm_scan.py.
struct MlstmBwdArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* i;
  const float* f;
  const float* y;
  const float* dy;
  float* dq;
  float* dk;
  float* dv;
  float* di;
  float* df;
  // scratch, [B,S,H] each: f', i', the max's arm, den, g
  float* fp;
  float* ip;
  float* sel;
  float* den;
  float* g;
  // scratch: the bands' q . dq and k . dk [hd/16][B,S,H], dv [hd/16][B,S,H,hd]
  float* pq;
  float* pk;
  float* dv_part;
  int B, S, H, hd;
};

struct SlstmBwdArgs {
  const float* w_r;
  const float* p;       // the forward's trails
  const float* c;
  const float* n;
  const float* m;
  const float* dy;
  float* dpre;
  int B, S, H, hd;
};

namespace {

constexpr int kBadHeadDim = 1000;   // hd not a multiple of 16 in 16..256
constexpr int kBadGrid = 1001;      // B * H (mLSTM) or B (sLSTM) too large

constexpr int kBWarps = 4;
constexpr int kBThreads = 32 * kBWarps;
constexpr int kBBand = 16;                        // columns of C a block
constexpr int kBChunk = 16;                       // steps a stage
constexpr float kMFloor = 0x1p-30f;               // as xlstm_scan.cu
constexpr int kPChunk = 32;                       // prep, gates: steps a warp
constexpr int kRThreads = 256;                    // the reduce kernel's block

constexpr int kSCluster = 8;
constexpr int kSBatch = 4;
constexpr int kSAhead = 4;
constexpr int kMaxGridYZ = 65535;

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

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

__device__ __forceinline__ void mbar_expect(uint32_t bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;"
               ::"r"(bar), "r"(bytes) : "memory");
}

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

__device__ __forceinline__ uint32_t map_rank(uint32_t addr, int rank) {
  uint32_t out;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(out)
               : "r"(addr), "r"(rank));
  return out;
}

__device__ __forceinline__ void st_async4(uint32_t addr, float a, float b,
                                          float c, float d, uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];" ::"r"(addr), "f"(a), "f"(b), "f"(c), "f"(d),
      "r"(bar) : "memory");
}

__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// The share of a max's gradient that goes to its first operand, as autograd
// splits it: 1, 0, or 1/2 at a tie.
__device__ __forceinline__ float first_arm(float a, float b) {
  return a > b ? 1.f : (a < b ? 0.f : 0.5f);
}

// --------------------------------------------------------------- mLSTM prep
// A block a (b, h), 32 ceil(hd / 32) threads, thread c a column of n;
// chunks of kPChunk steps: every thread first loads its column of the
// chunk's k, q, dy and y into registers (all in flight at once: a load a
// step waited on each), warp 0 walks the chunk's m chain (lanes = steps),
// then every thread its column of n, each step's n . q and dy . y summed
// by warp shuffles and, across warps, in shared memory.
__global__ void __launch_bounds__(256)
mlstm_bwd_prep_kernel(const MlstmBwdArgs a) {
  __shared__ float fp_s[kPChunk], ip_s[kPChunk];
  __shared__ float red_nq[kPChunk][8], red_dy[kPChunk][8];
  const int b = blockIdx.x / a.H, h = blockIdx.x % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int nwarps = blockDim.x >> 5;
  const int c = threadIdx.x;
  const bool col = c < a.hd;
  const long long row0 = static_cast<long long>(b) * a.S * a.H + h;  // t = 0
  float m_run = 0.f, n = 0.f;
  for (int t0 = 0; t0 < a.S; t0 += kPChunk) {
    const int nt = min(kPChunk, a.S - t0);
    float kr[kPChunk], qr[kPChunk], dr[kPChunk], yr[kPChunk];
#pragma unroll
    for (int u = 0; u < kPChunk; ++u) {
      const bool ok = col && u < nt;
      const long long e =
          ok ? (row0 + static_cast<long long>(t0 + u) * a.H) * a.hd + c : 0;
      kr[u] = ok ? a.k[e] : 0.f;
      qr[u] = ok ? a.q[e] : 0.f;
      dr[u] = ok ? a.dy[e] : 0.f;
      yr[u] = ok ? a.y[e] : 0.f;
    }
    if (warp == 0) {
      const int t = t0 + lane;
      const bool ok = lane < nt;
      const long long s = row0 + static_cast<long long>(t) * a.H;
      const float iv = ok ? a.i[s] : 0.f;
      const float lf = log_sigmoid(ok ? a.f[s] : 0.f);
      float m_prev = 0.f, m_new = 0.f;
#pragma unroll
      for (int u = 0; u < kPChunk; ++u) {
        const float lfu = __shfl_sync(0xffffffffu, lf, u);
        const float iu = __shfl_sync(0xffffffffu, iv, u);
        const float mp = m_run;
        if (u < nt) m_run = fmaxf(lfu + m_run, iu);
        if (lane == u) {
          m_prev = mp;
          m_new = m_run;
        }
      }
      const float mf = lf + m_prev;
      const float fpv = expf(mf - m_new);
      const float ipv = expf(iv - m_new);
      fp_s[lane] = fpv;
      ip_s[lane] = ipv;
      if (ok) {
        a.fp[s] = fpv;
        a.ip[s] = ipv;
        a.sel[s] = first_arm(mf, iv);
      }
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kPChunk; ++u) {
      if (u < nt)
        n = __fadd_rn(__fmul_rn(fp_s[u], n), __fmul_rn(ip_s[u], kr[u]));
      float nq = n * qr[u], dyy = dr[u] * yr[u];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) {
        nq += __shfl_xor_sync(0xffffffffu, nq, off);
        dyy += __shfl_xor_sync(0xffffffffu, dyy, off);
      }
      if (lane == 0) {
        red_nq[u][warp] = nq;
        red_dy[u][warp] = dyy;
      }
    }
    __syncthreads();
    if (warp == 0 && lane < nt) {
      float dot = 0.f, dyy = 0.f;
      for (int w = 0; w < nwarps; ++w) {
        dot += red_nq[lane][w];
        dyy += red_dy[lane][w];
      }
      const float den = fmaxf(fabsf(dot), 1.f);
      const float gv = fabsf(dot) >= 1.f ? (dot > 0.f ? -dyy : dyy) / den
                                         : 0.f;
      const long long s = row0 + static_cast<long long>(t0 + lane) * a.H;
      a.den[s] = den;
      a.g[s] = gv;
    }
    __syncthreads();
  }
}

// ---------------------------------------------------------------- mLSTM A, B
// Shared memory of an mlstm_bwd_kernel block, in floats: two stages of
// q, k [kBChunk][kBBand] (the band's columns), v, dy [kBChunk][HD] and the
// prep's f', i', den, g [kBChunk]; then, a step of the chunk being walked,
// the factor C (or dC) is rescaled by before it, the step's coefficient of
// its outer product, F (or P) and g / P; then the chunk's per-warp column
// sums [kBChunk][kBWarps][kBBand], warp 0's n (or dn) [kBChunk][kBBand]
// and the band's dv parts [kBChunk][HD].
template <int D16>
struct BSmem {
  static constexpr int HD = 16 * D16;
  static constexpr int kQ = 0;
  static constexpr int kK = kQ + kBChunk * kBBand;
  static constexpr int kV = kK + kBChunk * kBBand;
  static constexpr int kDy = kV + kBChunk * HD;
  static constexpr int kFp = kDy + kBChunk * HD;
  static constexpr int kIp = kFp + kBChunk;
  static constexpr int kDen = kIp + kBChunk;
  static constexpr int kG = kDen + kBChunk;
  static constexpr int kStage = kG + kBChunk;      // a multiple of 4 floats
  static constexpr int kRs = 2 * kStage;
  static constexpr int kCoef = kRs + kBChunk;
  static constexpr int kScale = kCoef + kBChunk;
  static constexpr int kGc = kScale + kBChunk;
  static constexpr int kPart = kGc + kBChunk;
  static constexpr int kN = kPart + kBChunk * kBWarps * kBBand;
  static constexpr int kDvp = kN + kBChunk * kBBand;
  static constexpr int kBytes = (kDvp + kBChunk * HD) * 4;
};

// The chunk of steps [t0, t0 + kBChunk) of (b, h) into stage `st`,
// zero-filled past S.
template <int D16>
__device__ __forceinline__ void b_load(const MlstmBwdArgs& a, float* st,
                                       int b, int h, int band, int t0) {
  using L = BSmem<D16>;
  constexpr int HD = L::HD;
  for (int p = threadIdx.x; p < kBChunk * (HD / 4); p += kBThreads) {
    const int s = p / (HD / 4), c4 = p % (HD / 4), t = t0 + s;
    const bool ok = t < a.S;
    const long long off =
        ok ? ((static_cast<long long>(b) * a.S + t) * a.H + h) * HD + 4 * c4
           : 0;
    cp_async16(smem_addr(st + L::kV + s * HD + 4 * c4), a.v + off,
               ok ? 16 : 0);
    cp_async16(smem_addr(st + L::kDy + s * HD + 4 * c4), a.dy + off,
               ok ? 16 : 0);
  }
  for (int p = threadIdx.x; p < kBChunk * kBBand / 4; p += kBThreads) {
    const int s = p / (kBBand / 4), c4 = p % (kBBand / 4), t = t0 + s;
    const bool ok = t < a.S;
    const long long off =
        ok ? ((static_cast<long long>(b) * a.S + t) * a.H + h) * HD
                 + band * kBBand + 4 * c4
           : 0;
    cp_async16(smem_addr(st + L::kQ + s * kBBand + 4 * c4), a.q + off,
               ok ? 16 : 0);
    cp_async16(smem_addr(st + L::kK + s * kBBand + 4 * c4), a.k + off,
               ok ? 16 : 0);
  }
  for (int s = threadIdx.x; s < kBChunk; s += kBThreads) {
    const int t = t0 + s;
    const bool ok = t < a.S;
    const long long off =
        ok ? (static_cast<long long>(b) * a.S + t) * a.H + h : 0;
    cp_async4(smem_addr(st + L::kFp + s), a.fp + off, ok ? 4 : 0);
    cp_async4(smem_addr(st + L::kIp + s), a.ip + off, ok ? 4 : 0);
    cp_async4(smem_addr(st + L::kDen + s), a.den + off, ok ? 4 : 0);
    cp_async4(smem_addr(st + L::kG + s), a.g + off, ok ? 4 : 0);
  }
}

// A column pair's sums over the warp's 4 row groups (lane bits 3, 4).
__device__ __forceinline__ void sum_row_groups(float& x0, float& x1) {
#pragma unroll
  for (int off = 8; off <= 16; off <<= 1) {
    x0 += __shfl_xor_sync(0xffffffffu, x0, off);
    x1 += __shfl_xor_sync(0xffffffffu, x1, off);
  }
}

// The chunk's per-step outputs over the band's 16 columns: e = (step,
// column), 16 steps x 16 columns over the block's 128 threads in two
// rounds; `out(tt, col)` computes, stores and returns the output, whose
// product with `with` [tt][col] is summed over the 16 columns (a
// half-warp) into `part` [t].
template <class Out>
__device__ __forceinline__ void band_outputs(int nt, const float* with,
                                             float* part, long long pstep,
                                             Out out) {
#pragma unroll
  for (int e0 = 0; e0 < kBChunk * kBBand; e0 += kBThreads) {
    const int e = e0 + threadIdx.x, tt = e / kBBand, cc = e % kBBand;
    const bool ok = tt < nt;
    float x = ok ? out(tt, cc) * with[tt * kBBand + cc] : 0.f;
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      x += __shfl_xor_sync(0xffffffffu, x, off);
    if (ok && cc == 0) part[tt * pstep] = x;
  }
}

template <int D16>
__global__ void __launch_bounds__(kBThreads)
mlstm_bwd_kernel(const MlstmBwdArgs a) {
  using L = BSmem<D16>;
  constexpr int HD = L::HD;
  constexpr int V8 = (D16 + 7) / 8 * 8;        // dv values a thread, padded
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  const int band = blockIdx.x;
  const int b = blockIdx.y / a.H, h = blockIdx.y % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int cp2 = lane & 7;                    // columns 2 cp2, 2 cp2 + 1
  const int rslot = warp * 4 + (lane >> 3);    // rows rslot + 16 j
  const int chunks = (a.S + kBChunk - 1) / kBChunk;
  const long long bsh0 = static_cast<long long>(b) * a.S * a.H + h;
  const long long tstep = a.H;                 // (b, t, h) per step
  const long long pstride = static_cast<long long>(a.B) * a.S * a.H;
  float c[D16][2];
  float n0 = 0.f, n1 = 0.f;
#pragma unroll
  for (int j = 0; j < D16; ++j) c[j][0] = c[j][1] = 0.f;

  // ---- pass A, forward: C, n (divided by F) and dq
  float f_run = 1.f;                           // warp 0: F
  b_load<D16>(a, sm, b, h, band, 0);
  cp_async_commit();
  for (int ci = 0; ci < chunks; ++ci) {
    const int t0 = ci * kBChunk;
    if (ci + 1 < chunks)
      b_load<D16>(a, sm + ((ci + 1) & 1) * L::kStage, b, h, band,
                  t0 + kBChunk);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* st = sm + (ci & 1) * L::kStage;
    const int nt = min(kBChunk, a.S - t0);
    if (warp == 0) {
      const float fp = lane < kBChunk ? st[L::kFp + lane] : 1.f;
      float rs = 1.f, f_t = 1.f;
#pragma unroll
      for (int u = 0; u < kBChunk; ++u) {
        const float cand = f_run * __shfl_sync(0xffffffffu, fp, u);
        const bool fold = cand < kMFloor;
        if (lane == u) {
          rs = fold ? cand : 1.f;
          f_t = fold ? 1.f : cand;
        }
        if (u < nt) f_run = fold ? 1.f : cand;
      }
      if (lane < kBChunk) {
        sm[L::kRs + lane] = rs;
        sm[L::kCoef + lane] = st[L::kIp + lane] / f_t;
        sm[L::kScale + lane] = f_t;
      }
    }
    __syncthreads();
    for (int tt = 0; tt < nt; ++tt) {
      const float rs = sm[L::kRs + tt], at = sm[L::kCoef + tt];
      if (rs != 1.f) {                         // the same for the whole block
        n0 *= rs;
        n1 *= rs;
#pragma unroll
        for (int j = 0; j < D16; ++j) {
          c[j][0] *= rs;
          c[j][1] *= rs;
        }
      }
      const float2 kk =
          *reinterpret_cast<const float2*>(st + L::kK + tt * kBBand + 2 * cp2);
      float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
      for (int j = 0; j < D16; ++j) {
        const int r = rslot + 16 * j;
        const float av = at * st[L::kV + tt * HD + r];
        const float dyv = st[L::kDy + tt * HD + r];
        c[j][0] = fmaf(av, kk.x, c[j][0]);
        c[j][1] = fmaf(av, kk.y, c[j][1]);
        acc0 = fmaf(c[j][0], dyv, acc0);
        acc1 = fmaf(c[j][1], dyv, acc1);
      }
      n0 = fmaf(at, kk.x, n0);
      n1 = fmaf(at, kk.y, n1);
      sum_row_groups(acc0, acc1);
      if (lane < 8) {
        float* part = sm + L::kPart + (tt * kBWarps + warp) * kBBand;
        part[2 * cp2] = acc0;
        part[2 * cp2 + 1] = acc1;
        if (warp == 0) {
          sm[L::kN + tt * kBBand + 2 * cp2] = n0;
          sm[L::kN + tt * kBBand + 2 * cp2 + 1] = n1;
        }
      }
    }
    __syncthreads();
    // dq_t = F (C^T dy / den + g n): its band, and the band's q . dq
    band_outputs(
        nt, st + L::kQ, a.pq + band * pstride + bsh0 + t0 * tstep, tstep,
        [&](int tt, int cc) {
          const float* part = sm + L::kPart + tt * kBWarps * kBBand + cc;
          float sum = part[0];
#pragma unroll
          for (int w = 1; w < kBWarps; ++w) sum += part[w * kBBand];
          const float dq = sm[L::kScale + tt]
              * (sum / st[L::kDen + tt]
                 + st[L::kG + tt] * sm[L::kN + tt * kBBand + cc]);
          a.dq[(bsh0 + (t0 + tt) * tstep) * HD + band * kBBand + cc] = dq;
          return dq;
        });
    __syncthreads();                           // the stage, before reuse
  }

  // ---- pass B, reverse: dC, dn (divided by P), dk and dv's parts
#pragma unroll
  for (int j = 0; j < D16; ++j) c[j][0] = c[j][1] = 0.f;
  n0 = n1 = 0.f;
  float p_run = 1.f, fp_next = 1.f;            // warp 0: P, f' of the step after
  b_load<D16>(a, sm, b, h, band, (chunks - 1) * kBChunk);
  cp_async_commit();
  for (int ci = chunks - 1, it = 0; ci >= 0; --ci, ++it) {
    const int t0 = ci * kBChunk;
    if (ci > 0)
      b_load<D16>(a, sm + ((it + 1) & 1) * L::kStage, b, h, band,
                  t0 - kBChunk);
    cp_async_commit();
    cp_async_wait1();
    __syncthreads();
    const float* st = sm + (it & 1) * L::kStage;
    const int nt = min(kBChunk, a.S - t0);
    if (warp == 0) {
      // dC_t = f'_{t+1} dC_{t+1} + ...: the factor into step t is the next
      // step's f' (the first step of the chunk walked before, for the last)
      const float fp = lane < kBChunk ? st[L::kFp + lane] : 1.f;
      float rs = 1.f, p_t = 1.f;
#pragma unroll
      for (int u = kBChunk - 1; u >= 0; --u) {
        const float fac =
            u == nt - 1 ? fp_next
                        : __shfl_sync(0xffffffffu, fp, min(u + 1, kBChunk - 1));
        const float cand = p_run * fac;
        const bool fold = cand < kMFloor;
        if (lane == u) {
          rs = fold ? cand : 1.f;
          p_t = fold ? 1.f : cand;
        }
        if (u < nt) p_run = fold ? 1.f : cand;
      }
      fp_next = __shfl_sync(0xffffffffu, fp, 0);
      if (lane < kBChunk) {
        sm[L::kRs + lane] = rs;
        sm[L::kCoef + lane] = 1.f / (st[L::kDen + lane] * p_t);
        sm[L::kScale + lane] = p_t;
        sm[L::kGc + lane] = st[L::kG + lane] / p_t;
      }
    }
    __syncthreads();
    for (int tt = nt - 1; tt >= 0; --tt) {
      const float rs = sm[L::kRs + tt], bt = sm[L::kCoef + tt];
      if (rs != 1.f) {
        n0 *= rs;
        n1 *= rs;
#pragma unroll
        for (int j = 0; j < D16; ++j) {
          c[j][0] *= rs;
          c[j][1] *= rs;
        }
      }
      const float2 qq =
          *reinterpret_cast<const float2*>(st + L::kQ + tt * kBBand + 2 * cp2);
      const float2 kk =
          *reinterpret_cast<const float2*>(st + L::kK + tt * kBBand + 2 * cp2);
      float acc0 = 0.f, acc1 = 0.f;
      float dv[V8];
#pragma unroll
      for (int j = 0; j < V8; ++j) dv[j] = 0.f;
#pragma unroll
      for (int j = 0; j < D16; ++j) {
        const int r = rslot + 16 * j;
        const float ad = bt * st[L::kDy + tt * HD + r];
        const float vv = st[L::kV + tt * HD + r];
        c[j][0] = fmaf(ad, qq.x, c[j][0]);
        c[j][1] = fmaf(ad, qq.y, c[j][1]);
        acc0 = fmaf(c[j][0], vv, acc0);
        acc1 = fmaf(c[j][1], vv, acc1);
        dv[j] = fmaf(c[j][0], kk.x, c[j][1] * kk.y);
      }
      const float gc = sm[L::kGc + tt];
      n0 = fmaf(gc, qq.x, n0);
      n1 = fmaf(gc, qq.y, n1);
      sum_row_groups(acc0, acc1);
      if (lane < 8) {
        float* part = sm + L::kPart + (tt * kBWarps + warp) * kBBand;
        part[2 * cp2] = acc0;
        part[2 * cp2 + 1] = acc1;
        if (warp == 0) {
          sm[L::kN + tt * kBBand + 2 * cp2] = n0;
          sm[L::kN + tt * kBBand + 2 * cp2 + 1] = n1;
        }
      }
      // dv's sums over the 8 column pairs (lane bits 0-2): a transposing
      // butterfly leaves lane cp2 with rows j in [cp2 V8/8, (cp2+1) V8/8)
      int cnt = V8;
#pragma unroll
      for (int o = 4; o > 0; o >>= 1) {
        const bool up = lane & o;
#pragma unroll
        for (int e = 0; e < V8 / 2; ++e) {
          if (e < cnt / 2) {
            const float mine = up ? dv[e + cnt / 2] : dv[e];
            const float give = up ? dv[e] : dv[e + cnt / 2];
            dv[e] = mine + __shfl_xor_sync(0xffffffffu, give, o);
          }
        }
        cnt /= 2;
      }
#pragma unroll
      for (int e = 0; e < V8 / 8; ++e) {
        const int j = cp2 * (V8 / 8) + e;
        if (j < D16) sm[L::kDvp + tt * HD + rslot + 16 * j] = dv[e];
      }
    }
    __syncthreads();
    // dk_t = i' P (dC^T v + dn) (its band, and the band's k . dk), and the
    // band's part of dv_t = i' P dC k
    band_outputs(
        nt, st + L::kK, a.pk + band * pstride + bsh0 + t0 * tstep, tstep,
        [&](int tt, int cc) {
          const float* part = sm + L::kPart + tt * kBWarps * kBBand + cc;
          float sum = part[0];
#pragma unroll
          for (int w = 1; w < kBWarps; ++w) sum += part[w * kBBand];
          const float dk = st[L::kIp + tt] * sm[L::kScale + tt]
              * (sum + sm[L::kN + tt * kBBand + cc]);
          a.dk[(bsh0 + (t0 + tt) * tstep) * HD + band * kBBand + cc] = dk;
          return dk;
        });
    float* dvp = a.dv_part + band * pstride * HD;
    for (int e = threadIdx.x; e < nt * HD; e += kBThreads) {
      const int tt = e / HD, r = e % HD;
      dvp[(bsh0 + (t0 + tt) * tstep) * HD + r] =
          st[L::kIp + tt] * sm[L::kScale + tt] * sm[L::kDvp + e];
    }
    __syncthreads();
  }
}

// ------------------------------------------------------------- mLSTM reduce
// Blocks [0, gate_blocks): a warp a (b, h) walks the gates in reverse, 32
// steps a chunk (lane = step); the rest: dv = the bands' parts summed in
// band order, 4 floats a thread.
__global__ void __launch_bounds__(kRThreads)
mlstm_bwd_reduce_kernel(const MlstmBwdArgs a, int gate_blocks) {
  const int bands = a.hd / 16;
  const long long pstride = static_cast<long long>(a.B) * a.S * a.H;
  if (static_cast<int>(blockIdx.x) >= gate_blocks) {
    const long long e4 =
        (static_cast<long long>(blockIdx.x - gate_blocks) * kRThreads
         + threadIdx.x) * 4;
    if (e4 >= pstride * a.hd) return;
    float4 sum = *reinterpret_cast<const float4*>(a.dv_part + e4);
    for (int j = 1; j < bands; ++j) {
      const float4 x =
          *reinterpret_cast<const float4*>(a.dv_part + j * pstride * a.hd
                                           + e4);
      sum.x += x.x;
      sum.y += x.y;
      sum.z += x.z;
      sum.w += x.w;
    }
    *reinterpret_cast<float4*>(a.dv + e4) = sum;
    return;
  }
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x * (kRThreads / 32) + (threadIdx.x >> 5);
  if (bh >= a.B * a.H) return;                 // whole warps
  const int b = bh / a.H, h = bh % a.H;
  const long long bsh0 = static_cast<long long>(b) * a.S * a.H + h;
  float a_carry = 0.f, m_carry = 0.f;          // sum_{u >= t0+32} s_u; M
  for (int t0 = (a.S - 1) / kPChunk * kPChunk; t0 >= 0; t0 -= kPChunk) {
    const int t = t0 + lane;
    const bool ok = t < a.S;
    const long long s = bsh0 + static_cast<long long>(t) * a.H;
    float qdq = 0.f, kdk = 0.f, sel = 1.f, fv = 0.f;
    if (ok) {
      for (int j = 0; j < bands; ++j) {
        qdq += a.pq[j * pstride + s];
        kdk += a.pk[j * pstride + s];
      }
      sel = a.sel[s];
      fv = a.f[s];
    }
    // a_t = a_carry + sum_{u >= t} (q . dq - k . dk)_u: a suffix scan
    float at = qdq - kdk;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float x = __shfl_down_sync(0xffffffffu, at, o);
      if (lane + o < 32) at += x;
    }
    at += a_carry;
    a_carry = __shfl_sync(0xffffffffu, at, 0);
    // M entering step t from t + 1: M_{t-1} = sel_t M_t + beta_t, composed
    // over the lanes above by an affine suffix scan (identity past S)
    float al = ok ? sel : 1.f;
    float be = ok ? at - sel * (at + kdk) : 0.f;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const float al_o = __shfl_down_sync(0xffffffffu, al, o);
      const float be_o = __shfl_down_sync(0xffffffffu, be, o);
      if (lane + o < 32) {
        be = fmaf(al, be_o, be);
        al *= al_o;
      }
    }
    const float al_up = __shfl_down_sync(0xffffffffu, al, 1);
    const float be_up = __shfl_down_sync(0xffffffffu, be, 1);
    const float m_in = lane < 31 ? fmaf(al_up, m_carry, be_up) : m_carry;
    const float m_next =
        fmaf(__shfl_sync(0xffffffffu, al, 0), m_carry,
             __shfl_sync(0xffffffffu, be, 0));
    if (ok) {
      const float rest = m_in - at - kdk;
      const float dlf = fmaf(sel, rest, at);
      a.di[s] = fmaf(1.f - sel, rest, kdk);
      a.df[s] = dlf / (1.f + expf(fv));        // d log_sigmoid = sigmoid(-f)
    }
    m_carry = m_next;
  }
}

// ------------------------------------------------------------ sLSTM backward
template <int D16>
constexpr int kBSThreads = 32 * D16;     // a warp two output rows: hd / 8

template <int D16>
__global__ void __launch_bounds__(kBSThreads<D16>, 1)
    slstm_scan_bwd_kernel(const SlstmBwdArgs a) {
  constexpr int HD = 16 * D16;
  constexpr int RB = HD / kSCluster;       // rows a block, two a warp
  constexpr int kCells = RB * kSBatch;     // (row, batch row) cells a block
  constexpr int kCellThreads = (kCells + 31) / 32 * 32;
  constexpr int kPieces = 4 * RB;          // 16-byte pieces of its dp
  constexpr int kBytes = 4 * HD * kSBatch * 4;   // dp a step, all blocks
  __shared__ __align__(16) float dpbuf[2][4][HD][kSBatch];
  __shared__ __align__(16) float dploc[4][RB][kSBatch];
  __shared__ float rec_s[RB][kSBatch];
  __shared__ __align__(8) uint64_t mbar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // matvec: warp wp owns output rows 2 wp, 2 wp + 1 of the block; lane
  // holds W_g[v, w] for v = 32 jj + lane (zero past hd). The transposing
  // reduction leaves lane l with sum 8 l / 32 = (row, batch row).
  constexpr int kW = (HD + 31) / 32;
  constexpr int kV = 2 * kSBatch;
  const int vi = lane * kV / 32, rr = vi / kSBatch, hi = vi % kSBatch;
  const bool writer = lane % (32 / kV) == 0;
  const int h = blockIdx.z;
  const int b0 = blockIdx.y * kSBatch;

  float wt[2][4][kW];
#pragma unroll
  for (int q = 0; q < 2; ++q) {
    const int w = rank * RB + 2 * warp + q;
#pragma unroll
    for (int gg = 0; gg < 4; ++gg)
#pragma unroll
      for (int jj = 0; jj < kW; ++jj) {
        const int v = 32 * jj + lane;
        wt[q][gg][jj] =
            v < HD ? a.w_r[((static_cast<long long>(gg) * a.H + h) * HD + v)
                           * HD + w]
                   : 0.f;
      }
  }
  for (int e = threadIdx.x; e < RB * kSBatch; e += blockDim.x)
    (&rec_s[0][0])[e] = 0.f;
  const auto bar0 = smem_addr(&mbar[0]), bar1 = smem_addr(&mbar[1]);
  if (threadIdx.x == 0) {
    mbar_init(bar0, 1);
    mbar_init(bar1, 1);
    mbar_expect(bar0, kBytes);
    mbar_expect(bar1, kBytes);
  }

  // the cell thread of (row rank RB + cr, batch row b0 + cb); its trails at
  // [b][t][h][r] (p at [b][t][g][h][r])
  const int cr = threadIdx.x % RB, cb = threadIdx.x / RB;
  const bool cell = threadIdx.x < kCells;
  const bool cvalid = cell && b0 + cb < a.B;
  const long long ystep = static_cast<long long>(a.H) * HD;
  const long long base =
      (static_cast<long long>(cvalid ? b0 + cb : 0) * a.S * a.H + h) * HD
      + rank * RB + cr;                       // t = 0
  const long long pbase = base + (base / ystep) * 3 * ystep;
  // step t's p (4 gates), dy and the state before it (c, n, m of t - 1)
  float pr[kSAhead][4], sr[kSAhead][3], dyr[kSAhead];
  auto load = [&](int j, int t) {
    const bool ok = cvalid && t >= 0 && t < a.S;
    const bool prev = ok && t > 0;
#pragma unroll
    for (int gg = 0; gg < 4; ++gg)
      pr[j][gg] = ok ? a.p[pbase + (4LL * t + gg) * ystep] : 0.f;
    dyr[j] = ok ? a.dy[base + t * ystep] : 0.f;
    sr[j][0] = prev ? a.c[base + (t - 1) * ystep] : 0.f;
    sr[j][1] = prev ? a.n[base + (t - 1) * ystep] : 0.f;
    sr[j][2] = prev ? a.m[base + (t - 1) * ystep] : 0.f;
  };
#pragma unroll
  for (int j = 0; j < kSAhead; ++j) load(j, a.S - 1 - j);
  float dc = 0.f, dn = 0.f, dm = 0.f;
  cluster.sync();              // barriers set up everywhere
  for (int u0 = 0; u0 < a.S; u0 += kSAhead) {
#pragma unroll
    for (int j = 0; j < kSAhead; ++j) {
      const int u = u0 + j, t = a.S - 1 - u;   // u: steps walked before
      if (t < 0) break;
      if (threadIdx.x < kCellThreads) {
        if (cell) {
          // the forward's cell at step t, rounded as it rounds
          const float pi = pr[j][0], pf = pr[j][1], pz = pr[j][2],
                      po = pr[j][3];
          const float c0 = sr[j][0], n0 = sr[j][1], m0 = sr[j][2];
          const float dy = dyr[j];
          load(j, t - kSAhead);
          const float mf = __fadd_rn(log_sigmoid(pf), m0);
          const float m_new = fmaxf(mf, pi);
          const float ip = expf(__fsub_rn(pi, m_new));
          const float fp = expf(__fsub_rn(mf, m_new));
          const float tz = tanhf(pz);
          const float c = __fadd_rn(__fmul_rn(fp, c0), __fmul_rn(ip, tz));
          const float n = __fadd_rn(__fmul_rn(fp, n0), ip);
          const float sig = __fdiv_rn(1.f, __fadd_rn(1.f, expf(-po)));
          const float nc = fmaxf(n, 1.f);
          // back through h = sig c / nc, then the chains and the gates
          const float dh = dy + rec_s[cr][cb];
          const float dhn = dh / nc;
          const float dct = dc + dhn * sig;
          const float dnt = n >= 1.f ? dn - dhn * sig * c / nc : dn;
          const float dpo = dhn * c * sig * (1.f - sig);
          const float dfp = dct * c0 + dnt * n0;
          const float dip = dct * tz + dnt;
          const float dpz = dct * ip * (1.f - tz * tz);
          const float rest = dm - dip * ip - dfp * fp;
          const float sel = first_arm(mf, pi);
          const float dmf = dfp * fp + sel * rest;
          const float dpi = dip * ip + (1.f - sel) * rest;
          const float dpf = dmf / (1.f + expf(pf));
          dc = dct * fp;
          dn = dnt * fp;
          dm = dmf;
          const float dp[4] = {dpi, dpf, dpz, dpo};
#pragma unroll
          for (int gg = 0; gg < 4; ++gg) {
            dploc[gg][cr][cb] = dp[gg];
            if (cvalid) a.dpre[pbase + (4LL * t + gg) * ystep] = dp[gg];
          }
        }
        // the block's dp_t, 4 x RB x kSBatch floats, to every block of the
        // cluster, into buffer u & 1 (nobody reads step 0's)
        named_barrier(1, kCellThreads);
        if (t > 0) {
          const auto bar = u & 1 ? bar1 : bar0;
          for (int e = threadIdx.x; e < kPieces * kSCluster;
               e += kCellThreads) {
            const int to = e / kPieces, pc = e % kPieces;
            const int gg = pc / RB, r = pc % RB;
            const float4 v =
                *reinterpret_cast<const float4*>(&dploc[gg][r][0]);
            st_async4(map_rank(smem_addr(&dpbuf[u & 1][gg][rank * RB + r][0]),
                               to),
                      v.x, v.y, v.z, v.w, map_rank(bar, to));
          }
        }
      }
      if (t == 0) break;
      // buffer u & 1 holds dp_t once every block's rows have landed; then
      // this block arms the buffer's next phase (dp_{t-2})
      const auto bar = u & 1 ? bar1 : bar0;
      mbar_wait(bar, (u >> 1) & 1);
      if (threadIdx.x == 0) mbar_expect(bar, kBytes);
      float s[kV];
#pragma unroll
      for (int e = 0; e < kV; ++e) s[e] = 0.f;
#pragma unroll
      for (int gg = 0; gg < 4; ++gg)
#pragma unroll
        for (int jj = 0; jj < kW; ++jj) {
          const int v = min(32 * jj + lane, HD - 1);  // past hd: weight 0
          const float4 d =
              *reinterpret_cast<const float4*>(&dpbuf[u & 1][gg][v][0]);
          const float dv[kSBatch] = {d.x, d.y, d.z, d.w};
#pragma unroll
          for (int q = 0; q < 2; ++q)
#pragma unroll
            for (int bb = 0; bb < kSBatch; ++bb)
              s[q * kSBatch + bb] =
                  fmaf(wt[q][gg][jj], dv[bb], s[q * kSBatch + bb]);
        }
      int cnt = kV;
#pragma unroll
      for (int o = 16; o > 0; o >>= 1) {
        if (cnt > 1) {
          const bool up = lane & o;
#pragma unroll
          for (int e = 0; e < kV / 2; ++e) {
            if (e < cnt / 2) {
              const float mine = up ? s[e + cnt / 2] : s[e];
              const float give = up ? s[e] : s[e + cnt / 2];
              s[e] = mine + __shfl_xor_sync(0xffffffffu, give, o);
            }
          }
          cnt /= 2;
        } else {
          s[0] += __shfl_xor_sync(0xffffffffu, s[0], o);
        }
      }
      if (writer) rec_s[2 * warp + rr][hi] = s[0];
      __syncthreads();
    }
  }
  cluster.sync();              // no block leaves while the others run
}

template <int D16>
cudaLaunchConfig_t slstm_bwd_config(int batch, int heads, cudaStream_t s,
                                    cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kSCluster, (batch + kSBatch - 1) / kSBatch, heads);
  cfg.blockDim = dim3(kBSThreads<D16>);
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
int launch_slstm_bwd(const SlstmBwdArgs& a, cudaStream_t s) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = slstm_bwd_config<D16>(a.B, a.H, s, &attr);
  const cudaError_t err =
      cudaLaunchKernelEx(&cfg, slstm_scan_bwd_kernel<D16>, a);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

template <int D16>
int slstm_bwd_clusters_t(int batch, int heads) {
  int n = 0;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      slstm_bwd_config<D16>(batch, heads, nullptr, &attr);
  const cudaError_t err =
      cudaOccupancyMaxActiveClusters(&n, slstm_scan_bwd_kernel<D16>, &cfg);
  return err == cudaSuccess ? n : 0;
}

template <int D16>
int launch_mlstm_bwd(const MlstmBwdArgs& a, cudaStream_t s) {
  using L = BSmem<D16>;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_bwd_kernel<D16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  mlstm_bwd_kernel<D16><<<dim3(D16, a.B * a.H), kBThreads, L::kBytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D16>
int mlstm_bwd_blocks_per_sm_t() {
  using L = BSmem<D16>;
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_bwd_kernel<D16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, mlstm_bwd_kernel<D16>, kBThreads, L::kBytes);
  return err == cudaSuccess ? n : 0;
}

template <int D16>
int mlstm_bwd_smem_t() {
  return BSmem<D16>::kBytes;
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

int gate_blocks(const MlstmBwdArgs& a) {
  return (a.B * a.H + kRThreads / 32 - 1) / (kRThreads / 32);
}

}  // namespace

// Plain C entry points for ctypes. A launch returns cudaGetLastError()
// after it (0 = cudaSuccess), kBadHeadDim or kBadGrid; it is asynchronous
// on `stream`. The mLSTM's three run in order on one stream: prep, the
// passes, reduce.
extern "C" int mlstm_bwd_prep_f32(const MlstmBwdArgs* a, void* stream) {
  if (!good_hd(a->hd)) return kBadHeadDim;
  mlstm_bwd_prep_kernel<<<a->B * a->H, (a->hd + 31) / 32 * 32, 0,
                          static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mlstm_bwd_f32(const MlstmBwdArgs* a, void* stream) {
  const int hd = a->hd;
  if (!good_hd(hd)) return kBadHeadDim;
  if (static_cast<long long>(a->B) * a->H > kMaxGridYZ) return kBadGrid;
  XLSTM_HD_CASES(launch_mlstm_bwd, *a, static_cast<cudaStream_t>(stream))
  return kBadHeadDim;
}

extern "C" int mlstm_bwd_reduce_f32(const MlstmBwdArgs* a, void* stream) {
  if (!good_hd(a->hd)) return kBadHeadDim;
  const long long n4 = static_cast<long long>(a->B) * a->S * a->H * a->hd / 4;
  const long long blocks = gate_blocks(*a) + (n4 + kRThreads - 1) / kRThreads;
  if (blocks > 0x7fffffffLL) return kBadGrid;
  mlstm_bwd_reduce_kernel<<<static_cast<unsigned>(blocks), kRThreads, 0,
                            static_cast<cudaStream_t>(stream)>>>(
      *a, gate_blocks(*a));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int slstm_scan_bwd_f32(const SlstmBwdArgs* a, void* stream) {
  const int hd = a->hd;
  if (!good_hd(hd)) return kBadHeadDim;
  if ((a->B + kSBatch - 1) / kSBatch > kMaxGridYZ || a->H > kMaxGridYZ)
    return kBadGrid;
  XLSTM_HD_CASES(launch_slstm_bwd, *a, static_cast<cudaStream_t>(stream))
  return kBadHeadDim;
}

// mlstm_bwd_kernel's blocks an SM and dynamic shared memory a block in
// bytes at head dim hd; slstm_scan_bwd_kernel's clusters the card holds at
// once for `batch` rows and `heads` heads (0 on error).
extern "C" int mlstm_bwd_blocks_per_sm(int hd) {
  if (!good_hd(hd)) return 0;
  XLSTM_HD_CASES(mlstm_bwd_blocks_per_sm_t)
  return 0;
}

extern "C" int mlstm_bwd_smem_bytes(int hd) {
  if (!good_hd(hd)) return 0;
  XLSTM_HD_CASES(mlstm_bwd_smem_t)
  return 0;
}

extern "C" int slstm_bwd_max_active_clusters(int hd, int batch, int heads) {
  if (!good_hd(hd)) return 0;
  XLSTM_HD_CASES(slstm_bwd_clusters_t, batch, heads)
  return 0;
}

extern "C" const char* xlstm_scan_bwd_error_string(int code) {
  if (code == kBadHeadDim)
    return "head dim has no kernel (a multiple of 16 up to 256)";
  if (code == kBadGrid) return "too many batch rows or heads for the grid";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
