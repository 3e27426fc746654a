// The backward of xLSTM's two recurrences (csrc/xlstm_scan.cu), for
// Hopper: the mLSTM's in the chunkwise form in four kernels, the sLSTM's
// reverse walk in one.
//
// No TPU kernel is replaced: the JAX package differentiates its lax.scan
// bodies (repro/models/ssm.py:_mlstm_step and _slstm_step inside
// chunked_scan) with jax.grad. Plain versions, which split the work into
// the same passes: repro_torch/kernels/ref.py: mlstm_scan_bwd_chunkwise_ref
// and slstm_scan_dpre_affine_ref. Wrapper, autograd Functions, checks and
// launch counts: repro_torch/kernels/xlstm_scan.py. Inputs and outputs
// are f32 and contiguous; hd is a multiple of 16 up to 256.
//
// ---------------------------------------------------------------------
// mLSTM, in the forward's notation (xlstm_scan.cu): chunks of L = 64
// steps, each with the state (C, n, m) before it, which the forward keeps
// for its backward (C^T, n, m in scratch, and den'_t = e_t n . q_t +
// sum_s D_ts k_s . q_t, the signed denominator that produced y_t, so that
// den_t = max(|den'_t|, 1) here is the forward's own); b, c = i - b and
// M_t = max(m, max_{s<=t} c_s) in double, D_ts = exp(c_s - M_t),
// e_t = exp(m - M_t), w_s = D_{L-1,s}, e = e_{L-1}. With dnum_t = dy_t /
// den_t and g_t = -(dy_t . y_t) / den_t sign(den'_t) [|den'_t| >= 1]:
//   dC_k = e dC_{k+1} + sum_t e_t dnum_t q_t^T,  dn_k likewise with g_t
//   dq_t = e_t (C_k^T dnum_t + g_t n_k) + sum_{s<=t} A_ts k_s
//   dk_s = sum_{t>=s} A_ts q_t + w_s (dC_{k+1}^T v_s + dn_{k+1})
//   dv_s = sum_{t>=s} P_ts dnum_t + w_s dC_{k+1} k_s
// with A_ts = D_ts (v_s . dnum_t + g_t), P_ts = D_ts (k_s . q_t). With
// log f' and log i' as the variables the gates need no C: their gradients
// are a_t = sum_{u>=t} (q_u . dq_u - k_u . dk_u) and b_t = k_t . dk_t, and
// the step form's f32 stabiliser chain m_t = max(log_sigmoid(f_t) +
// m_{t-1}, i_t) carries them to i and f as a scalar reverse walk (at an
// exact tie its gradient splits half to each arm, as autograd's). Four
// kernels, one launch each a call, in order on one stream:
//   * mlstm_bwd_prep_kernel: a warp a (b, h) walks the m chain (lanes =
//     steps) and keeps which arm each max took; a warp a (b, h, chunk)
//     forms e_t (the states pass reads them); a warp four (b, t, h) rows
//     takes dy . y and g;
//   * mlstm_bwd_state_kernel, grid (dC tiles, B*H): the forward's states
//     pass mirrored: a block keeps a kMTile x kMTile tile of dC^T in
//     registers and walks the chunks in reverse, storing the state
//     gradient after each chunk in scratch (dC^T, dn: 151 MB at the train
//     shape) and adding the chunk as one register-tiled [96 x L] x [L x 96]
//     product of q and dy's rows scaled by e_t / den_t; q, dy and the
//     chunk's e, den', g come by cp.async two chunks ahead;
//   * mlstm_bwd_chunk_kernel<hd / 16>, grid (chunk, B*H), chunk-parallel:
//     over 32-column slices of hd (two cp.async stages) it forms dy v^T
//     and q k^T (each slice's sums added apart), then A and P in shared
//     memory; then dq, dk and dv one after the other, each a 64 x hd tile
//     in registers (a thread 4 steps x hd / 16 columns): the state's part
//     over slices of C^T or dC^T (dq, dk: C^T's columns as rows of a
//     dot-product form, their 16-byte pieces swizzled so that 8 lanes'
//     rows fall in 8 bank groups; dv: dC^T's rows as the forward's q C^T),
//     then the chunk's part over its steps (A k, A^T q, P^T dnum); writes
//     dq, dk, dv and q . dq, k . dk a step (each thread's columns summed,
//     then the 16 threads of a row by a fixed butterfly);
//   * mlstm_bwd_gate_kernel: a warp a (b, h) walks the gates in reverse,
//     32 steps a round (an affine suffix scan over the warp's lanes).
//
// Bound. At the xlstm-125m train shape (B=8, S=2048, H=4, hd=192; 65,536
// (b, s, h), 1,024 chunks) the chunkwise form's work is 4 L hd^2 FMAs a
// chunk (the reverse walk, C^T dnum, dC^T v, dC k) and 5 causal L^2 hd
// products (dy v^T, q k^T, A k, A^T q, P^T dnum): 23.4 GFLOP, 0.35 ms at
// 67 f32 TFLOP/s; its bytes (q, k, v, y, dy, i, f, den', the chunk states
// and their gradients read, dq, dk, dv, di, df and dC written) 0.86 GB,
// 0.26 ms. The step form's own work, 24.3 GFLOP (0.36 ms), is more, so
// this form's is the function's bound. f32 on the CUDA cores: a single TF32 pass misses the
// 1e-4 tolerance at hd 192. Fixed orders, no atomics: two calls give the
// same bits.
//
// ---------------------------------------------------------------------
// sLSTM (forward: pre_g = x_g + W_g h_{t-1} + bias_g; the cell; see
// xlstm_scan.cu). In reverse, with dp_t the gradient of the four gates'
// pre-activations at step t:
//   dh_t = dy_t + sum_g W_g^T dp_{g,t+1}
// then back through h = sigmoid(o) c / max(n, 1), the c, n and m chains
// (dc, dn, dm carried a row) and the gates. Given the step's trails (p_t;
// c, n, m of t - 1 and of t, the forward's own values) the cell's backward
// is affine in (dh, dc, dn, dm):
//   X = dc + a1 dh, Y = dn + a2 dh, dm' = g1 X + g2 Y + sel dm,
//   dp_i = dm - dm', dp_f = sigmoid(-p_f) dm', dp_z = bz X, dp_o = a3 dh,
//   dc' = f' X, dn' = f' Y
// (a1 = sig / nc, a2 = -[n >= 1] sig c / nc^2, a3 = c sig (1 - sig) / nc,
// bz = i' (1 - tanh^2 z), g1 = (1 - sel) f' c_{t-1} - sel i' tanh z, g2 =
// (1 - sel) f' n_{t-1} - sel i', nc = max(n, 1)). The coefficients come
// from the trails, with the forward's short forms (fast_* of
// xlstm_fast.cuh, which both files include: the forward's own f', i',
// tanh z and sigmoid o), before the step's wait; the serial
// step keeps the dozen operations above. dp is the kernel's output, dpre;
// dW = sum dp h_{t-1}^T and dbias = sum dp are plain products outside the
// kernel.
//
// Bound. At the train shape the transposed products are 4 hd^2 FMAs a
// (b, h, step) and the cell about 60 operations a row: 20.1 GFLOP, 0.30
// ms at 67 f32 TFLOP/s; the bytes (the p trail, c, n, m, dy and W read,
// dpre written) 0.61 GB, 0.18 ms.
//
// Design of slstm_scan_bwd_kernel: the forward's cluster of kSCluster = 8
// blocks a head and kSBatch = 4 batch rows, and the forward's row slice
// of W: block j owns rows [j hd/8, (j+1) hd/8) of the cell and keeps
// W_g[rows_j, all w] of the four gates in registers, so its dp stays
// local. A step:
//   * 8 hd/16 threads (a row and batch row each) form the step's
//     coefficients, wait on this block's mbarrier for the 8 partial
//     recurrent sums of their rows, add them in rank order, run the chain
//     and stage dp (4 gates x its rows x 4 batch rows, two buffers);
//   * after one block barrier, every warp forms the block's partial sums
//     sum_{g, v in rows_j} W_g[v, w] dp_g[v] for 16 of the hd columns w
//     (a lane 4 w by hd/16 of the block's (gate, row) terms, reduced over
//     the warp's 8 term groups by a transposing butterfly), and each lane
//     sends its two sums to the block that owns w, an 8-byte st.async into
//     the other of two buffers counted on that block's mbarrier: 3 KB a
//     step a block at hd 192, the forward's h exchange.
// The trails are loaded kSAhead steps ahead into registers, the loads
// placed after the chain (placed before it, they held it about 300
// clocks: clock stamps, xlstm_stamps.py, PERF.md). Tried and slower:
// helper threads that load the trails, form the next step's coefficients
// and store dpre off the cells' warps (the matvec after them stretched).
// The matvec's order is fixed and the receiver adds the sources in rank
// order, so two calls give the same bits.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "xlstm_fast.cuh"

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
  // the forward's scratch: the state before each chunk, C^T
  // [B*H][N][hd][hd] ([k][v]), n [B*H][N][hd], m [B*H][N]; den' [B,S,H]
  const float* c_st;
  const float* n_st;
  const float* m_st;
  const float* den;
  float* dq;
  float* dk;
  float* dv;
  float* di;
  float* df;
  // scratch [B,S,H] each: g, the max's arm, e_t, q . dq, k . dk
  float* g;
  float* sel;
  float* ew;
  float* qdq;
  float* kdk;
  // scratch: the state gradient after each chunk, dC^T [B*H][N][hd][hd],
  // dn [B*H][N][hd]
  float* dc_st;
  float* dn_st;
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

constexpr int kMChunk = 64;                // L: steps a chunk (xlstm_scan.cu)
constexpr int kMPer = kMChunk / 32;        // a lane's steps in the gate terms
constexpr int kMThreads = 256;
constexpr int kMTile = 96;                 // the states pass's dC tile
constexpr int kMTileT = kMTile / 16;       // its rows (and columns) a thread
constexpr int kPChunk = 32;                // the m chain, gates: steps a warp
constexpr int kGRows = 4;                  // rows a warp of dy . y
constexpr int kWarps = kMThreads / 32;

constexpr int kSCluster = 8;
constexpr int kSBatch = 4;
constexpr int kSAhead = 4;
constexpr int kMaxGridYZ = 65535;

constexpr int cmax(int a, int b) { return a > b ? a : b; }

__device__ __forceinline__ float log_sigmoid(float x) {
  return fminf(x, 0.f) - log1pf(expf(-fabsf(x)));
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 (or 4) bytes from global to shared memory: the first `bytes` from
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

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
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

// Two floats into another block's shared memory, 8 bytes on its `bar`.
__device__ __forceinline__ void st_async2(uint32_t addr, float a, float b,
                                          uint32_t bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], "
      "{%1, %2}, [%3];" ::"r"(addr), "f"(a), "f"(b), "r"(bar) : "memory");
}

// The share of a max's gradient that goes to its first operand, as autograd
// splits it: 1, 0, or 1/2 at a tie.
__device__ __forceinline__ float first_arm(float a, float b) {
  return a > b ? 1.f : (a < b ? 0.f : 0.5f);
}

__device__ __forceinline__ float f4_at(const float4& x, int d) {
  return d == 0 ? x.x : d == 1 ? x.y : d == 2 ? x.z : x.w;
}

// ------------------------------------------------------------- mLSTM gates
// The chunk's gate terms as the forward forms them (xlstm_scan.cu), in one
// warp: lane l takes steps kMPer l + q of the chunk at step t0 (nt of them
// before S); c_q = i - b (-inf past S) and big_q = M_t, both in double, from
// m, the m before the chunk. Returns M_{L-1} (the same on every lane).
__device__ __forceinline__ double m_chunk_terms(const MlstmBwdArgs& a, int b,
                                                int h, int t0, int nt,
                                                double m, int lane,
                                                double (&c)[kMPer],
                                                double (&big)[kMPer]) {
  double loc[kMPer], lf[kMPer];
  double run = 0.0;
#pragma unroll
  for (int q = 0; q < kMPer; ++q) {
    const int s = kMPer * lane + q;
    const long long off = (static_cast<long long>(b) * a.S + t0 + s) * a.H
                          + h;
    const float fv = s < nt ? a.f[off] : 0.f;
    if (s < nt) run += static_cast<double>(log_sigmoid(fv));
    lf[q] = run;
    c[q] = s < nt ? static_cast<double>(a.i[off]) : -CUDART_INF;
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
  double mx = -CUDART_INF;
#pragma unroll
  for (int q = 0; q < kMPer; ++q) {
    if (kMPer * lane + q < nt) c[q] -= excl + lf[q];
    mx = fmax(mx, c[q]);
    loc[q] = mx;
  }
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, mx, o);
    if (lane >= o) mx = fmax(mx, u);
  }
  double before = __shfl_up_sync(0xffffffffu, mx, 1);
  if (lane == 0) before = m;
  before = fmax(before, m);
#pragma unroll
  for (int q = 0; q < kMPer; ++q) big[q] = fmax(before, loc[q]);
  return __shfl_sync(0xffffffffu, big[kMPer - 1], 31);
}

// --------------------------------------------------------------- mLSTM prep
// Blocks [0, chain_blocks): a warp a (b, h) walks the step form's m chain,
// 32 steps a round (lanes = steps), and keeps sel_t, the share of the max's
// gradient that goes to its forget arm. Blocks [chain_blocks, chain_blocks
// + ew_blocks): a warp a (b, h, chunk) writes e_t. The rest: a warp
// kGRows (b, t, h) rows' dy . y, then g.
__global__ void __launch_bounds__(kMThreads)
mlstm_bwd_prep_kernel(const MlstmBwdArgs a, int chain_blocks,
                      int ew_blocks) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int blk = blockIdx.x;
  if (blk < chain_blocks) {
    const int bh = blk * kWarps + warp;
    if (bh >= a.B * a.H) return;
    const int b = bh / a.H, h = bh % a.H;
    const long long row0 = static_cast<long long>(b) * a.S * a.H + h;
    // a round's i and f, loaded a round ahead
    auto gates = [&](int t0, float& iv, float& fv) {
      const bool ok = t0 + lane < a.S;
      const long long s = row0 + static_cast<long long>(t0 + lane) * a.H;
      iv = ok ? a.i[s] : 0.f;
      fv = ok ? a.f[s] : 0.f;
    };
    float m_run = 0.f, iv_n, fv_n;
    gates(0, iv_n, fv_n);
    for (int t0 = 0; t0 < a.S; t0 += kPChunk) {
      const int nt = min(kPChunk, a.S - t0);
      const bool ok = lane < nt;
      const long long s = row0 + static_cast<long long>(t0 + lane) * a.H;
      const float iv = iv_n, lf = log_sigmoid(fv_n);
      gates(t0 + kPChunk, iv_n, fv_n);
      float m_prev = 0.f;
#pragma unroll
      for (int u = 0; u < kPChunk; ++u) {
        const float lfu = __shfl_sync(0xffffffffu, lf, u);
        const float iu = __shfl_sync(0xffffffffu, iv, u);
        const float mp = m_run;
        if (u < nt) m_run = fmaxf(lfu + m_run, iu);
        if (lane == u) m_prev = mp;
      }
      if (ok) a.sel[s] = first_arm(lf + m_prev, iv);
    }
    return;
  }
  if (blk < chain_blocks + ew_blocks) {
    const int nch = (a.S + kMChunk - 1) / kMChunk;
    const int idx = (blk - chain_blocks) * kWarps + warp;
    if (idx >= a.B * a.H * nch) return;
    const int bh = idx / nch, j = idx % nch, b = bh / a.H, h = bh % a.H;
    const int t0 = j * kMChunk, nt = min(kMChunk, a.S - t0);
    double c[kMPer], big[kMPer];
    const double mp = a.m_st[static_cast<long long>(bh) * nch + j];
    m_chunk_terms(a, b, h, t0, nt, mp, lane, c, big);
#pragma unroll
    for (int q = 0; q < kMPer; ++q) {
      const int s = kMPer * lane + q;
      if (s < nt)
        a.ew[(static_cast<long long>(b) * a.S + t0 + s) * a.H + h] =
            expf(static_cast<float>(mp - big[q]));
    }
    return;
  }
  const long long rows = static_cast<long long>(a.B) * a.S * a.H;
  const long long r0 =
      (static_cast<long long>(blk - chain_blocks - ew_blocks) * kWarps
       + warp) * kGRows;
  for (int rr = 0; rr < kGRows; ++rr) {
    const long long r = r0 + rr;
    if (r >= rows) break;
    const float4* dyr = reinterpret_cast<const float4*>(a.dy + r * a.hd);
    const float4* yr = reinterpret_cast<const float4*>(a.y + r * a.hd);
    float s = 0.f;
    for (int c4 = lane; c4 < a.hd / 4; c4 += 32) {
      const float4 x = dyr[c4], z = yr[c4];
      s = fmaf(x.x, z.x, s);
      s = fmaf(x.y, z.y, s);
      s = fmaf(x.z, z.z, s);
      s = fmaf(x.w, z.w, s);
    }
#pragma unroll
    for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
    if (lane == 0) {
      const float dp = a.den[r], den = fmaxf(fabsf(dp), 1.f);
      a.g[r] = fabsf(dp) >= 1.f ? (dp > 0.f ? -s : s) / den : 0.f;
    }
  }
}

// ------------------------------------------------------- mLSTM states pass
// Shared memory of mlstm_bwd_state_kernel, in floats: kStages stages of
// the chunk's q columns and dy columns of the tile [kMChunk][kMTile] and
// its e, den', g [kMChunk].
struct BState {
  static constexpr int kQ = 0;
  static constexpr int kD = kMChunk * kMTile;
  static constexpr int kE = 2 * kMChunk * kMTile;
  static constexpr int kDen = kE + kMChunk;
  static constexpr int kG = kDen + kMChunk;
  static constexpr int kStage = kG + kMChunk;
  static constexpr int kStages = 4;
  static constexpr int kBytes = kStages * kStage * 4;
};

// Chunk j's q columns [k0, k0 + kMTile), dy columns [v0, ...), e, den'
// and g into stage `st`, zero past S and past hd.
__device__ __forceinline__ void bs_load(const MlstmBwdArgs& a, float* st,
                                        int b, int h, int j, int k0,
                                        int v0) {
  constexpr int kRow4 = kMTile / 4;
  const int t0 = j * kMChunk, nt = min(kMChunk, a.S - t0);
  const long long base =
      (static_cast<long long>(b) * a.S + t0) * a.H * a.hd
      + static_cast<long long>(h) * a.hd;
  const long long rowstep = static_cast<long long>(a.H) * a.hd;
  for (int p = threadIdx.x; p < kMChunk * kRow4; p += kMThreads) {
    const int s = p / kRow4, c4 = 4 * (p % kRow4);
    const long long row = base + s * rowstep;
    const bool kok = s < nt && k0 + c4 < a.hd, vok = s < nt && v0 + c4 < a.hd;
    cp_async16(smem_addr(st + BState::kQ + s * kMTile + c4),
               a.q + (kok ? row + k0 + c4 : 0), kok ? 16 : 0);
    cp_async16(smem_addr(st + BState::kD + s * kMTile + c4),
               a.dy + (vok ? row + v0 + c4 : 0), vok ? 16 : 0);
  }
  for (int s = threadIdx.x; s < kMChunk; s += kMThreads) {
    const bool ok = s < nt;
    const long long off =
        ok ? (static_cast<long long>(b) * a.S + t0 + s) * a.H + h : 0;
    cp_async4(smem_addr(st + BState::kE + s), a.ew + off, ok ? 4 : 0);
    cp_async4(smem_addr(st + BState::kDen + s), a.den + off, ok ? 4 : 0);
    cp_async4(smem_addr(st + BState::kG + s), a.g + off, ok ? 4 : 0);
  }
}

// The reverse walk: the state gradient after every chunk. Block (tile, b h)
// keeps the tile dC^T[k0 + .., v0 + ..] in registers, kMTileT x kMTileT a
// thread (rows k = k0 + 2 ty + 32 jk + dk, columns v = v0 + 2 tx + 32 jv +
// dv), and walks chunks N-1 .. 1: stores dC^T (and for tile row 0, dn)
// after the chunk, then dC^T = e dC^T + sum_t q_t (u_t dy_t)^T with u_t =
// e_t / den_t, and dn = e dn + sum_t e_t g_t q_t. Chunk 0 is not walked (no
// state before it is learned); the gradient after the last chunk is 0. q,
// dy and the per-step terms come two chunks ahead, so a chunk costs two
// block barriers.
__global__ void __launch_bounds__(kMThreads, 1)
mlstm_bwd_state_kernel(const MlstmBwdArgs a) {
  constexpr int kStages = BState::kStages, kAhead = 2;
  static_assert(kStages > kAhead + 1, "a stage read two chunks ago");
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  const int hd = a.hd;
  const int ntile = (hd + kMTile - 1) / kMTile;
  const int k0 = (blockIdx.x % ntile) * kMTile;
  const int v0 = (blockIdx.x / ntile) * kMTile;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nch = (a.S + kMChunk - 1) / kMChunk;
  const long long hd2 = static_cast<long long>(hd) * hd;
  float* dcs = a.dc_st + static_cast<long long>(bh) * nch * hd2;
  float* dns = a.dn_st + static_cast<long long>(bh) * nch * hd;
  const bool nrow = v0 == 0 && threadIdx.x < kMTile && k0 + threadIdx.x < hd;

  float acc[kMTileT][kMTileT];               // [k][v]
#pragma unroll
  for (int r = 0; r < kMTileT; ++r)
#pragma unroll
    for (int q = 0; q < kMTileT; ++q) acc[r][q] = 0.f;
  float dn_k = 0.f;                          // dn[k0 + threadIdx.x] (nrow)
  // walk step `it` takes chunk nch - 1 - it; its loads come kAhead ahead
  for (int w = 0; w < kAhead; ++w) {
    if (nch - 1 - w >= 1)
      bs_load(a, sm + w * BState::kStage, b, h, nch - 1 - w, k0, v0);
    cp_async_commit();
  }
  for (int it = 0;; ++it) {
    const int j = nch - 1 - it;
    // the state gradient after chunk j
    float* dcj = dcs + j * hd2;
#pragma unroll
    for (int jk = 0; jk < kMTileT / 2; ++jk)
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const int k = k0 + 2 * ty + 32 * jk + dk;
#pragma unroll
        for (int jv = 0; jv < kMTileT / 2; ++jv) {
          const int v = v0 + 2 * tx + 32 * jv;
          if (k < hd && v < hd)
            *reinterpret_cast<float2*>(dcj + static_cast<long long>(k) * hd
                                       + v) =
                make_float2(acc[2 * jk + dk][2 * jv],
                            acc[2 * jk + dk][2 * jv + 1]);
        }
      }
    if (nrow) dns[static_cast<long long>(j) * hd + k0 + threadIdx.x] = dn_k;
    if (j == 0) break;
    // into the stage walk step it - 2 used: every thread is past it
    if (j - kAhead >= 1)
      bs_load(a, sm + ((it + kAhead) % kStages) * BState::kStage, b, h,
              j - kAhead, k0, v0);
    cp_async_commit();
    cp_async_wait<kAhead>();
    __syncthreads();            // chunk j's q, dy and terms
    float* st = sm + (it % kStages) * BState::kStage;
    // dy's rows scaled by u_t = e_t / den_t, in place (0 past S: dy is 0)
    for (int p = threadIdx.x; p < kMChunk * kMTile / 4; p += kMThreads) {
      const int s = p / (kMTile / 4);
      float4* x = reinterpret_cast<float4*>(st + BState::kD) + p;
      const float u =
          st[BState::kE + s] / fmaxf(fabsf(st[BState::kDen + s]), 1.f);
      float4 y = *x;
      y.x *= u;
      y.y *= u;
      y.z *= u;
      y.w *= u;
      *x = y;
    }
    __syncthreads();
    const float e = st[BState::kE + kMChunk - 1];   // chunk j is whole
#pragma unroll
    for (int r = 0; r < kMTileT; ++r)
#pragma unroll
      for (int q = 0; q < kMTileT; ++q) acc[r][q] *= e;
    const float* sk = st + BState::kQ + 2 * ty;
    const float* sv = st + BState::kD + 2 * tx;
#pragma unroll 4
    for (int s = 0; s < kMChunk; ++s) {
      float av[kMTileT], kv[kMTileT];
#pragma unroll
      for (int q = 0; q < kMTileT / 2; ++q) {
        const float2 x = *reinterpret_cast<const float2*>(sv + s * kMTile
                                                          + 32 * q);
        const float2 y = *reinterpret_cast<const float2*>(sk + s * kMTile
                                                          + 32 * q);
        av[2 * q] = x.x;
        av[2 * q + 1] = x.y;
        kv[2 * q] = y.x;
        kv[2 * q + 1] = y.y;
      }
#pragma unroll
      for (int r = 0; r < kMTileT; ++r)
#pragma unroll
        for (int q = 0; q < kMTileT; ++q)
          acc[r][q] = fmaf(kv[r], av[q], acc[r][q]);
    }
    if (nrow) {
      dn_k *= e;
      for (int s = 0; s < kMChunk; ++s)
        dn_k = fmaf(st[BState::kE + s] * st[BState::kG + s],
                    st[BState::kQ + s * kMTile + threadIdx.x], dn_k);
    }
  }
}

// ------------------------------------------------------- mLSTM chunk pass
// Shared memory of mlstm_bwd_chunk_kernel<D16>, in floats: two stages of a
// slice (the largest: dy, v, q and k's columns [L][KS + 4] each); A and P
// [L][L + 4]; n and dn [HD]; e, w, 1 / den and g [L]; c and M [L] in
// double. A state column slice ([HD][KS] of C^T or dC^T, a row a column of
// the output) lies unpadded with its 16-byte pieces swizzled when D16 is a
// multiple of 4 (the output's columns 4 tx + 64 q4 + d), padded otherwise
// (columns tx + 16 q).
template <int D16>
struct BChunk {
  static constexpr int HD = 16 * D16;
  static constexpr int KS = D16 % 2 == 0 ? 32 : 16;
  static constexpr bool kSwz = D16 % 4 == 0;
  static constexpr int kRow = KS + 4;
  static constexpr int kSRow = kSwz ? KS : KS + 4;
  static constexpr int kTR = kMChunk / 16;   // steps a thread
  static constexpr int kOp = kMChunk * kRow;
  static constexpr int kStage =
      cmax(4 * kOp, cmax(kOp + HD * kSRow, kOp + KS * HD));
  static constexpr int kPRow = kMChunk + 4;
  static constexpr int kA = 2 * kStage;
  static constexpr int kP = kA + kMChunk * kPRow;
  static constexpr int kN = kP + kMChunk * kPRow;
  static constexpr int kDn = kN + HD;
  static constexpr int kE = kDn + HD;
  static constexpr int kW = kE + kMChunk;
  static constexpr int kRd = kW + kMChunk;
  static constexpr int kG = kRd + kMChunk;
  static constexpr int kC = kG + kMChunk;   // double c [L], M [L]
  static constexpr int kBytes = (kC + 4 * kMChunk) * 4;
  // slices: dy v^T and q k^T (G1); for dq, dk and dv each the state's
  // part (G1) then the chunk's (G3)
  static constexpr int G1 = HD / KS, G3 = kMChunk / KS;
  static constexpr int GT = 4 * G1 + 3 * G3;
};

// Output column q (0 .. D16-1) of thread tx.
template <int D16>
__device__ __forceinline__ int out_col(int tx, int q) {
  if constexpr (D16 % 4 == 0) return 4 * tx + 64 * (q / 4) + q % 4;
  else return tx + 16 * q;
}

// The float offset of 16-byte piece c4 of row k in a state column slice.
template <int D16>
__device__ __forceinline__ int st_off(int k, int c4) {
  using L = BChunk<D16>;
  if constexpr (L::kSwz) return k * L::kSRow + 4 * (c4 ^ ((k >> 2) & 7));
  else return k * L::kSRow + 4 * c4;
}

// A row of HD floats at this thread's output columns.
template <int D16>
__device__ __forceinline__ void row_cols(const float* row, int tx,
                                         float (&out)[D16]) {
  if constexpr (D16 % 4 == 0) {
#pragma unroll
    for (int q = 0; q < D16 / 4; ++q) {
      const float4 x = *reinterpret_cast<const float4*>(row + 4 * tx + 64 * q);
      out[4 * q] = x.x;
      out[4 * q + 1] = x.y;
      out[4 * q + 2] = x.z;
      out[4 * q + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int q = 0; q < D16; ++q) out[q] = row[tx + 16 * q];
  }
}

// Columns [x0, x0 + KS) of the chunk's rows (zero at and past nt) of the
// [B,S,H,hd] tensor X into dst [L][KS + 4].
template <int D16>
__device__ __forceinline__ void bc_cols(const float* X, long long base,
                                        long long rowstep, int nt, int x0,
                                        float* dst) {
  using L = BChunk<D16>;
  for (int p = threadIdx.x; p < kMChunk * L::KS / 4; p += kMThreads) {
    const int t = p / (L::KS / 4), c4 = 4 * (p % (L::KS / 4));
    const bool ok = t < nt;
    cp_async16(smem_addr(dst + t * L::kRow + c4),
               X + (ok ? base + t * rowstep + x0 + c4 : 0), ok ? 16 : 0);
  }
}

// Rows [t0, t0 + KS) of the chunk (zero at and past nt), whole, into dst
// [KS][HD].
template <int D16>
__device__ __forceinline__ void bc_rows(const float* X, long long base,
                                        long long rowstep, int nt, int t0,
                                        float* dst) {
  using L = BChunk<D16>;
  constexpr int HD = L::HD;
  for (int p = threadIdx.x; p < L::KS * HD / 4; p += kMThreads) {
    const int t = p / (HD / 4), c4 = 4 * (p % (HD / 4));
    const bool ok = t0 + t < nt;
    cp_async16(smem_addr(dst + t * HD + c4),
               X + (ok ? base + (t0 + t) * rowstep + c4 : 0), ok ? 16 : 0);
  }
}

// Columns [x0, x0 + KS) of a state matrix [HD][HD] as a column slice.
template <int D16>
__device__ __forceinline__ void bc_state_cols(const float* st, int x0,
                                              float* dst) {
  using L = BChunk<D16>;
  constexpr int HD = L::HD, P = L::KS / 4;
  for (int p = threadIdx.x; p < HD * P; p += kMThreads) {
    const int k = p / P, c4 = p % P;
    cp_async16(smem_addr(dst + st_off<D16>(k, c4)),
               st + static_cast<long long>(k) * HD + x0 + 4 * c4, 16);
  }
}

// acc[i][q] += sum_x a[4 ty + i][x] S[col q][x] over a slice: the rows of
// `ar` ([L][KS + 4]) against a state column slice, dot-product form.
template <int D16>
__device__ __forceinline__ void bc_dot(const float* ar, const float* bs,
                                       int tx, int ty,
                                       float (&acc)[kMChunk / 16][D16]) {
  using L = BChunk<D16>;
  constexpr int kTR = L::kTR;
  // out_col(tx, q) >> 2 & 7 is tx & 7 for every q when swizzled
  const float* arow = ar + kTR * ty * L::kRow;
#pragma unroll 2
  for (int c4 = 0; c4 < L::KS / 4; ++c4) {
    const int pc = 4 * (L::kSwz ? c4 ^ (tx & 7) : c4);
    float4 av[kTR];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
      av[i] = *reinterpret_cast<const float4*>(arow + i * L::kRow + 4 * c4);
#pragma unroll
    for (int q = 0; q < D16; ++q) {
      const float4 bv = *reinterpret_cast<const float4*>(
          bs + out_col<D16>(tx, q) * L::kSRow + pc);
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        float x = fmaf(av[i].x, bv.x, acc[i][q]);
        x = fmaf(av[i].y, bv.y, x);
        x = fmaf(av[i].z, bv.z, x);
        acc[i][q] = fmaf(av[i].w, bv.w, x);
      }
    }
  }
}

// acc[i][q] += sum_x a[4 ty + i][x] B[x][col q] over x in [0, n): the rows
// of `ar` (stride `lda`, x contiguous) against the rows of `br` ([.][HD]),
// the forward's outer-product form.
template <int D16>
__device__ __forceinline__ void bc_outer(const float* ar, int lda,
                                         const float* br, int n, int tx,
                                         int ty,
                                         float (&acc)[kMChunk / 16][D16]) {
  using L = BChunk<D16>;
  constexpr int kTR = L::kTR, HD = L::HD;
  for (int x0 = 0; x0 < n; x0 += 4) {
    float4 av[kTR];
#pragma unroll
    for (int i = 0; i < kTR; ++i)
      av[i] = *reinterpret_cast<const float4*>(ar + (kTR * ty + i) * lda
                                               + x0);
#pragma unroll
    for (int d = 0; d < 4; ++d) {
      float bv[D16];
      row_cols<D16>(br + (x0 + d) * HD, tx, bv);
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const float x = f4_at(av[i], d);
#pragma unroll
        for (int q = 0; q < D16; ++q) acc[i][q] = fmaf(x, bv[q], acc[i][q]);
      }
    }
  }
}

// acc[i][q] += sum_t M[t][4 ty + i] B[t - t0][col q] over t in [tb, t0 +
// n): a column block of the L x L matrix M (A or P) against the rows of
// `br` ([.][HD], row 0 at step t0).
template <int D16>
__device__ __forceinline__ void bc_trans(const float* mm, const float* br,
                                         int t0, int tb, int n, int tx,
                                         int ty,
                                         float (&acc)[kMChunk / 16][D16]) {
  using L = BChunk<D16>;
  constexpr int HD = L::HD;
  for (int t = tb; t < t0 + n; ++t) {
    const float4 a4 =
        *reinterpret_cast<const float4*>(mm + t * L::kPRow + L::kTR * ty);
    float bv[D16];
    row_cols<D16>(br + (t - t0) * HD, tx, bv);
#pragma unroll
    for (int q = 0; q < D16; ++q) {
      acc[0][q] = fmaf(a4.x, bv[q], acc[0][q]);
      acc[1][q] = fmaf(a4.y, bv[q], acc[1][q]);
      acc[2][q] = fmaf(a4.z, bv[q], acc[2][q]);
      acc[3][q] = fmaf(a4.w, bv[q], acc[3][q]);
    }
  }
}

// One output's tile written (rows below nt) and, with `with` set, each
// row's dot with that tensor's row, summed over the thread's columns and
// then the row's 16 threads, into dots [B,S,H].
template <int D16>
__device__ __forceinline__ void bc_store(float* out, const float* with,
                                         float* dots, long long base,
                                         long long rowstep, long long drow,
                                         long long dstep, int nt, int tx,
                                         int ty,
                                         const float (&acc)[kMChunk / 16]
                                                           [D16]) {
  using L = BChunk<D16>;
#pragma unroll
  for (int i = 0; i < L::kTR; ++i) {
    const int t = L::kTR * ty + i;
    const bool ok = t < nt;
    float part = 0.f;
    if (ok) {
      float* orow = out + base + t * rowstep;
      if constexpr (D16 % 4 == 0) {
#pragma unroll
        for (int q = 0; q < D16 / 4; ++q)
          *reinterpret_cast<float4*>(orow + 4 * tx + 64 * q) =
              make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                          acc[i][4 * q + 3]);
      } else {
#pragma unroll
        for (int q = 0; q < D16; ++q) orow[tx + 16 * q] = acc[i][q];
      }
      if (with != nullptr) {
        float wv[D16];
        row_cols<D16>(with + base + t * rowstep, tx, wv);
#pragma unroll
        for (int q = 0; q < D16; ++q) part = fmaf(wv[q], acc[i][q], part);
      }
    }
    if (with != nullptr) {
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        part += __shfl_xor_sync(0xffffffffu, part, o);
      if (ok && tx == 0) dots[drow + t * dstep] = part;
    }
  }
}

// Chunk blockIdx.x of (b, h) = blockIdx.y: dq, dk, dv and q . dq, k . dk.
// Thread (ty, tx) takes steps 4 ty + i and the output columns out_col(tx,
// q); the slices stream through two stages in the order of BChunk.
template <int D16>
__global__ void __launch_bounds__(kMThreads, 2)
mlstm_bwd_chunk_kernel(const MlstmBwdArgs a) {
  using L = BChunk<D16>;
  constexpr int HD = L::HD, KS = L::KS, kTR = L::kTR;
  constexpr int G1 = L::G1, G3 = L::G3, GT = L::GT;
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  double* c_s = reinterpret_cast<double*>(sm + L::kC);
  double* big_s = c_s + kMChunk;
  const int j = blockIdx.x, nch = gridDim.x;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int t0 = j * kMChunk, nt = min(kMChunk, a.S - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long sj = static_cast<long long>(bh) * nch + j;
  const float* cj = a.c_st + sj * HD * HD;     // C^T before chunk j
  const float* dcj = a.dc_st + sj * HD * HD;   // dC^T after it
  const long long base = (static_cast<long long>(b) * a.S + t0) * a.H * HD
                         + static_cast<long long>(h) * HD;
  const long long rowstep = static_cast<long long>(a.H) * HD;
  const long long drow = (static_cast<long long>(b) * a.S + t0) * a.H + h;

  // slice g into stage `st`, in BChunk's order
  auto load = [&](int g, float* st) {
    if (g < G1) {                               // dy, v, q, k columns
      const int x0 = g * KS;
      bc_cols<D16>(a.dy, base, rowstep, nt, x0, st);
      bc_cols<D16>(a.v, base, rowstep, nt, x0, st + L::kOp);
      bc_cols<D16>(a.q, base, rowstep, nt, x0, st + 2 * L::kOp);
      bc_cols<D16>(a.k, base, rowstep, nt, x0, st + 3 * L::kOp);
      return;
    }
    g -= G1;
    const int part = g / (G1 + G3), r = g % (G1 + G3);
    if (r < G1) {                               // the state's part
      const int x0 = r * KS;
      if (part == 0) {                          // dq: dy . C^T columns
        bc_cols<D16>(a.dy, base, rowstep, nt, x0, st);
        bc_state_cols<D16>(cj, x0, st + L::kOp);
      } else if (part == 1) {                   // dk: v . dC^T columns
        bc_cols<D16>(a.v, base, rowstep, nt, x0, st);
        bc_state_cols<D16>(dcj, x0, st + L::kOp);
      } else {                                  // dv: k x dC^T rows
        bc_cols<D16>(a.k, base, rowstep, nt, x0, st);
        for (int p = threadIdx.x; p < KS * HD / 4; p += kMThreads)
          cp_async16(smem_addr(st + L::kOp + 4 * p),
                     dcj + static_cast<long long>(x0) * HD + 4 * p, 16);
      }
    } else {                                    // the chunk's part: rows
      const float* X = part == 0 ? a.k : part == 1 ? a.q : a.dy;
      bc_rows<D16>(X, base, rowstep, nt, (r - G1) * KS, st);
    }
  };

  load(0, sm);
  cp_async_commit();
  for (int e = threadIdx.x; e < HD; e += kMThreads) {
    sm[L::kN + e] = a.n_st[sj * HD + e];
    sm[L::kDn + e] = a.dn_st[sj * HD + e];
  }
  if (warp == 0) {
    double c[kMPer], big[kMPer];
    const double mp = a.m_st[sj];
    const double blast = m_chunk_terms(a, b, h, t0, nt, mp, lane, c, big);
#pragma unroll
    for (int q = 0; q < kMPer; ++q) {
      const int s = kMPer * lane + q;
      const bool ok = s < nt;
      c_s[s] = c[q];
      big_s[s] = big[q];
      sm[L::kE + s] = expf(static_cast<float>(mp - big[q]));
      sm[L::kW + s] = expf(static_cast<float>(c[q] - blast));
      const float dp = ok ? a.den[drow + s * a.H] : 1.f;
      sm[L::kRd + s] = 1.f / fmaxf(fabsf(dp), 1.f);
      sm[L::kG + s] = ok ? a.g[drow + s * a.H] : 0.f;
    }
  }

  int g = 0;                                    // the slice being walked
  auto begin = [&]() -> const float* {
    if (g + 1 < GT) load(g + 1, sm + ((g + 1) & 1) * L::kStage);
    cp_async_commit();
    cp_async_wait<1>();
    __syncthreads();
    return sm + (g & 1) * L::kStage;
  };
  auto end = [&]() {
    __syncthreads();                            // the stage is free
    ++g;
  };
  const int tmax = 2 * kTR * (warp + 1) - 1;    // the warp's last step
  const int smin = 2 * kTR * warp;              // and its first
  const int qmax = tmax / 16;                   // its last s = tx + 16 q

  // ---- dy v^T and q k^T, each slice's sums added apart; then A and P
  for (int x = 0; x < G1; ++x) {
    const float* st = begin();
#pragma unroll
    for (int which = 0; which < 2; ++which) {
      const float* ar = st + 2 * which * L::kOp;
      const float* br = ar + L::kOp;
      float sp[kTR][kTR];
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int q = 0; q < kTR; ++q) sp[i][q] = 0.f;
#pragma unroll 2
      for (int kk = 0; kk < KS; kk += 4) {
        float4 qa[kTR];
#pragma unroll
        for (int i = 0; i < kTR; ++i)
          qa[i] = *reinterpret_cast<const float4*>(ar + (kTR * ty + i)
                                                   * L::kRow + kk);
#pragma unroll
        for (int q = 0; q < kTR; ++q) {
          if (q > qmax) break;
          const float4 kb = *reinterpret_cast<const float4*>(
              br + (tx + 16 * q) * L::kRow + kk);
#pragma unroll
          for (int i = 0; i < kTR; ++i) {
            float y = fmaf(qa[i].x, kb.x, sp[i][q]);
            y = fmaf(qa[i].y, kb.y, y);
            y = fmaf(qa[i].z, kb.z, y);
            sp[i][q] = fmaf(qa[i].w, kb.w, y);
          }
        }
      }
      float* pm = sm + (which ? L::kP : L::kA) + kTR * ty * L::kPRow + tx;
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int q = 0; q < kTR; ++q)
          if (q <= qmax) {
            float* y = pm + i * L::kPRow + 16 * q;
            *y = x == 0 ? sp[i][q] : *y + sp[i][q];
          }
    }
    if (x == G1 - 1) {
      // A = D o (dy v^T / den + g), P = D o (q k^T) / den (rows t)
#pragma unroll
      for (int i = 0; i < kTR; ++i) {
        const int t = kTR * ty + i;
        const double bt = big_s[t];
        const float rd = sm[L::kRd + t], gt = sm[L::kG + t];
#pragma unroll
        for (int q = 0; q < kTR; ++q) {
          const int s = tx + 16 * q;
          if (q > qmax) break;
          float* xa = sm + L::kA + t * L::kPRow + s;
          float* xp = sm + L::kP + t * L::kPRow + s;
          if (s <= t) {
            const float d = expf(static_cast<float>(c_s[s] - bt));
            *xa = d * fmaf(*xa, rd, gt);
            *xp = d * (*xp * rd);
          } else {
            *xa = 0.f;
            *xp = 0.f;
          }
        }
      }
    }
    end();
  }

  float acc[kTR][D16];
  for (int part = 0; part < 3; ++part) {
#pragma unroll
    for (int i = 0; i < kTR; ++i)
#pragma unroll
      for (int q = 0; q < D16; ++q) acc[i][q] = 0.f;
    // the state's part: C^T dnum (dq), dC^T v (dk), dC k (dv)
    for (int x = 0; x < G1; ++x) {
      const float* st = begin();
      if (part < 2)
        bc_dot<D16>(st, st + L::kOp, tx, ty, acc);
      else
        bc_outer<D16>(st, L::kRow, st + L::kOp, KS, tx, ty, acc);
      if (x == G1 - 1) {
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          const int t = kTR * ty + i;
          if (part == 0) {          // e_t (C^T dy / den + g n)
            const float et = sm[L::kE + t];
            const float sc = et * sm[L::kRd + t], gn = et * sm[L::kG + t];
#pragma unroll
            for (int q = 0; q < D16; ++q)
              acc[i][q] = fmaf(acc[i][q], sc,
                               gn * sm[L::kN + out_col<D16>(tx, q)]);
          } else {                  // w_s (dC^T v + dn), w_s dC k
            const float ws = sm[L::kW + t];
#pragma unroll
            for (int q = 0; q < D16; ++q) {
              const float dn = part == 1 ? sm[L::kDn + out_col<D16>(tx, q)]
                                         : 0.f;
              acc[i][q] = ws * (acc[i][q] + dn);
            }
          }
        }
      }
      end();
    }
    // the chunk's part: A k (dq), A^T q (dk), P^T dnum (dv)
    for (int x = 0; x < G3; ++x) {
      const float* st = begin();
      const int s0 = x * KS;
      if (part == 0) {
        const int n = min(KS, tmax + 1 - s0);
        if (n > 0)
          bc_outer<D16>(sm + L::kA + s0, L::kPRow, st, n, tx, ty, acc);
      } else {
        bc_trans<D16>(sm + (part == 1 ? L::kA : L::kP), st, s0,
                      max(s0, smin), KS, tx, ty, acc);
      }
      if (x == G3 - 1)
        bc_store<D16>(part == 0 ? a.dq : part == 1 ? a.dk : a.dv,
                      part == 0 ? a.q : part == 1 ? a.k : nullptr,
                      part == 0 ? a.qdq : a.kdk, base, rowstep, drow, a.H, nt,
                      tx, ty, acc);
      end();
    }
  }
}

// ------------------------------------------------------------- mLSTM gates
// A warp a (b, h) walks the gates in reverse, 32 steps a round (lane =
// step), from q . dq, k . dk and sel.
__global__ void __launch_bounds__(kMThreads)
mlstm_bwd_gate_kernel(const MlstmBwdArgs a) {
  const int lane = threadIdx.x & 31;
  const int bh = blockIdx.x * kWarps + (threadIdx.x >> 5);
  if (bh >= a.B * a.H) return;                 // whole warps
  const int b = bh / a.H, h = bh % a.H;
  const long long bsh0 = static_cast<long long>(b) * a.S * a.H + h;
  // a round's q . dq, k . dk, sel and f, loaded a round ahead
  float4 nx;
  auto terms = [&](int t0) {
    const int t = t0 + lane;
    const long long s = bsh0 + static_cast<long long>(t) * a.H;
    nx = t0 >= 0 && t < a.S
             ? make_float4(a.qdq[s], a.kdk[s], a.sel[s], a.f[s])
             : make_float4(0.f, 0.f, 1.f, 0.f);
  };
  float a_carry = 0.f, m_carry = 0.f;          // sum_{u >= t0+32} s_u; M
  terms((a.S - 1) / kPChunk * kPChunk);
  for (int t0 = (a.S - 1) / kPChunk * kPChunk; t0 >= 0; t0 -= kPChunk) {
    const int t = t0 + lane;
    const bool ok = t < a.S;
    const long long s = bsh0 + static_cast<long long>(t) * a.H;
    const float qdq = nx.x, kdk = nx.y, sel = nx.z, fv = nx.w;
    terms(t0 - kPChunk);
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
// The forward's short forms (fast_*) come from xlstm_fast.cuh, so that
// f', i', tanh z and sigmoid o are the forward's own.

// The step's affine coefficients (see the notes at the top), the
// forward's cell as xlstm_scan.cu's slstm_scan_kernel rounds it: m_{t-1}
// + log_sigmoid(p_f) and f', i' from the forward's own m_t.
struct CellCoef {
  float a1, a2, a3, bz, g1, g2, sel, sgf, fp;
};

// From the step's p (4 gates), the state before it (c0, n0, m0) and after
// it (c, n, m), all the forward's.
__device__ __forceinline__ CellCoef cell_coef(const float (&p)[4], float c0,
                                              float n0, float m0, float c,
                                              float n, float m) {
  const float pi = p[0], pf = p[1], pz = p[2], po = p[3];
  const float mf = __fadd_rn(fast_log_sigmoid(pf), m0);
  const float ip = fast_exp(__fsub_rn(pi, m));
  const float fp = fast_exp(__fsub_rn(mf, m));
  const float tz = fast_tanh(pz);
  const float sig = fast_sigmoid(po);
  const float rn = fast_rcp(fmaxf(n, 1.f));
  const float sel = first_arm(mf, pi);
  CellCoef k;
  k.a1 = sig * rn;
  k.a2 = n >= 1.f ? -(k.a1 * c * rn) : 0.f;
  k.a3 = c * rn * sig * (1.f - sig);
  k.bz = ip * (1.f - tz * tz);
  k.g1 = (1.f - sel) * fp * c0 - sel * ip * tz;
  k.g2 = (1.f - sel) * fp * n0 - sel * ip;
  k.sel = sel;
  k.sgf = fast_sigmoid(-pf);
  k.fp = fp;
  return k;
}

template <int D16>
constexpr int kBSThreads = 32 * D16;     // a warp 16 output columns w

template <int D16>
__global__ void __launch_bounds__(kBSThreads<D16>, 1)
    slstm_scan_bwd_kernel(const SlstmBwdArgs a) {
  constexpr int HD = 16 * D16;
  constexpr int RB = HD / kSCluster;       // rows a block
  constexpr int kTerms = 4 * RB;           // its (gate, row) terms: 8 D16
  constexpr int kCells = RB * kSBatch;     // (row, batch row) cells
  constexpr int kBytes = kSCluster * kSBatch * RB * 4;  // partials a step
  static_assert(kCells <= kBSThreads<D16>, "a thread a cell");
  // the partial sums of this block's rows w by source block: [src][b][w]
  __shared__ __align__(16) float rbuf[2][kSCluster][kSBatch][RB];
  __shared__ __align__(16) float dploc[2][kTerms][kSBatch];
  __shared__ __align__(8) uint64_t mbar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  // matvec: lane = 4 tg + wq takes the columns w = 16 warp + 4 wq + jw
  // (jw < 4) and the terms tau = 8 i + tg (i < D16; gate tau / RB, row
  // rank RB + tau % RB); its 16 sums, index 4 b + jw, reduced over the 8
  // term groups by a transposing butterfly, leave it sums 2 tg, 2 tg + 1:
  // batch row tg / 2, columns ws, ws + 1 below
  const int wq = lane & 3, tg = lane >> 2;
  const int ws = 16 * warp + 4 * wq + 2 * (tg & 1);
  const int dst = ws / RB, wl = ws % RB, bs = tg >> 1;
  const int h = blockIdx.z;
  const int b0 = blockIdx.y * kSBatch;

  float wt[D16][4];
#pragma unroll
  for (int i = 0; i < D16; ++i) {
    const int tau = 8 * i + tg, gg = tau / RB;
    const int v = rank * RB + tau % RB;
#pragma unroll
    for (int jw = 0; jw < 4; ++jw)
      wt[i][jw] = a.w_r[((static_cast<long long>(gg) * a.H + h) * HD + v)
                        * HD + 16 * warp + 4 * wq + jw];
  }
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
  // step t's p (4 gates), dy, and c, n, m before it and after it
  float pr[kSAhead][4], sr[kSAhead][6], dyr[kSAhead];
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
    sr[j][3] = ok ? a.c[base + t * ystep] : 0.f;
    sr[j][4] = ok ? a.n[base + t * ystep] : 0.f;
    sr[j][5] = ok ? a.m[base + t * ystep] : 0.f;
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
      const int buf = u & 1;
      if (cell) {
        // the coefficients, before the wait, off the chain: c, n, m of
        // step t and of t - 1 are the forward's own (its trails), and
        // f', i', tanh z and sigmoid o the forward's short forms of them
        const CellCoef k = cell_coef(pr[j], sr[j][0], sr[j][1], sr[j][2],
                                     sr[j][3], sr[j][4], sr[j][5]);
        const float dy = dyr[j];
        // buffer u & 1 holds the partial sums for step t once every block's
        // have landed; then this block arms the buffer's next phase
        float rec = 0.f;
        if (u > 0) {
          const auto bar = buf ? bar1 : bar0;
          mbar_wait(bar, ((u - 1) >> 1) & 1);
          if (threadIdx.x == 0) mbar_expect(bar, kBytes);
#pragma unroll
          for (int src = 0; src < kSCluster; ++src)
            rec += rbuf[buf][src][cb][cr];
        }
        // the chain
        const float dh = dy + rec;
        const float xx = fmaf(k.a1, dh, dc);
        const float yy = fmaf(k.a2, dh, dn);
        const float dmf = fmaf(k.g1, xx, fmaf(k.g2, yy, k.sel * dm));
        const float dp[4] = {dm - dmf, k.sgf * dmf, k.bz * xx, k.a3 * dh};
        dc = k.fp * xx;
        dn = k.fp * yy;
        dm = dmf;
#pragma unroll
        for (int gg = 0; gg < 4; ++gg) {
          dploc[buf][gg * RB + cr][cb] = dp[gg];
          if (cvalid) a.dpre[pbase + (4LL * t + gg) * ystep] = dp[gg];
        }
        load(j, t - kSAhead);    // after the chain: its loads wait for none
      }
      __syncthreads();
      if (t == 0) break;
      // the block's partial sums for step t - 1's rows w
      float s[16];
#pragma unroll
      for (int e = 0; e < 16; ++e) s[e] = 0.f;
#pragma unroll
      for (int i = 0; i < D16; ++i) {
        const float4 d =
            *reinterpret_cast<const float4*>(&dploc[buf][8 * i + tg][0]);
        const float dv[kSBatch] = {d.x, d.y, d.z, d.w};
#pragma unroll
        for (int bb = 0; bb < kSBatch; ++bb)
#pragma unroll
          for (int jw = 0; jw < 4; ++jw)
            s[4 * bb + jw] = fmaf(wt[i][jw], dv[bb], s[4 * bb + jw]);
      }
      int cnt = 16;
#pragma unroll
      for (int o = 16; o >= 4; o >>= 1) {
        const bool up = lane & o;
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          if (e < cnt / 2) {
            const float mine = up ? s[e + cnt / 2] : s[e];
            const float give = up ? s[e] : s[e + cnt / 2];
            s[e] = mine + __shfl_xor_sync(0xffffffffu, give, o);
          }
        }
        cnt /= 2;
      }
      // to the block that owns w, into buffer (u + 1) & 1
      const auto nbar = buf ? bar0 : bar1;
      st_async2(map_rank(smem_addr(&rbuf[buf ^ 1][rank][bs][wl]), dst), s[0],
                s[1], map_rank(nbar, dst));
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
int launch_mlstm_chunk(const MlstmBwdArgs& a, cudaStream_t s) {
  using L = BChunk<D16>;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_bwd_chunk_kernel<D16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nch = (a.S + kMChunk - 1) / kMChunk;
  mlstm_bwd_chunk_kernel<D16><<<dim3(nch, a.B * a.H), kMThreads, L::kBytes,
                                s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D16>
int mlstm_chunk_blocks_per_sm_t() {
  using L = BChunk<D16>;
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_bwd_chunk_kernel<D16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, mlstm_bwd_chunk_kernel<D16>, kMThreads, L::kBytes);
  return err == cudaSuccess ? n : 0;
}

template <int D16>
int mlstm_chunk_smem_t() {
  return BChunk<D16>::kBytes;
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

// The prep kernel's blocks of each role: the m chain, e_t, dy . y.
void prep_blocks(const MlstmBwdArgs& a, long long* chain, long long* ew,
                 long long* rows) {
  const long long nch = (a.S + kMChunk - 1) / kMChunk;
  *chain = (static_cast<long long>(a.B) * a.H + kWarps - 1) / kWarps;
  *ew = (static_cast<long long>(a.B) * a.H * nch + kWarps - 1) / kWarps;
  *rows = (static_cast<long long>(a.B) * a.S * a.H + kWarps * kGRows - 1)
          / (kWarps * kGRows);
}

}  // namespace

// Plain C entry points for ctypes. A launch returns cudaGetLastError()
// after it (0 = cudaSuccess), kBadHeadDim or kBadGrid; it is asynchronous
// on `stream`. The mLSTM's four run in order on one stream: prep, states,
// chunks, gates. Their scratch holds ceil(S / 64) chunks.
extern "C" int mlstm_bwd_prep_f32(const MlstmBwdArgs* a, void* stream) {
  if (!good_hd(a->hd)) return kBadHeadDim;
  long long chain, ew, rows;
  prep_blocks(*a, &chain, &ew, &rows);
  if (chain + ew + rows > 0x7fffffffLL) return kBadGrid;
  mlstm_bwd_prep_kernel<<<static_cast<unsigned>(chain + ew + rows), kMThreads,
                          0, static_cast<cudaStream_t>(stream)>>>(
      *a, static_cast<int>(chain), static_cast<int>(ew));
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mlstm_bwd_state_f32(const MlstmBwdArgs* a, void* stream) {
  if (!good_hd(a->hd)) return kBadHeadDim;
  if (static_cast<long long>(a->B) * a->H > kMaxGridYZ) return kBadGrid;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_bwd_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      BState::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntile = (a->hd + kMTile - 1) / kMTile;
  mlstm_bwd_state_kernel<<<dim3(ntile * ntile, a->B * a->H), kMThreads,
                           BState::kBytes,
                           static_cast<cudaStream_t>(stream)>>>(*a);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int mlstm_bwd_chunk_f32(const MlstmBwdArgs* a, void* stream) {
  const int hd = a->hd;
  if (!good_hd(hd)) return kBadHeadDim;
  if (static_cast<long long>(a->B) * a->H > kMaxGridYZ) return kBadGrid;
  XLSTM_HD_CASES(launch_mlstm_chunk, *a, static_cast<cudaStream_t>(stream))
  return kBadHeadDim;
}

extern "C" int mlstm_bwd_gate_f32(const MlstmBwdArgs* a, void* stream) {
  if (!good_hd(a->hd)) return kBadHeadDim;
  const long long blocks =
      (static_cast<long long>(a->B) * a->H + kWarps - 1) / kWarps;
  mlstm_bwd_gate_kernel<<<static_cast<unsigned>(blocks), kMThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(*a);
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

// mlstm_bwd_chunk_kernel's blocks an SM at head dim hd, and the dynamic
// shared memory a block of the states pass (which 0) or the chunk pass
// (which 1) in bytes; slstm_scan_bwd_kernel's clusters the card holds at
// once for `batch` rows and `heads` heads (0 on error).
extern "C" int mlstm_bwd_blocks_per_sm(int hd) {
  if (!good_hd(hd)) return 0;
  XLSTM_HD_CASES(mlstm_chunk_blocks_per_sm_t)
  return 0;
}

extern "C" int mlstm_bwd_smem_bytes(int hd, int which) {
  if (!good_hd(hd)) return 0;
  if (which == 0) return BState::kBytes;
  XLSTM_HD_CASES(mlstm_chunk_smem_t)
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
