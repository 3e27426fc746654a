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
// to 256 (the sLSTM kernel and the mLSTM's outputs kernel instantiated
// for each hd / 16).
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
// The step form's operations, an FMA an entry of C a step for its update
// and one for C q (4 flops), and n and n . q 4 flops a column: 156 GFLOP,
// 2.32 ms at 67 f32 TFLOP/s. Bound by operations, on the CUDA cores (a
// single TF32 pass on the tensor cores misses the 1e-4 tolerance at hd
// 192). The chunkwise form below does that work plus, a chunk, q k^T and
// P v over its L (L + 1) / 2 causal pairs (4 hd flops a pair: 182 GFLOP
// in all at L = 64, 2.71 ms), and writes and reads the chunk states (8.07
// GB in all, 2.41 ms).
//
// Design: the chunkwise form. Only the scalar chain m is serial; over a
// chunk of L steps from the state (C, n, m) before it, with b_t the
// chunk-local inclusive sum of log_sigmoid(f) and c_s = i_s - b_s, the
// step recurrence unrolls exactly into
//   M_t = max(m, max_{s<=t} c_s)           (the chain's m_t is b_t + M_t)
//   D_ts = exp(c_s - M_t) (s <= t),  e_t = exp(m - M_t)   (both <= 1)
//   y_t = (e_t C q_t + sum_s D_ts (k_s . q_t) v_s)
//         / max(|e_t n . q_t + sum_s D_ts (k_s . q_t)|, 1)
// and the state after it is C' = e C + sum_s w_s v_s k_s^T (likewise n),
// w_s = D_{L-1,s}, e = e_{L-1}, m' = b_{L-1} + M_{L-1}. b, c and M are
// taken in double: a sum of L log forget gates can reach -500 (gates
// nearly shut), where an f32 ulp would move D by 3e-5 (plain version:
// ref.mlstm_scan_chunkwise_ref, ref.mlstm_chunk_states_ref). Two kernels,
// one launch each a call:
//   * mlstm_scan_state_kernel, grid (C tiles, B*H): a block keeps a
//     kMTile x kMTile tile of C in registers (6 x 6 entries a thread of
//     256) and walks the chunks in order: it stores the state before each
//     chunk into scratch (C^T, n, m: 2.42 GB at the path shape), then adds
//     the chunk as one register-tiled product [96 x L] x [L x 96] of V's
//     rows scaled by w and K, L FMAs an entry. K and V come by cp.async
//     two chunks ahead (four stages); warp 0 forms the next chunk's
//     weights while the block walks this one, so a chunk costs two block
//     barriers. At hd 192 4 tiles x 32 (b, h) = 128 blocks, one an SM.
//     (PERF.md has the clock-stamped split of a chunk, xlstm_stamps.py.)
//   * mlstm_scan_out_kernel<hd / 16>, grid (chunk, B*H): fully parallel
//     (16,384 blocks at the path shape, two an SM). A thread takes L / 16
//     steps t by hd / 16 columns of y. Over slices of 32 columns of k it
//     forms q k^T (each slice's sums apart, then added: a 192-term f32
//     chain lost a factor of two against float64) and q C^T together, then
//     P = D o (q k^T), its row sums, n . q and e_t q_t C^T, then adds P v,
//     each warp stopping at its last step's causal column.
// L = 64: at 128 the states' scratch halves but the causal pairs double,
// and the outputs kernel holds one block an SM (slower at both shapes,
// PERF.md).
// Fixed orders, no atomics: two calls give the same bits.
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
//     the cell update, store y and stage the block's h rows;
//   * those threads send the rows to every block of the cluster as 16-byte
//     st.async pieces into the other of two h buffers, each counted as
//     transaction bytes on the receiving block's mbarrier, so the step
//     ends without a cluster barrier (one a step, whose release also
//     waits on the prefetch loads, costs more than the step's work).
// Clock stamps of one step (xlstm_stamps.py, PERF.md) put the matvec
// and the butterfly, issue-bound in 24 warps, and the cell update's
// dependent chain in 3 warps first. The cell update takes short forms
// (fast_*: ex2.approx, rcp.approx and one Newton step, a log1p series)
// in place of the accurate expf, log1pf, tanhf and IEEE divisions. Tried
// and slower (PERF.md): the cell update in 4 lanes of every warp with no
// block barrier (its issue in 24 warps outweighs the barrier); a barrier
// for each source block's rows, the matvec taking each as it lands;
// clusters of 16 blocks (the card holds 7, so the path's 8 take two
// waves).
// x is loaded kSAhead steps ahead into registers. The cell update's sums
// and products round as the plain version's (no contraction into FMAs);
// the matvec's order is fixed, so two calls give the same bits.
//
// Under autograd the wrapper launches slstm_scan_kernel<D16, true>, which
// also keeps the trails its backward (csrc/xlstm_scan_bwd.cu) reads: each
// step's full pre-activations x + W h + bias [B,S,4,H,hd] and c, n, m
// after it [B,S,H,hd] (plain version: ref.slstm_scan_trails_ref). The
// mLSTM's kernels are the same on both paths; under autograd the outputs
// kernel also keeps den'_t (the signed denominator before its clamp,
// [B,S,H]) and the wrapper keeps the chunk states, for the backward.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "xlstm_fast.cuh"

namespace cg = cooperative_groups;

// Mirrors of the ctypes structures in repro_torch/kernels/xlstm_scan.py.
struct MlstmScanArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* i;
  const float* f;
  float* y;
  // scratch: the state before each chunk, C^T [B*H][N][hd][hd] ([k][v]),
  // n [B*H][N][hd], m [B*H][N] (N = ceil(S / kMChunk))
  float* c_st;
  float* n_st;
  float* m_st;
  // under autograd: den'_t = e_t n . q_t + sum_s D_ts k_s . q_t [B,S,H],
  // the signed denominator before the clamp, for the backward (else null)
  float* den;
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

constexpr int kMChunk = 64;                // L: steps a chunk
constexpr int kMPer = kMChunk / 32;        // a lane's steps in the gate terms
constexpr int kMThreads = 256;
constexpr int kMTile = 96;                 // the states' C tile, square
constexpr int kMTileT = kMTile / 16;       // its rows (and columns) a thread

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

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// Barrier `id` among the first `count` threads of the block.
__device__ __forceinline__ void named_barrier(int id, int count) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(count) : "memory");
}

// Wait until at most `N` of this thread's cp.async groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(N) : "memory");
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

// ------------------------------------------------------------------ mLSTM
// The gate terms of one chunk, in double, in one warp: lane l takes its
// steps kMPer l + j (j < kMPer) from iv, fv (the i and f pre-activations;
// steps >= nt are past S). Leaves c_j = i - b (-inf past S), b the
// chunk-local inclusive sum of log_sigmoid(f), and returns b at the
// chunk's last step (the same on every lane).
__device__ __forceinline__ double m_gate_terms(const float (&iv)[kMPer],
                                               const float (&fv)[kMPer],
                                               int nt, int lane,
                                               double (&c)[kMPer]) {
  double loc[kMPer];
  double run = 0.0;
#pragma unroll
  for (int j = 0; j < kMPer; ++j) {
    if (kMPer * lane + j < nt) run += static_cast<double>(log_sigmoid(fv[j]));
    loc[j] = run;
  }
  double incl = run;
#pragma unroll
  for (int o = 1; o < 32; o <<= 1) {
    const double u = __shfl_up_sync(0xffffffffu, incl, o);
    if (lane >= o) incl += u;
  }
  double excl = __shfl_up_sync(0xffffffffu, incl, 1);
  if (lane == 0) excl = 0.0;
#pragma unroll
  for (int j = 0; j < kMPer; ++j)
    c[j] = kMPer * lane + j < nt ? static_cast<double>(iv[j]) - (excl + loc[j])
                                 : -CUDART_INF;
  return __shfl_sync(0xffffffffu, excl + loc[kMPer - 1], 31);
}

// A lane's steps' i and f of the chunk at step t0 of (b, h); 0 past S.
__device__ __forceinline__ void m_gate_load(const MlstmScanArgs& a, int b,
                                            int h, int t0, int lane,
                                            float (&iv)[kMPer],
                                            float (&fv)[kMPer]) {
#pragma unroll
  for (int j = 0; j < kMPer; ++j) {
    const int t = t0 + kMPer * lane + j;
    const long long off = (static_cast<long long>(b) * a.S + t) * a.H + h;
    iv[j] = t < a.S ? a.i[off] : 0.f;
    fv[j] = t < a.S ? a.f[off] : 0.f;
  }
}

// Shared memory of mlstm_scan_state_kernel, in floats: kStages stages of
// the chunk's K and V columns of the tile [kMChunk][kMTile]; two buffers
// of a chunk's weights w [kMChunk], e and m'.
struct MState {
  static constexpr int kK = 0;
  static constexpr int kV = kMChunk * kMTile;
  static constexpr int kStage = 2 * kMChunk * kMTile;
  static constexpr int kStages = 4;
  static constexpr int kWBuf = kMChunk + 4;       // w, then e and m'
  static constexpr int kW = kStages * kStage;
  static constexpr int kBytes = (kW + 2 * kWBuf) * 4;
};

// The K and V columns [k0, k0 + kMTile) and [v0, ...) of chunk j's steps
// [s0, s1) into stage `st`, zero past hd.
__device__ __forceinline__ void ms_load(const MlstmScanArgs& a, float* st,
                                        int b, int h, int j, int k0, int v0,
                                        int s0 = 0, int s1 = kMChunk) {
  constexpr int kRow4 = kMTile / 4;
  const long long base =
      (static_cast<long long>(b) * a.S + j * kMChunk) * a.H * a.hd
      + static_cast<long long>(h) * a.hd;
  const long long rowstep = static_cast<long long>(a.H) * a.hd;
  for (int p = s0 * kRow4 + threadIdx.x; p < s1 * kRow4; p += kMThreads) {
    const int s = p / kRow4, c4 = 4 * (p % kRow4);
    const long long row = base + s * rowstep;
    const bool kok = k0 + c4 < a.hd, vok = v0 + c4 < a.hd;
    cp_async16(smem_addr(st + MState::kK + s * kMTile + c4),
               a.k + (kok ? row + k0 + c4 : 0), kok ? 16 : 0);
    cp_async16(smem_addr(st + MState::kV + s * kMTile + c4),
               a.v + (vok ? row + v0 + c4 : 0), vok ? 16 : 0);
  }
}

// Warp 0: a whole chunk's weights w_s = exp(c_s - M), e = exp(m - M) and
// m' = b_last + M, M = max(m, max_s c_s), into wb (w [kMChunk], e, m'),
// from its gates (iv, fv) and m, the m before it. Returns m'.
__device__ __forceinline__ float ms_gates(const float (&iv)[kMPer],
                                          const float (&fv)[kMPer],
                                          float m, int lane, float* wb) {
  double c[kMPer];
  const double blast = m_gate_terms(iv, fv, kMChunk, lane, c);
  double cmax = c[0];
#pragma unroll
  for (int q = 1; q < kMPer; ++q) cmax = fmax(cmax, c[q]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    cmax = fmax(cmax, __shfl_xor_sync(0xffffffffu, cmax, o));
  const double big = fmax(static_cast<double>(m), cmax);
#pragma unroll
  for (int q = 0; q < kMPer; ++q)
    wb[kMPer * lane + q] = expf(static_cast<float>(c[q] - big));
  const float m_new = static_cast<float>(blast + big);
  if (lane == 0) {
    wb[kMChunk] = expf(static_cast<float>(m - big));
    wb[kMChunk + 1] = m_new;
  }
  return m_new;
}

// The first pass: the state before every chunk. Block (tile, b h) keeps
// the tile C[v0 + .., k0 + ..] in registers, kMTileT x kMTileT a thread
// (rows v = v0 + 2 tx + 32 jv + dv, columns k = k0 + 2 ty + 32 jk + dk),
// and walks the chunks in order: stores C (as C^T: [k][v]), and for tile
// row 0 n, then C = e C + sum_s (w_s v_s) k_s^T. Only chunks 0 .. N-2 are
// walked (no chunk follows the last), and they are whole. Warp 0 forms a
// chunk's weights while the block walks the chunk before it, and K and V
// come two chunks ahead, so a chunk takes two block barriers.
__global__ void __launch_bounds__(kMThreads, 1)
mlstm_scan_state_kernel(const MlstmScanArgs a) {
  constexpr int kStages = MState::kStages;
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  const int hd = a.hd;
  const int ntile = (hd + kMTile - 1) / kMTile;
  const int k0 = (blockIdx.x % ntile) * kMTile;
  const int v0 = (blockIdx.x / ntile) * kMTile;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const int nch = (a.S + kMChunk - 1) / kMChunk;
  const long long hd2 = static_cast<long long>(hd) * hd;
  float* cst = a.c_st + static_cast<long long>(bh) * nch * hd2;
  float* nst = a.n_st + static_cast<long long>(bh) * nch * hd;
  float* mst = a.m_st + static_cast<long long>(bh) * nch;
  const bool nrow = v0 == 0 && threadIdx.x < kMTile && k0 + threadIdx.x < hd;

  float acc[kMTileT][kMTileT];               // [k][v]
#pragma unroll
  for (int r = 0; r < kMTileT; ++r)
#pragma unroll
    for (int q = 0; q < kMTileT; ++q) acc[r][q] = 0.f;
  float n_k = 0.f;                           // n[k0 + threadIdx.x] (nrow)
  float m_start = 0.f;                       // m before the chunk
  // K and V come kAhead chunks ahead (the last chunk is never walked)
  constexpr int kAhead = 2;
  static_assert(kStages > kAhead + 1, "a stage read two chunks ago");
  for (int j = 0; j < kAhead; ++j) {
    if (j + 1 < nch) ms_load(a, sm + j * MState::kStage, b, h, j, k0, v0);
    cp_async_commit();
  }
  // warp 0: the i, f of the chunk after the one whose weights it last
  // formed, and that chunk's m'
  float iv[kMPer], fv[kMPer], m_w = 0.f;
  if (warp == 0 && nch > 1) {
    m_gate_load(a, b, h, 0, lane, iv, fv);
    m_w = ms_gates(iv, fv, 0.f, lane, sm + MState::kW);
    m_gate_load(a, b, h, kMChunk, lane, iv, fv);
  }
  for (int j = 0;; ++j) {
    // the state before chunk j
    float* cj = cst + j * hd2;
#pragma unroll
    for (int jk = 0; jk < kMTileT / 2; ++jk)
#pragma unroll
      for (int dk = 0; dk < 2; ++dk) {
        const int k = k0 + 2 * ty + 32 * jk + dk;
#pragma unroll
        for (int jv = 0; jv < kMTileT / 2; ++jv) {
          const int v = v0 + 2 * tx + 32 * jv;
          if (k < hd && v < hd)
            *reinterpret_cast<float2*>(cj + static_cast<long long>(k) * hd
                                       + v) =
                make_float2(acc[2 * jk + dk][2 * jv],
                            acc[2 * jk + dk][2 * jv + 1]);
        }
      }
    if (nrow) nst[static_cast<long long>(j) * hd + k0 + threadIdx.x] = n_k;
    if (blockIdx.x == 0 && threadIdx.x == 0) mst[j] = m_start;
    if (j + 1 >= nch) break;
    // into the stage chunk j - 2 used: every thread is past it
    if (j + kAhead + 1 < nch)
      ms_load(a, sm + ((j + kAhead) % kStages) * MState::kStage, b, h,
              j + kAhead, k0, v0);
    cp_async_commit();
    cp_async_wait<kAhead>();
    __syncthreads();            // chunk j's K, V and weights
    float* st = sm + (j % kStages) * MState::kStage;
    const float* wb = sm + MState::kW + (j & 1) * MState::kWBuf;
    const float e = wb[kMChunk];
    m_start = wb[kMChunk + 1];
    // V's rows scaled by their weights, in place
    for (int p = threadIdx.x; p < kMChunk * kMTile / 4; p += kMThreads) {
      float4* x = reinterpret_cast<float4*>(st + MState::kV) + p;
      const float w = wb[p / (kMTile / 4)];
      float4 y = *x;
      y.x *= w;
      y.y *= w;
      y.z *= w;
      y.w *= w;
      *x = y;
    }
    __syncthreads();
#pragma unroll
    for (int r = 0; r < kMTileT; ++r)
#pragma unroll
      for (int q = 0; q < kMTileT; ++q) acc[r][q] *= e;
    const float* sk = st + MState::kK + 2 * ty;
    const float* sv = st + MState::kV + 2 * tx;
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
      n_k *= e;
      for (int s = 0; s < kMChunk; ++s)
        n_k = fmaf(wb[s], st[MState::kK + s * kMTile + threadIdx.x], n_k);
    }
    if (warp == 0 && j + 2 < nch) {          // chunk j + 1's weights
      m_w = ms_gates(iv, fv, m_w, lane,
                     sm + MState::kW + ((j + 1) & 1) * MState::kWBuf);
      m_gate_load(a, b, h, (j + 2) * kMChunk, lane, iv, fv);
    }
  }
}

// Shared memory of mlstm_scan_out_kernel<D16>, in floats: two stages of a
// slice of the contraction (q and k [L][KS + 4] and C^T's rows [KS][HD],
// or v's rows [KS][HD]); the running q k^T, then P [L][L + 4]; n [HD];
// e, n . q and sum_s P [L]; c and M [L] in double.
template <int D16>
struct MOut {
  static constexpr int HD = 16 * D16;
  static constexpr int KS = D16 % 2 == 0 ? 32 : 16;
  static constexpr int kStages = 2;
  static constexpr int kRow = KS + 4;
  static constexpr int kTR = kMChunk / 16;   // steps a thread, rows and columns
  static constexpr int kQ = 0;
  static constexpr int kK = kMChunk * kRow;
  static constexpr int kC = 2 * kMChunk * kRow;
  static constexpr int kStage = kC + KS * HD;
  static constexpr int kPRow = kMChunk + 4;
  static constexpr int kP = kStages * kStage;
  static constexpr int kN = kP + kMChunk * kPRow;
  static constexpr int kE = kN + HD;
  static constexpr int kQn = kE + kMChunk;
  static constexpr int kRs = kQn + kMChunk;
  static constexpr int kGc = kRs + kMChunk;
  static constexpr int kBig = kGc + 2 * kMChunk;
  static constexpr int kBytes = (kBig + 2 * kMChunk) * 4;
  // slices: q k^T and q C^T together (G1), then P v (G3)
  static constexpr int G1 = HD / KS, G3 = kMChunk / KS, G = G1 + G3;
};

// The columns of a row of HD floats that thread tx takes: 4 tx + 64 q4 + d
// (16-byte loads) when D16 is a multiple of 4, else tx + 16 q.
template <int D16>
__device__ __forceinline__ void m_vcols(const float* row, int tx,
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

__device__ __forceinline__ float f4_at(const float4& x, int d) {
  return d == 0 ? x.x : d == 1 ? x.y : d == 2 ? x.z : x.w;
}

// Slice g of chunk j's contraction into stage `st` (zero past S).
template <int D16>
__device__ __forceinline__ void mo_load(const MlstmScanArgs& a, float* st,
                                        const float* cj, int g, int b, int h,
                                        int t0, int nt) {
  using L = MOut<D16>;
  constexpr int HD = L::HD, KS = L::KS;
  const long long base =
      (static_cast<long long>(b) * a.S + t0) * a.H * HD
      + static_cast<long long>(h) * HD;
  const long long rowstep = static_cast<long long>(a.H) * HD;
  if (g < L::G1) {
    const int kk0 = g * KS;
    for (int p = threadIdx.x; p < kMChunk * KS / 4; p += kMThreads) {
      const int t = p / (KS / 4), c4 = 4 * (p % (KS / 4));
      const bool ok = t < nt;
      const long long off = ok ? base + t * rowstep + kk0 + c4 : 0;
      cp_async16(smem_addr(st + L::kQ + t * L::kRow + c4), a.q + off,
                 ok ? 16 : 0);
      cp_async16(smem_addr(st + L::kK + t * L::kRow + c4), a.k + off,
                 ok ? 16 : 0);
    }
    for (int p = threadIdx.x; p < KS * HD / 4; p += kMThreads)
      cp_async16(smem_addr(st + L::kC + 4 * p), cj + kk0 * HD + 4 * p, 16);
  } else {
    const int s0 = (g - L::G1) * KS;
    for (int p = threadIdx.x; p < KS * HD / 4; p += kMThreads) {
      const int s = p / (HD / 4), c4 = 4 * (p % (HD / 4));
      const bool ok = s0 + s < nt;
      cp_async16(smem_addr(st + s * HD + c4),
                 a.v + (ok ? base + (s0 + s) * rowstep + c4 : 0),
                 ok ? 16 : 0);
    }
  }
}

// The second pass: the outputs of chunk blockIdx.x of (b, h) = blockIdx.y
// from the state before it. Thread (ty, tx) takes steps t = kTR ty + i
// (i < kTR) and, in q k^T, s = tx + 16 q; in the outputs the columns of
// m_vcols. The contraction streams through two stages: over k, q k^T
// (each slice's sums added to the running ones in shared memory) and
// q C^T together, then P = D o (q k^T), its row sums, n . q and e (q C^T);
// then P v, each warp stopping at its last row's s.
template <int D16>
__global__ void __launch_bounds__(kMThreads, 2)
mlstm_scan_out_kernel(const MlstmScanArgs a) {
  using L = MOut<D16>;
  constexpr int HD = L::HD, KS = L::KS, kTR = L::kTR;
  constexpr int kParts = kMThreads / kMChunk;  // threads an n . q_t
  extern __shared__ float4 smem_f4[];
  float* sm = reinterpret_cast<float*>(smem_f4);
  double* c_s = reinterpret_cast<double*>(sm + L::kGc);
  double* big_s = reinterpret_cast<double*>(sm + L::kBig);
  const int j = blockIdx.x, nch = gridDim.x;
  const int bh = blockIdx.y, b = bh / a.H, h = bh % a.H;
  const int t0 = j * kMChunk, nt = min(kMChunk, a.S - t0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int tx = threadIdx.x & 15, ty = threadIdx.x >> 4;
  const long long sj = static_cast<long long>(bh) * nch + j;
  const float* cj = a.c_st + sj * HD * HD;

  for (int g = 0; g < L::kStages - 1; ++g) {
    if (g < L::G) mo_load<D16>(a, sm + g * L::kStage, cj, g, b, h, t0, nt);
    cp_async_commit();
  }
  for (int e = threadIdx.x; e < HD; e += kMThreads)
    sm[L::kN + e] = a.n_st[sj * HD + e];
  if (warp == 0) {
    // c_s, M_t = max(m, max_{s<=t} c_s) and e_t = exp(m - M_t)
    float iv[kMPer], fv[kMPer];
    m_gate_load(a, b, h, t0, lane, iv, fv);
    double c[kMPer], loc[kMPer];
    m_gate_terms(iv, fv, nt, lane, c);
    double run = -CUDART_INF;
#pragma unroll
    for (int q = 0; q < kMPer; ++q) {
      run = fmax(run, c[q]);
      loc[q] = run;
    }
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const double u = __shfl_up_sync(0xffffffffu, run, o);
      if (lane >= o) run = fmax(run, u);
    }
    double before = __shfl_up_sync(0xffffffffu, run, 1);
    const double mp = a.m_st[sj];
    if (lane == 0) before = mp;
    before = fmax(before, mp);
#pragma unroll
    for (int q = 0; q < kMPer; ++q) {
      const int s = kMPer * lane + q;
      const double big = fmax(before, loc[q]);
      c_s[s] = c[q];
      big_s[s] = big;
      sm[L::kE + s] = expf(static_cast<float>(mp - big));
    }
  }

  float acc[kTR][D16], qn = 0.f;
#pragma unroll
  for (int i = 0; i < kTR; ++i)
#pragma unroll
    for (int q = 0; q < D16; ++q) acc[i][q] = 0.f;
  const int tmax = 2 * kTR * (warp + 1) - 1;   // the warp's last step
  const int qmax = tmax / 16;                  // its last s = tx + 16 q
  const int qt = threadIdx.x / kParts, qp = threadIdx.x % kParts;
  float* pt = sm + L::kP + kTR * ty * L::kPRow + tx;   // P[kTR ty][tx]
  for (int g = 0; g < L::G; ++g) {
    const int gn = g + L::kStages - 1;       // into the stage slice g - 1 used
    if (gn < L::G)
      mo_load<D16>(a, sm + (gn % L::kStages) * L::kStage, cj, gn, b, h, t0,
                   nt);
    cp_async_commit();
    cp_async_wait<L::kStages - 1>();
    __syncthreads();
    const float* st = sm + (g % L::kStages) * L::kStage;
    if (g < L::G1) {                          // q k^T and q C^T
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
          qa[i] = *reinterpret_cast<const float4*>(
              st + L::kQ + (kTR * ty + i) * L::kRow + kk);
#pragma unroll
        for (int q = 0; q < kTR; ++q) {
          if (q > qmax) break;
          const float4 kb = *reinterpret_cast<const float4*>(
              st + L::kK + (tx + 16 * q) * L::kRow + kk);
#pragma unroll
          for (int i = 0; i < kTR; ++i) {
            float x = fmaf(qa[i].x, kb.x, sp[i][q]);
            x = fmaf(qa[i].y, kb.y, x);
            x = fmaf(qa[i].z, kb.z, x);
            sp[i][q] = fmaf(qa[i].w, kb.w, x);
          }
        }
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          float bv[D16];
          m_vcols<D16>(st + L::kC + (kk + d) * HD, tx, bv);
#pragma unroll
          for (int i = 0; i < kTR; ++i) {
            const float x = f4_at(qa[i], d);
#pragma unroll
            for (int q = 0; q < D16; ++q) acc[i][q] = fmaf(x, bv[q], acc[i][q]);
          }
        }
      }
      // the slice's sums of q k^T onto the running ones (this thread's own
      // entries of P: no barrier)
#pragma unroll
      for (int i = 0; i < kTR; ++i)
#pragma unroll
        for (int q = 0; q < kTR; ++q)
          if (q <= qmax) {
            float* x = pt + i * L::kPRow + 16 * q;
            *x = g == 0 ? sp[i][q] : *x + sp[i][q];
          }
      for (int kq = qp; kq < KS; kq += kParts)
        qn = fmaf(st[L::kQ + qt * L::kRow + kq], sm[L::kN + g * KS + kq], qn);
      if (g == L::G1 - 1) {
        // P = D o (q k^T) and its row sums; n . q; e_t (q_t C^T)
#pragma unroll
        for (int i = 0; i < kTR; ++i) {
          const int t = kTR * ty + i;
          float rs = 0.f;
#pragma unroll
          for (int q = 0; q < kTR; ++q) {
            const int s = tx + 16 * q;
            float* x = pt + i * L::kPRow + 16 * q;
            const float p =
                q <= qmax && s <= t
                    ? *x * expf(static_cast<float>(c_s[s] - big_s[t]))
                    : 0.f;
            *x = p;
            rs += p;
          }
#pragma unroll
          for (int o = 1; o < 16; o <<= 1)
            rs += __shfl_xor_sync(0xffffffffu, rs, o);
          if (tx == 0) sm[L::kRs + t] = rs;
          const float e = sm[L::kE + t];
#pragma unroll
          for (int q = 0; q < D16; ++q) acc[i][q] *= e;
        }
#pragma unroll
        for (int o = 1; o < kParts; o <<= 1)
          qn += __shfl_xor_sync(0xffffffffu, qn, o);
        if (qp == 0) sm[L::kQn + qt] = qn;
      }
    } else {                                  // P v
      const int s0 = (g - L::G1) * KS;
      const int smax = min(KS, tmax + 1 - s0);
      for (int ss = 0; ss < smax; ss += 4) {
        float4 pa[kTR];
#pragma unroll
        for (int i = 0; i < kTR; ++i)
          pa[i] = *reinterpret_cast<const float4*>(
              sm + L::kP + (kTR * ty + i) * L::kPRow + s0 + ss);
#pragma unroll
        for (int d = 0; d < 4; ++d) {
          float bv[D16];
          m_vcols<D16>(st + (ss + d) * HD, tx, bv);
#pragma unroll
          for (int i = 0; i < kTR; ++i) {
            const float x = f4_at(pa[i], d);
#pragma unroll
            for (int q = 0; q < D16; ++q) acc[i][q] = fmaf(x, bv[q], acc[i][q]);
          }
        }
      }
    }
    __syncthreads();                          // stage g's is free
  }
  // y = num / max(|den|, 1), den = e (n . q) + sum_s P
#pragma unroll
  for (int i = 0; i < kTR; ++i) {
    const int t = kTR * ty + i;
    if (t >= nt) continue;
    const float dp = sm[L::kE + t] * sm[L::kQn + t] + sm[L::kRs + t];
    const float den = fmaxf(fabsf(dp), 1.f);
    if (a.den != nullptr && tx == 0)
      a.den[(static_cast<long long>(b) * a.S + t0 + t) * a.H + h] = dp;
    float* yr = a.y + ((static_cast<long long>(b) * a.S + t0 + t) * a.H + h)
                          * HD;
    if constexpr (D16 % 4 == 0) {
#pragma unroll
      for (int q = 0; q < D16 / 4; ++q)
        *reinterpret_cast<float4*>(yr + 4 * tx + 64 * q) =
            make_float4(acc[i][4 * q] / den, acc[i][4 * q + 1] / den,
                        acc[i][4 * q + 2] / den, acc[i][4 * q + 3] / den);
    } else {
#pragma unroll
      for (int q = 0; q < D16; ++q) yr[tx + 16 * q] = acc[i][q] / den;
    }
  }
}

int launch_mlstm_state(const MlstmScanArgs& a, cudaStream_t s) {
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_scan_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      MState::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int ntile = (a.hd + kMTile - 1) / kMTile;
  mlstm_scan_state_kernel<<<dim3(ntile * ntile, a.B * a.H), kMThreads,
                            MState::kBytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D16>
int launch_mlstm_out(const MlstmScanArgs& a, cudaStream_t s) {
  using L = MOut<D16>;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_scan_out_kernel<D16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nch = (a.S + kMChunk - 1) / kMChunk;
  mlstm_scan_out_kernel<D16><<<dim3(nch, a.B * a.H), kMThreads, L::kBytes,
                               s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <int D16>
int mlstm_out_blocks_per_sm_t() {
  using L = MOut<D16>;
  int n = 0;
  cudaError_t err = cudaFuncSetAttribute(
      mlstm_scan_out_kernel<D16>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, mlstm_scan_out_kernel<D16>, kMThreads, L::kBytes);
  return err == cudaSuccess ? n : 0;
}

template <int D16>
int mlstm_out_smem_t() {
  return MOut<D16>::kBytes;
}

// ------------------------------------------------------------------ sLSTM
// The cell update's short forms (fast_*) are in xlstm_fast.cuh.

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
          const float lf = fast_log_sigmoid(pf);
          const float mf = __fadd_rn(lf, m);
          const float m_new = fmaxf(mf, pi);
          const float ip = fast_exp(__fsub_rn(pi, m_new));
          const float fp = fast_exp(__fsub_rn(mf, m_new));
          c = __fadd_rn(__fmul_rn(fp, c), __fmul_rn(ip, fast_tanh(pz)));
          n = __fadd_rn(__fmul_rn(fp, n), ip);
          const float sig = fast_sigmoid(po);
          const float hn =
              __fmul_rn(__fmul_rn(sig, c), fast_rcp(fmaxf(n, 1.f)));
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
// The mLSTM: the states pass, then the outputs pass (mlstm_scan_f32), or
// either alone (to time them apart). The scratch buffers of the args hold
// ceil(S / kMChunk) chunks (xlstm_scan_layout(0)).
extern "C" int mlstm_scan_state_f32(const MlstmScanArgs* a, void* stream) {
  if (!good_hd(a->hd)) return kBadHeadDim;
  if (static_cast<long long>(a->B) * a->H > kMaxGridYZ) return kBadGrid;
  return launch_mlstm_state(*a, static_cast<cudaStream_t>(stream));
}

extern "C" int mlstm_scan_out_f32(const MlstmScanArgs* a, void* stream) {
  const int hd = a->hd;
  if (!good_hd(hd)) return kBadHeadDim;
  if (static_cast<long long>(a->B) * a->H > kMaxGridYZ) return kBadGrid;
  XLSTM_HD_CASES(launch_mlstm_out, *a, static_cast<cudaStream_t>(stream))
  return kBadHeadDim;
}

extern "C" int mlstm_scan_f32(const MlstmScanArgs* a, void* stream) {
  const int err = mlstm_scan_state_f32(a, stream);
  return err ? err : mlstm_scan_out_f32(a, stream);
}

extern "C" int slstm_scan_f32(const SlstmScanArgs* a, void* stream) {
  const int hd = a->hd;
  if (!good_hd(hd)) return kBadHeadDim;
  if ((a->B + kSBatch - 1) / kSBatch > kMaxGridYZ || a->H > kMaxGridYZ)
    return kBadGrid;
  XLSTM_HD_CASES(launch_slstm, *a, static_cast<cudaStream_t>(stream))
  return kBadHeadDim;
}

// Blocks an SM holds at once of the mLSTM's states pass (which 0) or
// outputs pass (1), and their dynamic shared memory a block in bytes, at
// head dim hd (0 on error).
extern "C" int mlstm_scan_blocks_per_sm(int hd, int which) {
  if (!good_hd(hd)) return 0;
  if (which == 0) {
    int n = 0;
    cudaError_t err = cudaFuncSetAttribute(
        mlstm_scan_state_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MState::kBytes);
    if (err == cudaSuccess)
      err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
          &n, mlstm_scan_state_kernel, kMThreads, MState::kBytes);
    return err == cudaSuccess ? n : 0;
  }
  XLSTM_HD_CASES(mlstm_out_blocks_per_sm_t)
  return 0;
}

extern "C" int mlstm_scan_smem_bytes(int hd, int which) {
  if (!good_hd(hd)) return 0;
  if (which == 0) return MState::kBytes;
  XLSTM_HD_CASES(mlstm_out_smem_t)
  return 0;
}

// sLSTM clusters of kSCluster blocks the card holds at once for a call of
// `batch` rows and `heads` heads at head dim hd (0 on error).
extern "C" int slstm_scan_max_active_clusters(int hd, int batch, int heads) {
  if (!good_hd(hd)) return 0;
  XLSTM_HD_CASES(slstm_max_clusters_t, batch, heads)
  return 0;
}

// The layouts built: which 0 gives the mLSTM's chunk length, 1 the side
// of its states pass's C tile, 2 the sLSTM's blocks a cluster, 3 its batch
// rows a cluster.
extern "C" int xlstm_scan_layout(int which) {
  const int v[4] = {kMChunk, kMTile, kSCluster, kSBatch};
  return which >= 0 && which < 4 ? v[which] : 0;
}

extern "C" const char* xlstm_scan_error_string(int code) {
  if (code == kBadHeadDim)
    return "head dim has no kernel (a multiple of 16 up to 256)";
  if (code == kBadGrid) return "too many batch rows or heads for the grid";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
