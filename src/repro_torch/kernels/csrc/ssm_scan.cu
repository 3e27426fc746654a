// Mamba's selective scan and the generic linear scan, for Hopper.
//
// Replaces the TPU kernels repro/kernels/ssm_scan.py:_sel_scan_kernel
// (launched by selective_scan_pallas) and _lin_scan_kernel (launched by
// ssm_scan_pallas), and adds the selective scan's backward, which the JAX
// package leaves to autodiff of its oracle. Plain versions:
// repro_torch/kernels/ref.py: selective_scan_ref, selective_scan_bwd_ref
// and ssm_scan_ref. Wrapper, checks, scratch and launch counts:
// repro_torch/kernels/ssm_scan.py.
//
// ---------------------------------------------------------------------
// Selective scan, for each batch row b, channel d and state n:
//   h_t = exp(dt_t * A) * h_{t-1} + (dt_t * x_t) * B_t,  A = -exp(a_log)
//   y_t = sum_n h_t * C_t + D * x_t
// x, dt [B,S,D] and B, C [B,S,N] in bf16 or f32, read through their batch
// and time strides (unit stride along D or N: B and C are column slices of
// the x_proj output); a_log [D,N], D [D], h0 and h_last [B,D,N] in f32
// (h0 null: a zero state);
// y [B,S,D] contiguous, in x's dtype, rounded once. The state and all
// arithmetic are f32.
//
// Bound. On the Jamba prefill path (B=1, S=4096, D=8192, N=16, bf16) the
// scan must read x and dt and write y, 3 x 2 B x 33.5 M = 201 MB: 0.060 ms
// at 3.35 TB/s. It must also take B*S*D*N = 537 M exponentials; the SFU
// gives 16 a clock on each of the 132 SMs, 0.13 ms if every one runs
// there. An exp2 can run on the FMA pipes instead (exp2_fma below), so
// the operations bind at ~0.08 ms with the best split (chip_smoke.py's
// scan_bound computes all three from the card's clock).
//
// Design. The TPU walked time as a sequential grid axis with the state in
// VMEM. Here a block owns kCh = 32 channels of one batch row and walks all
// of time itself:
//   * R = kR = 4 states a thread (of R = 2, 4 and 8 the fastest on an
//     H100, see PERF.md). A thread owns one
//     channel and R of its 16 (padded) states in registers, so the NL =
//     16 / R lanes of a channel sit side by side in a warp. sum_n h C is
//     taken in-thread over the R states and kept for each step of the
//     chunk: the chunk's steps are one straight run with no shuffle or
//     store in it, which the compiler schedules as one region, the
//     exponentials of every kExpAhead steps issued before their
//     recurrences (the SFU's latency is longer than a step). Then a
//     transposing butterfly (NL - 1 shuffles every NL steps) leaves lane
//     q with the sum for step q of each group. B_t and C_t come as 16-byte
//     shared-memory broadcasts, (dt, x) as one 8-byte load a step.
//   * Asynchronous staging. One producer warp streams chunks of kChunk
//     steps: x and dt tiles [kChunk][kCh] and the B and C rows by 16-byte
//     cp.async (zero-filled past S, D and N) into a ring of kRawStages raw
//     stages, then widens each chunk to f32 ((dt, x) pairs, B, C) into a
//     ring of kStages stages and arrives on that stage's "full" mbarrier.
//     The consumer warps wait on "full" and release through "empty"; the
//     time loop has no __syncthreads (one named barrier among the
//     consumer warps a chunk, for the y tile below).
//   * exp2 on two pipes: of each thread's R states the first P take exp2
//     on the FMA pipes (exp2_fma: Cody-Waite reduction and a degree-5
//     polynomial, 11 instructions), the rest ex2.approx on the SFU (P =
//     kP = 1 of 4). The choice depends on the state only, never on
//     the step, so a state carried across two calls equals one call bit
//     for bit.
//   * y = sum + D * x is formed per (step, channel) into the block's y
//     tile of the chunk (two tiles alternate); after the named barrier
//     each consumer warp writes whole rows of it as 16-byte pieces, the 4
//     (bf16) or 8 (f32) pieces of a row on neighbouring lanes: one 64- or
//     128-byte write a row, where a warp's own 16 bytes of 32 rows were
//     slow. A ragged S is zero-filled: dt = 0 gives exp2(0) = 1 exactly on
//     both pipes and leaves h as it is; channels past D and states past N
//     compute on zeros and are not stored.
//   * For the backward the forward can also store h before every kSeg-step
//     segment, f32 [B, ceil(S/kSeg), D, N] (h_seg). That is a separate
//     instantiation (kStates), launched when h_seg is not null, so the
//     inference path runs the same code as without it.
//
// ---------------------------------------------------------------------
// Selective-scan backward, from dy [B,S,D] (x's dtype) and dh_last
// [B,D,N] f32 (null: zero), with A = -exp(a_log), da_t = exp(dt_t A) and
// g_t the gradient of h_t:
//   g_t = dy_t C_t + da_{t+1} g_{t+1}         (g after the last step: dh_last)
//   dx_t = sum_n g_t dt_t B_t + D dy_t        ddt_t = sum_n g_t (A da_t h_{t-1}
//                                                       + x_t B_t)
//   dB_t = sum_d g_t dt_t x_t                 dC_t = sum_d dy_t h_t
//   da_log = A sum_{b,t} g_t dt_t da_t h_{t-1} dD = sum_{b,t} dy_t x_t
//   dh0 = da_1 g_1
// dx, ddt [B,S,D] and dB, dC [B,S,N] contiguous in the inputs' dtype;
// da_log [D,N], dD [D] and dh0 [B,D,N] in f32.
//
// Bound. It reads x, dt, dy, B, C and h_seg and writes dx, ddt, dB, dC,
// dh0: on the Jamba train path (B=2, S=4096, D=8192, N=16, bf16) about
// 5 x 2 B x 67 M + 268 MB of h_seg, 0.28 ms at 3.35 TB/s; and B*S*D*N =
// 1.1 G exponentials with about 20 f32 flops each, 0.32 ms (chip_smoke.py's
// scan_bound): the operations bind. The kernel takes two exp2 a state a
// step (the recomputed forward's, then the reverse walk's), 0.51 ms of SFU
// time at 1.98 GHz, and about 14 f32 operations (4 recomputing, 10
// walking back) besides the sums across lanes.
//
// What held the first design (one channel x 4 states a thread, 4 warps
// and 104 KB of shared memory a 32-channel block, h kept every 32 steps)
// at 3.95 ms, 8% of the bound: 8 warps an SM, mostly waiting; 28
// dependent shuffles a thread a step for the sums over states and
// channels; staging loads with no prefetch between two __syncthreads a
// segment; 268 MB of per-block partials.
//
// Design:
//   * The forward keeps h every kSeg = 16 steps (h_seg, 268 MB here), so
//     the trail of h_{t-1} a segment needs is 16 steps, 64 KB a block of
//     kBCh = 64 channels, and two blocks fit an SM: 8 consumer warps. The
//     trail is what bounds the resident warps: one block an SM ran 1.29x
//     slower; h every 8 steps, 3 blocks an SM, 7% slower (PERF.md has
//     the readings of the layouts tried).
//   * A consumer thread owns kBC = 2 neighbouring channels x kBR = 4
//     states: 8 independent recurrences, the sums over its 4 states and
//     its 2 channels in registers, (dt, x, dy) as 8-byte and B, C as
//     16-byte shared-memory broadcasts.
//   * A producer warp stages each segment (last to first) by cp.async:
//     f32 inputs straight into a ring of two f32 stages, bf16 ones into a
//     raw stage that it then widens into the ring, one segment ahead of
//     the consumers, through "full" and "empty" mbarriers. The consumers
//     load the next segment's h_seg into registers while they walk this
//     one.
//   * Reductions are batched kBBatch = 4 steps (the steps a straight run,
//     so exp2 and loads are issued ahead; the batch loop is not unrolled,
//     which keeps the code small: unrolled it ran 1.19-1.23x slower). sx and
//     sdt (dx, ddt) are reduce-scattered over a pair's 4 lanes, 12 shuffles
//     a batch, lane q keeping step q; dB and dC over the warp's 8 pairs,
//     28 shuffles, each lane keeping 4 states of one (step, dB or dC),
//     then summed over the 4 warps in order through shared memory at the
//     segment's end into one partial a block, [B, D/64, 2, S, N] (134 MB).
//     40 shuffles per 32 state-steps a thread, where the first design took
//     112.
//   * A second kernel (sel_scan_bwd_reduce_kernel) sums the partials over
//     the channel blocks and da_log's and dD's over the batch, each in a
//     fixed order, and scales da_log by A.
// No atomics: every sum runs in a fixed order and two calls give the same
// bits.
//
// ---------------------------------------------------------------------
// Linear scan: h_t = a_t * h_{t-1} + bx_t over axis 1, a and bx [B,S,D]
// contiguous of one dtype, h0 [B,D] f32 (null: zero), every h_t out in
// that dtype.
// Bound: one read of a and bx and one write of h, 0.060 ms at the path's
// (1, 4096, 8192) bf16. The old kernel, one thread a channel walking all
// of time, had too few loads in flight to approach it.
//
// Design: a single-pass chunked scan with decoupled look-back. The pair
// (a, b) composes associatively, (a1, b1) o (a2, b2) = (a1 a2, a2 b1 + b2).
//   * A tile is kLinSteps steps x kLinCh channels of one batch row; its
//     block takes the tile's index from an atomic counter, ordered time
//     chunk slowest, so a block only ever waits on tiles handed out before
//     its own, to blocks already running.
//   * Each thread loads a 4-byte column (2 bf16 channels or 1 f32) over
//     the tile's steps into registers, all loads in flight at once, and
//     forms its aggregate (prod a, end state from 0). The block publishes
//     the aggregates and sets its flag to 1 (release); chunk 0 publishes
//     its inclusive end state at once (flag 2).
//   * Look-back: thread 0 walks back over the predecessors' flags to the
//     nearest inclusive state j; every thread then rolls forward
//     h = A_i h + B_i over i = j+1 .. k-1 and publishes its own inclusive
//     state fma(A_k, h, B_k), flag 2. Rolling forward in time order gives
//     each inclusive state the same bits whichever j the walk stopped at,
//     so the result does not depend on timing: two calls agree bit for bit.
//   * The block rescans its registers from the incoming state and writes
//     every h_t. The wrapper allocates the counter, the flags and the
//     aggregates in one buffer; the launch zeroes the counter and flags
//     (cudaMemsetAsync on the stream) and the kernel allocates nothing.
// A state carried across two calls agrees with one call within rounding,
// not bit for bit: the association of the products changes with the split.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

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
  float* h_seg;      // [B, ceil(S/kSeg), D, N]: h before each segment, or null
  long long x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss;
  int B, S, D, N;
};

// Arguments of a selective-scan backward launch (both of its kernels);
// mirrored in ssm_scan.py.
struct SelScanBwdArgs {
  const void* x;
  const void* dt;
  const float* a_log;
  const void* b;
  const void* c;
  const float* d;
  const float* h_seg;     // the forward's, [B, ceil(S/kSeg), D, N]
  const void* dy;         // [B,S,D], unit stride along D
  const float* dh_last;   // [B,D,N] or null (zero)
  void* dx;               // [B,S,D] contiguous
  void* ddt;              // [B,S,D] contiguous
  void* db;               // [B,S,N] contiguous
  void* dc;               // [B,S,N] contiguous
  float* da_log;          // [D,N]
  float* dd;              // [D]
  float* dh0;             // [B,D,N]
  float* part_bc;         // [B, blocks, 2, S, N]: a block's dB and dC
  float* part_a;          // [B,D,N]: sum_t g dt da h_{t-1}
  float* part_d;          // [B,D]: sum_t dy x
  long long x_sb, x_ss, dt_sb, dt_ss, b_sb, b_ss, c_sb, c_ss, dy_sb, dy_ss;
  int B, S, D, N;
};

// Arguments of a linear-scan launch; mirrored in ssm_scan.py.
struct LinScanArgs {
  const void* a;
  const void* bx;
  const float* h0;
  void* out;
  int* tile_state;   // [1 + tiles]: the tile counter, then a flag a tile
  float2* agg;       // [tiles][kLinCh]: (prod a, end state from 0)
  float* incl;       // [tiles][kLinCh]: end state from the true h0
  int B, S, D;
  int vec;           // 1: a thread's 4-byte column loads as one word
};

namespace {

constexpr int kChunk = 32;       // time steps a stage (== warp size)
constexpr int kSeg = 16;         // steps between the states h_seg keeps
constexpr int kCh = 32;          // channels a selective-scan block
constexpr int kNP = 16;          // states, padded: N <= 16
constexpr int kTilePitch = kCh + 8;   // f32 a row of a y tile: the 4
                                      // lanes of a channel hit 4 bank groups
constexpr int kRawStages = 3;    // cp.async ring, raw dtype
constexpr int kExpAhead = 4;     // steps whose exp2 are issued together
constexpr int kStages = 3;       // f32 ring the consumers read
constexpr int kLinSteps = 64;    // linear scan: steps a tile
constexpr int kLinCh = 256;      // linear scan: channels a tile
constexpr float kLog2e = 1.4426950408889634f;
constexpr int kBadStateDim = 1000;   // N outside 1..16 (not a cudaError_t)

// The selective scan's split of a channel's kNP states: kR a thread, the
// first kP of them through exp2_fma. The library is built with this one
// split; chip_smoke.py also builds copies with -DSEL_SCAN_R and
// -DSEL_SCAN_P set, to time other splits beside it.
#ifndef SEL_SCAN_R
#define SEL_SCAN_R 4
#endif
#ifndef SEL_SCAN_P
#define SEL_SCAN_P 1
#endif
constexpr int kR = SEL_SCAN_R;
constexpr int kP = SEL_SCAN_P;
constexpr int kSelThreads = 32 * (kNP / kR + 1);   // NL consumer warps + 1
static_assert((kR == 2 || kR == 4 || kR == 8) && 0 <= kP && kP <= kR,
              "a split of the 16 states");

static_assert(kChunk == 32, "a consumer lane writes one row of a chunk");
static_assert(kChunk == 2 * kSeg && kSeg % kExpAhead == 0,
              "the forward keeps h at the start and middle of a chunk");

// The backward's layout: a consumer thread owns kBC neighbouring channels
// and kBR states of each, kBNL lanes a channel pair; kBWarps consumer
// warps and one producer warp a block of kBCh channels.
constexpr int kBR = 4;
constexpr int kBC = 2;
constexpr int kBNL = kNP / kBR;                    // 4 lanes a channel pair
constexpr int kBPairs = 32 / kBNL;                 // 8 pairs a warp
constexpr int kBWarps = 4;
constexpr int kBCh = kBWarps * kBPairs * kBC;      // 64 channels a block
constexpr int kBCons = 32 * kBWarps;               // consumer threads
constexpr int kBThreads = kBCons + 32;             // and the producer
constexpr int kBStages = 2;                        // f32 ring of segments
constexpr int kBBatch = 4;                         // steps a batch of sums
constexpr int kReduceThreads = 256;
static_assert(kBR == 4 && kBC == 2 && kBNL == 4 && kSeg % kBBatch == 0,
              "float4 states, float2 channel pairs; the batch's sums of the "
              "reverse walk are laid out for 4 lanes a pair and 4 steps");
static_assert(kBCons == kSeg * 2 * kNP / 4,
              "a consumer thread sums one float4 of a segment's dB and dC");

// Coefficients of exp2_fma's polynomial: 2^f ~ 1 + f (c1 + f (c2 + ...)),
// a relative minimax fit on [-1/2, 1/2] with p(0) = 1 exactly
// (tests/test_torch_ssm_scan.py reads them from here).
constexpr float kExp2C1 = 0.6931470036506653f;
constexpr float kExp2C2 = 0.24022242426872253f;
constexpr float kExp2C3 = 0.05550733953714371f;
constexpr float kExp2C4 = 0.009671512991189957f;
constexpr float kExp2C5 = 0.0013264714507386088f;
// 1.5 * 2^23 + 127: x + kExp2Round rounds x to an integer j in the low
// mantissa bits, biased by 127, so those bits shifted left by 23 are 2^j
constexpr float kExp2Round = 12583039.0f;

// 2^x for x <= 0 on the FMA pipes, within 2^-21 relative (its float32
// model in tests/test_torch_ssm_scan.py); 0 below -126.
// x = j + f with j = rint(x), |f| <= 1/2; 2^f by the polynomial; 2^j from
// j's bits. x is clamped at -127, where 2^j's bits are 0; results below
// 2^-126 flush to 0 (mul.ftz), as ex2.approx.ftz does.
__device__ __forceinline__ float exp2_fma(float x) {
  x = fmaxf(x, -127.f);
  const float t = x + kExp2Round;
  const float f = x - (t - kExp2Round);
  float p = fmaf(kExp2C5, f, kExp2C4);
  p = fmaf(p, f, kExp2C3);
  p = fmaf(p, f, kExp2C2);
  p = fmaf(p, f, kExp2C1);
  p = fmaf(p, f, 1.f);
  const float scale = __uint_as_float(__float_as_uint(t) << 23);
  float r;
  asm("mul.ftz.f32 %0, %1, %2;" : "=f"(r) : "f"(p), "f"(scale));
  return r;
}

__device__ __forceinline__ float exp2_sfu(float x) {
  float r;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(r) : "f"(x));
  return r;
}

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

// Two consecutive elements of shared memory, widened to f32.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

// Four consecutive elements of shared memory, widened to f32.
__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const uint2 u = *reinterpret_cast<const uint2*>(p);
  return make_float4(__uint_as_float(u.x << 16),
                     __uint_as_float(u.x & 0xffff0000u),
                     __uint_as_float(u.y << 16),
                     __uint_as_float(u.y & 0xffff0000u));
}

// Two f32 values as one word of two bf16, a in the low half, each rounded
// to nearest even.
__device__ __forceinline__ uint32_t pack2(__nv_bfloat16*, float a,
                                          float b) {
  uint32_t w;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(w) : "f"(b), "f"(a));
  return w;
}

// A 4-byte word of T (2 bf16 or 1 f32) widened to f32, and back.
template <typename T>
__device__ __forceinline__ void unpack(uint32_t w, float (&v)[4 / sizeof(T)]);
template <>
__device__ __forceinline__ void unpack<float>(uint32_t w, float (&v)[1]) {
  v[0] = __uint_as_float(w);
}
template <>
__device__ __forceinline__ void unpack<__nv_bfloat16>(uint32_t w,
                                                      float (&v)[2]) {
  v[0] = __uint_as_float(w << 16);
  v[1] = __uint_as_float(w & 0xffff0000u);
}
__device__ __forceinline__ uint32_t to_word(const float (&e)[1]) {
  return __float_as_uint(e[0]);
}
__device__ __forceinline__ uint32_t to_word(const __nv_bfloat16 (&e)[2]) {
  return __bfloat16_as_ushort(e[0])
         | (static_cast<uint32_t>(__bfloat16_as_ushort(e[1])) << 16);
}
__device__ __forceinline__ uint32_t pack_word(float*, const float (&h)[1]) {
  return __float_as_uint(h[0]);
}
__device__ __forceinline__ uint32_t pack_word(__nv_bfloat16* o,
                                              const float (&h)[2]) {
  return pack2(o, h[0], h[1]);
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory: the first `bytes` (0..16) from
// src, zeros after them.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(dst),
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

__device__ __forceinline__ int clamp16(int bytes) {
  return bytes < 0 ? 0 : bytes > 16 ? 16 : bytes;
}

// Transposing butterfly over the NL lanes of a channel: at width W a lane
// keeps the half of its pairs (i, i + W) that its bit W selects and
// receives the other half from lane q ^ W. Slot i then stands for step
// i + (q & W) + the bits already fixed, so at the end v[0] of lane q is
// the sum over the NL lanes of their step-q values, always grouped the
// same way. A recursion on W, so that every index into v is a constant
// and v stays in registers.
template <int W, int NL>
__device__ __forceinline__ void butterfly(float (&v)[NL], int q) {
  if constexpr (W >= 1) {
    const bool upper = (q & W) != 0;
#pragma unroll
    for (int i = 0; i < W; ++i) {
      const float send = upper ? v[i] : v[i + W];
      const float keep = upper ? v[i + W] : v[i];
      v[i] = keep + __shfl_xor_sync(0xffffffffu, send, W);
    }
    butterfly<W / 2>(v, q);
  }
}

// R consecutive f32 values of shared memory, as 16- or 8-byte loads.
template <int R>
__device__ __forceinline__ void load_states(const float* p, float (&v)[R]) {
  if constexpr (R % 4 == 0) {
#pragma unroll
    for (int i = 0; i < R; i += 4) {
      const float4 u = *reinterpret_cast<const float4*>(p + i);
      v[i] = u.x; v[i + 1] = u.y; v[i + 2] = u.z; v[i + 3] = u.w;
    }
  } else {
    static_assert(R == 2, "R is 2, 4 or 8");
    const float2 u = *reinterpret_cast<const float2*>(p);
    v[0] = u.x; v[1] = u.y;
  }
}

// Byte offsets of the selective scan's dynamic shared memory.
template <typename T>
struct SelSmem {
  static constexpr int kRawX = kChunk * kCh * sizeof(T);    // x or dt tile
  static constexpr int kRawB = kChunk * kNP * sizeof(T);    // B or C rows
  static constexpr int kRaw = 2 * kRawX + 2 * kRawB;        // a raw stage
  static constexpr int kDx = kChunk * kCh * 8;              // (dt, x) f32
  static constexpr int kFb = kChunk * kNP * 4;              // B or C f32
  static constexpr int kStage = kDx + 2 * kFb;              // an f32 stage
  static constexpr int kStageOff = kRawStages * kRaw;
  static constexpr int kYOff = kStageOff + kStages * kStage;
  static constexpr int kBarOff = kYOff + 2 * kChunk * kTilePitch * 4;
  static constexpr int kBytes = kBarOff + 2 * kStages * 8;
  static_assert(kRawB % 16 == 0 && kRaw % 16 == 0 && kStage % 16 == 0,
                "16-byte pieces");
};

// One 16-byte piece of a row of a y tile: 16 / sizeof(T) f32 values at
// src (shared memory), `valid` of them inside D, out to dst as T in one
// store where they all are.
template <typename T>
__device__ __forceinline__ void store_piece(T* dst, const float* src,
                                            int valid, bool vec) {
  constexpr int E = 16 / sizeof(T);
  if (vec && valid >= E) {
    const float4 u = *reinterpret_cast<const float4*>(src);
    if constexpr (sizeof(T) == 4) {
      *reinterpret_cast<float4*>(dst) = u;
    } else {
      const float4 w = *reinterpret_cast<const float4*>(src + 4);
      *reinterpret_cast<uint4*>(dst) =
          make_uint4(pack2(dst, u.x, u.y), pack2(dst, u.z, u.w),
                     pack2(dst, w.x, w.y), pack2(dst, w.z, w.w));
    }
  } else {
    for (int i = 0; i < E && i < valid; ++i) dst[i] = from_f32<T>(src[i]);
  }
}

// The forward's h of a thread's R states (from n0, of channel d, batch
// row bi) before segment seg, into h_seg: only the kStates instantiation
// calls it, so the inference path's code is the same as without it.
template <int R>
__device__ __forceinline__ void keep_state(const SelScanArgs& p, int bi,
                                           int seg, int d, int n0, bool dok,
                                           const float (&h)[R]) {
  const int n_segs = (p.S + kSeg - 1) / kSeg;
  float* hs = p.h_seg
              + ((static_cast<size_t>(bi) * n_segs + seg) * p.D + d) * p.N;
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (dok && n0 + r < p.N) hs[n0 + r] = h[r];
}

// Selective scan: one block per (kCh channels, batch row); NL consumer
// warps (kCh channels x NL lanes) and one producer warp, the last.
// kStates: also store h before every chunk into h_seg, for a backward (a
// separate instantiation, so the inference path's code is the same as
// without it).
template <typename T, int R, int P, bool kStates>
__global__ void __launch_bounds__(32 * (kNP / R + 1))
sel_scan_kernel(const SelScanArgs p) {
  constexpr int NL = kNP / R;           // lanes a channel
  constexpr int NCW = NL;               // consumer warps
  static_assert(kChunk % NL == 0 && P <= R, "tiles");
  static_assert((kChunk * kCh) % 128 == 0 && (kChunk * kNP) % 64 == 0,
                "the producer's lanes split a chunk evenly");
  using L = SelSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bars = smem_addr(smem + L::kBarOff);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kStages + s); };

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int bi = blockIdx.y, d0 = blockIdx.x * kCh;
  const int S = p.S, D = p.D, N = p.N;
  const int n_chunks = (S + kChunk - 1) / kChunk;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), NCW);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == NCW) {                    // ---------------- the producer
    const T* xg = static_cast<const T*>(p.x) + bi * p.x_sb;
    const T* dtg = static_cast<const T*>(p.dt) + bi * p.dt_sb;
    const T* bg = static_cast<const T*>(p.b) + bi * p.b_sb;
    const T* cg = static_cast<const T*>(p.c) + bi * p.c_sb;
    constexpr int E = 16 / sizeof(T);   // elements a 16-byte piece
    constexpr int XP = kCh / E;         // pieces a row of x or dt
    constexpr int BP = kNP / E;         // pieces a row of B or C
    auto issue = [&](int kc) {
      unsigned char* raw = smem + (kc % kRawStages) * L::kRaw;
      const int t0 = kc * kChunk;
#pragma unroll
      for (int m = 0; m < kChunk * XP / 32; ++m) {
        const int i = lane + 32 * m;
        const int t = t0 + i / XP, col = d0 + (i % XP) * E;
        const int bytes = t < S ? clamp16((D - col) * int(sizeof(T))) : 0;
        const long long ox = bytes ? t * p.x_ss + col : 0;
        const long long od = bytes ? t * p.dt_ss + col : 0;
        cp_async16(smem_addr(raw + 16 * i), xg + ox, bytes);
        cp_async16(smem_addr(raw + L::kRawX + 16 * i), dtg + od, bytes);
      }
#pragma unroll
      for (int m = 0; m < kChunk * BP / 32; ++m) {
        const int i = lane + 32 * m;
        const int t = t0 + i / BP, n = (i % BP) * E;
        const int bytes = t < S ? clamp16((N - n) * int(sizeof(T))) : 0;
        const long long ob = bytes ? t * p.b_ss + n : 0;
        const long long oc = bytes ? t * p.c_ss + n : 0;
        cp_async16(smem_addr(raw + 2 * L::kRawX + 16 * i), bg + ob, bytes);
        cp_async16(smem_addr(raw + 2 * L::kRawX + L::kRawB + 16 * i),
                   cg + oc, bytes);
      }
    };
    for (int kc = 0; kc < kRawStages - 1; ++kc) {
      if (kc < n_chunks) issue(kc);
      cp_async_commit();
    }
    for (int kc = 0; kc < n_chunks; ++kc) {
      if (kc + kRawStages - 1 < n_chunks) issue(kc + kRawStages - 1);
      cp_async_commit();
      cp_async_wait<kRawStages - 1>();  // this lane's pieces of chunk kc
      __syncwarp();                     // ... and every lane's
      const int s = kc % kStages;
      if (kc >= kStages) mbar_wait(empty(s), ((kc / kStages) + 1) & 1);
      const unsigned char* raw = smem + (kc % kRawStages) * L::kRaw;
      const T* rx = reinterpret_cast<const T*>(raw);
      const T* rdt = reinterpret_cast<const T*>(raw + L::kRawX);
      const T* rb = reinterpret_cast<const T*>(raw + 2 * L::kRawX);
      const T* rc = reinterpret_cast<const T*>(raw + 2 * L::kRawX + L::kRawB);
      unsigned char* st = smem + L::kStageOff + s * L::kStage;
      float4* dx = reinterpret_cast<float4*>(st);
      float2* fb = reinterpret_cast<float2*>(st + L::kDx);
      float2* fc = reinterpret_cast<float2*>(st + L::kDx + L::kFb);
      // all of a lane's loads first, then its stores: one shared-memory
      // round trip a chunk
      float4 xq[kChunk * kCh / 128], dq[kChunk * kCh / 128];
      float2 bq[kChunk * kNP / 64], cq[kChunk * kNP / 64];
#pragma unroll
      for (int m = 0; m < kChunk * kCh / 128; ++m) {
        xq[m] = load4(rx + 4 * (lane + 32 * m));
        dq[m] = load4(rdt + 4 * (lane + 32 * m));
      }
#pragma unroll
      for (int m = 0; m < kChunk * kNP / 64; ++m) {
        bq[m] = load2(rb + 2 * (lane + 32 * m));
        cq[m] = load2(rc + 2 * (lane + 32 * m));
      }
#pragma unroll
      for (int m = 0; m < kChunk * kCh / 128; ++m) {
        const int i = 2 * (lane + 32 * m);
        dx[i] = make_float4(dq[m].x, xq[m].x, dq[m].y, xq[m].y);
        dx[i + 1] = make_float4(dq[m].z, xq[m].z, dq[m].w, xq[m].w);
      }
#pragma unroll
      for (int m = 0; m < kChunk * kNP / 64; ++m) {
        fb[lane + 32 * m] = bq[m];
        fc[lane + 32 * m] = cq[m];
      }
      mbar_arrive(full(s));
      __syncwarp();                     // raw slot read before it refills
    }
    return;
  }

  // ------------------------------------------------------ the consumers
  const int ch = threadIdx.x / NL, q = threadIdx.x % NL, n0 = q * R;
  const int d = d0 + ch;
  const bool dok = d < D;
  float h[R], a2[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int n = n0 + r;
    const bool live = dok && n < N;
    h[r] = live && p.h0 ? p.h0[(static_cast<size_t>(bi) * D + d) * N + n]
                        : 0.f;
    a2[r] = live ? -expf(p.a_log[static_cast<size_t>(d) * N + n]) * kLog2e
                 : 0.f;
  }
  const float dv = dok ? p.d[d] : 0.f;
  float* ys = reinterpret_cast<float*>(smem + L::kYOff);   // two tiles
  // Consumer warp w writes rows of the chunk's tile: each lane a piece of
  // kPiece channels of one row, a row's pieces on neighbouring lanes.
  constexpr int kPiece = 16 / sizeof(T);           // channels a 16 B store
  constexpr int kLanesRow = kCh / kPiece;          // lanes a row
  constexpr int kRowsPass = 32 / kLanesRow;        // rows a warp store
  const int pr = lane / kLanesRow, pc = (lane % kLanesRow) * kPiece;
  const bool vec = (static_cast<long long>(D) * sizeof(T)) % 16 == 0;
  T* yb = static_cast<T*>(p.y) + static_cast<size_t>(bi) * S * D + d0 + pc;
  auto flush = [&](const float* tile, int kc) {
#pragma unroll
    for (int r0 = warp * kRowsPass; r0 < kChunk; r0 += NCW * kRowsPass) {
      const int row = r0 + pr, t = kc * kChunk + row;
      if (t < S)
        store_piece<T>(yb + static_cast<size_t>(t) * D,
                       tile + row * kTilePitch + pc, D - d0 - pc, vec);
    }
  };
  for (int kc = 0; kc < n_chunks; ++kc) {
    if constexpr (kStates) keep_state<R>(p, bi, 2 * kc, d, n0, dok, h);
    const int s = kc % kStages;
    mbar_wait(full(s), (kc / kStages) & 1);
    const unsigned char* st = smem + L::kStageOff + s * L::kStage;
    const float2* dx = reinterpret_cast<const float2*>(st);
    const float* fb = reinterpret_cast<const float*>(st + L::kDx);
    const float* fc = reinterpret_cast<const float*>(st + L::kDx + L::kFb);
    // the chunk's steps as one straight run with no shuffle or store in
    // it (a shuffle's convergence check would end the compiler's
    // scheduling region), each step's sum over this thread's R states
    // kept; then the sums across the NL lanes
    float part[kChunk];
#pragma unroll
    for (int t0 = 0; t0 < kChunk; t0 += kExpAhead) {
      // the chunk's second segment, where it lies inside S
      if constexpr (kStates) {
        if (t0 == kSeg && kc * kChunk + kSeg < S)
          keep_state<R>(p, bi, 2 * kc + 1, d, n0, dok, h);
      }
      // a sub-block's exponentials first, then its recurrences: each
      // exp2's result is used a sub-block of work after it is issued
      float da[kExpAhead][R], dtx[kExpAhead];
#pragma unroll
      for (int j = 0; j < kExpAhead; ++j) {
        const float2 e = dx[(t0 + j) * kCh + ch];     // (dt, x)
        dtx[j] = e.x * e.y;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          const float arg = e.x * a2[r];
          da[j][r] = r < P ? exp2_fma(arg) : exp2_sfu(arg);
        }
      }
#pragma unroll
      for (int j = 0; j < kExpAhead; ++j) {
        const int t = t0 + j;
        float bb[R], cc[R];
        load_states<R>(fb + t * kNP + n0, bb);
        load_states<R>(fc + t * kNP + n0, cc);
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < R; ++r) {
          h[r] = fmaf(da[j][r], h[r], dtx[j] * bb[r]);
          acc = r == 0 ? h[r] * cc[r] : fmaf(h[r], cc[r], acc);
        }
        part[t] = acc;
      }
    }
    float yv[kChunk / NL];              // y of steps q, q + NL, ...
#pragma unroll
    for (int gi = 0; gi < kChunk / NL; ++gi) {
      float v[NL];
#pragma unroll
      for (int j = 0; j < NL; ++j) v[j] = part[gi * NL + j];
      butterfly<NL / 2>(v, q);
      yv[gi] = fmaf(dv, dx[(gi * NL + q) * kCh + ch].y, v[0]);
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));
    // the block's y tile of the chunk, then each consumer warp writes
    // whole rows of it (one named barrier among the consumer warps a
    // chunk; the two tiles alternate, so a warp still writing out tile
    // kc & 1 is never overtaken before the next barrier)
    float* tile = ys + (kc & 1) * kChunk * kTilePitch;
#pragma unroll
    for (int gi = 0; gi < kChunk / NL; ++gi)
      tile[(gi * NL + q) * kTilePitch + ch] = yv[gi];
    asm volatile("bar.sync 1, %0;" ::"n"(32 * NCW) : "memory");
    flush(tile, kc);
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (dok && n0 + r < N)
      p.h_last[(static_cast<size_t>(bi) * D + d) * N + n0 + r] = h[r];
}

__device__ __forceinline__ int ld_acquire(const int* p) {
  int v;
  asm volatile("ld.acquire.gpu.global.s32 %0, [%1];" : "=r"(v) : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void st_release(int* p, int v) {
  asm volatile("st.release.gpu.global.s32 [%0], %1;" ::"l"(p), "r"(v)
               : "memory");
}

// Linear scan: one tile a block, kLinCh / CPT threads of CPT channels.
// Two bf16 blocks an SM: 255 registers a thread hold the 128 words with
// few spills (three blocks an SM spilled more and ran slower).
template <typename T>
__global__ void __launch_bounds__(kLinCh * sizeof(T) / 4,
                                  sizeof(T) == 2 ? 2 : 1)
lin_scan_kernel(const LinScanArgs p) {
  constexpr int CPT = 4 / sizeof(T);    // channels a thread: one 4-byte word
  __shared__ int s_tile, s_from;
  const int S = p.S, D = p.D;
  if (threadIdx.x == 0) s_tile = atomicAdd(p.tile_state, 1);
  __syncthreads();
  const int n_ct = (D + kLinCh - 1) / kLinCh;
  const int n_k = (S + kLinSteps - 1) / kLinSteps;
  const int k = s_tile / (p.B * n_ct);            // time chunk, slowest
  const int col = s_tile % (p.B * n_ct);          // (batch row, channels)
  const int bi = col / n_ct;
  const int c0 = (col % n_ct) * kLinCh + threadIdx.x * CPT;
  const int t0 = k * kLinSteps;
  const int nvalid = min(CPT, D - c0);            // <= 0: past D
  const size_t base = (static_cast<size_t>(bi) * S + t0) * D + c0;
  const T* a = static_cast<const T*>(p.a) + base;
  const T* bx = static_cast<const T*>(p.bx) + base;

  // the tile's column in registers, one 4-byte word a step (2 bf16
  // channels or 1 f32); pad steps and channels are (1, 0)
  uint32_t wa[kLinSteps], wb[kLinSteps];
  const bool whole = p.vec && nvalid == CPT && t0 + kLinSteps <= S;
  if (whole) {                          // every tile but the ragged ones
#pragma unroll
    for (int j = 0; j < kLinSteps; ++j) {
      const size_t off = static_cast<size_t>(j) * D;
      wa[j] = *reinterpret_cast<const uint32_t*>(a + off);
      wb[j] = *reinterpret_cast<const uint32_t*>(bx + off);
    }
  } else {
#pragma unroll
    for (int j = 0; j < kLinSteps; ++j) {
      const size_t off = static_cast<size_t>(j) * D;
      T ea[CPT], eb[CPT];
#pragma unroll
      for (int i = 0; i < CPT; ++i) {
        const bool in = t0 + j < S && i < nvalid;
        ea[i] = in ? a[off + i] : from_f32<T>(1.f);
        eb[i] = in ? bx[off + i] : from_f32<T>(0.f);
      }
      wa[j] = to_word(ea);
      wb[j] = to_word(eb);
    }
  }
  float ag[CPT], bg[CPT];
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    ag[i] = 1.f;
    bg[i] = 0.f;
  }
#pragma unroll
  for (int j = 0; j < kLinSteps; ++j) {
    float va[CPT], vb[CPT];
    unpack<T>(wa[j], va);
    unpack<T>(wb[j], vb);
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      ag[i] *= va[i];
      bg[i] = fmaf(va[i], bg[i], vb[i]);
    }
  }

  const int tile = col * n_k + k;
  const size_t slot = static_cast<size_t>(tile) * kLinCh + threadIdx.x * CPT;
  float h[CPT];
  if (k == 0) {
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      h[i] = i < nvalid && p.h0 ? p.h0[static_cast<size_t>(bi) * D + c0 + i]
                                : 0.f;
      p.incl[slot + i] = fmaf(ag[i], h[i], bg[i]);
    }
    __syncthreads();
    if (threadIdx.x == 0) st_release(p.tile_state + 1 + tile, 2);
  } else {
#pragma unroll
    for (int i = 0; i < CPT; ++i) p.agg[slot + i] = make_float2(ag[i], bg[i]);
    __syncthreads();
    if (threadIdx.x == 0) {
      st_release(p.tile_state + 1 + tile, 1);
      int j = k - 1;                  // back to the nearest inclusive state
      for (;;) {
        const int f = ld_acquire(p.tile_state + 1 + col * n_k + j);
        if (f == 2) break;
        if (f == 1) --j;
      }
      s_from = j;
    }
    __syncthreads();
    const int j = s_from;
    const size_t cs = static_cast<size_t>(col) * n_k;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      h[i] = __ldcg(p.incl + (cs + j) * kLinCh + threadIdx.x * CPT + i);
      for (int m = j + 1; m < k; ++m) {
        const float2 g = __ldcg(p.agg + (cs + m) * kLinCh
                                + threadIdx.x * CPT + i);
        h[i] = fmaf(g.x, h[i], g.y);
      }
      p.incl[slot + i] = fmaf(ag[i], h[i], bg[i]);
    }
    __syncthreads();
    if (threadIdx.x == 0) st_release(p.tile_state + 1 + tile, 2);
  }

  T* out = static_cast<T*>(p.out) + base;
#pragma unroll
  for (int j = 0; j < kLinSteps; ++j) {
    float va[CPT], vb[CPT];
    unpack<T>(wa[j], va);
    unpack<T>(wb[j], vb);
#pragma unroll
    for (int i = 0; i < CPT; ++i) h[i] = fmaf(va[i], h[i], vb[i]);
    const size_t off = static_cast<size_t>(j) * D;
    if (whole) {
      *reinterpret_cast<uint32_t*>(out + off) = pack_word(out, h);
    } else if (t0 + j < S) {
#pragma unroll
      for (int i = 0; i < CPT; ++i)
        if (i < nvalid) out[off + i] = from_f32<T>(h[i]);
    }
  }
}

// Byte offsets of the backward's dynamic shared memory: the trail of
// states; the f32 ring of segments (x, dt, dy tiles [t][channel], B and C
// rows [t][state]); for bf16 the raw stage cp.async fills (f32 inputs land
// in the ring itself, which has their layout); the segment's dB and dC of
// each consumer warp; the mbarriers.
template <typename T>
struct SelBwdSmem {
  static constexpr int kTrail = kSeg * kBC * kBCons * 16;     // float4 h_{t-1}
  static constexpr int kTile = kSeg * kBCh;                   // elements
  static constexpr int kRow = kSeg * kNP;                     // elements
  static constexpr int kStage = (3 * kTile + 2 * kRow) * 4;   // f32
  static constexpr int kRaw = sizeof(T) == 4 ? 0 : (3 * kTile + 2 * kRow)
                                                   * int(sizeof(T));
  static constexpr int kStageOff = kTrail;
  static constexpr int kRawOff = kStageOff + kBStages * kStage;
  static constexpr int kRedOff = kRawOff + kRaw;    // [t][warp][dB, dC][n]
  static constexpr int kBarOff = kRedOff + kSeg * kBWarps * 2 * kNP * 4;
  static constexpr int kBytes = kBarOff + 2 * kBStages * 8;
  static_assert(kStage % 16 == 0 && kRaw % 16 == 0, "16-byte pieces");
};

// One level of a reduce-scatter across the lanes that differ in bit M: of
// v's first K values a lane keeps the half its bit M selects (the upper
// half where it is set), adds its partner's copy of that half and leaves
// the sums in v[0 .. K/2). Each level adds in the same grouping on every
// call.
template <int K, int M, int V>
__device__ __forceinline__ void halve(float (&v)[V], int lane) {
  static_assert(K <= V && K % 2 == 0, "halve the first K values");
  constexpr int H = K / 2;
  const bool upper = (lane & M) != 0;
#pragma unroll
  for (int i = 0; i < H; ++i) {
    const float send = upper ? v[i] : v[i + H];
    const float keep = upper ? v[i + H] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, M);
  }
}

// Two neighbouring channels' values, out as T: one store where `pair`
// (both inside D, their offset even), else each one inside D alone.
template <typename T>
__device__ __forceinline__ void store_pair(T* dst, float a, float b,
                                           bool pair, bool ok0, bool ok1) {
  if (pair) {
    if constexpr (sizeof(T) == 4)
      *reinterpret_cast<float2*>(dst) = make_float2(a, b);
    else
      *reinterpret_cast<uint32_t*>(dst) = pack2(dst, a, b);
  } else {
    if (ok0) dst[0] = from_f32<T>(a);
    if (ok1) dst[1] = from_f32<T>(b);
  }
}

// Selective-scan backward: one block per (kBCh channels, batch row),
// kBWarps consumer warps and one producer warp, the last; segments last to
// first (see the note at the top).
template <typename T>
__global__ void __launch_bounds__(kBThreads, 2)
sel_scan_bwd_kernel(const SelScanBwdArgs p) {
  using L = SelBwdSmem<T>;
  extern __shared__ __align__(16) unsigned char smem[];
  const uint32_t bars = smem_addr(smem + L::kBarOff);
  auto full = [&](int s) { return bars + 8 * s; };
  auto empty = [&](int s) { return bars + 8 * (kBStages + s); };

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int bi = blockIdx.y, blk = blockIdx.x;
  const int d0 = blk * kBCh;
  const int S = p.S, D = p.D, N = p.N;
  const int nseg = (S + kSeg - 1) / kSeg;

  if (tid == 0) {
    for (int s = 0; s < kBStages; ++s) {
      mbar_init(full(s), 32);
      mbar_init(empty(s), kBWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();

  if (warp == kBWarps) {                // ---------------- the producer
    const T* xg = static_cast<const T*>(p.x) + bi * p.x_sb;
    const T* dtg = static_cast<const T*>(p.dt) + bi * p.dt_sb;
    const T* dyg = static_cast<const T*>(p.dy) + bi * p.dy_sb;
    const T* bg = static_cast<const T*>(p.b) + bi * p.b_sb;
    const T* cg = static_cast<const T*>(p.c) + bi * p.c_sb;
    constexpr int E = 16 / sizeof(T);   // elements a 16-byte piece
    constexpr int XP = kBCh / E;        // pieces a row of a channel tile
    constexpr int BP = kNP / E;         // pieces a row of B or C
    constexpr int TB = L::kTile * int(sizeof(T));   // bytes of a raw tile
    constexpr int RB = L::kRow * int(sizeof(T));    // ... of raw rows
    // segment seg's dt, x, dy, B and C in the raw layout at dst, zeros
    // past S, D and N
    auto issue = [&](int seg, unsigned char* dst) {
      const int t0 = seg * kSeg;
#pragma unroll
      for (int m = 0; m < kSeg * XP / 32; ++m) {
        const int i = lane + 32 * m;
        const int t = t0 + i / XP, col = d0 + (i % XP) * E;
        const int bytes = t < S ? clamp16((D - col) * int(sizeof(T))) : 0;
        cp_async16(smem_addr(dst + 16 * i),
                   dtg + (bytes ? t * p.dt_ss + col : 0), bytes);
        cp_async16(smem_addr(dst + TB + 16 * i),
                   xg + (bytes ? t * p.x_ss + col : 0), bytes);
        cp_async16(smem_addr(dst + 2 * TB + 16 * i),
                   dyg + (bytes ? t * p.dy_ss + col : 0), bytes);
      }
#pragma unroll
      for (int m = 0; m < (kSeg * BP + 31) / 32; ++m) {
        const int i = lane + 32 * m;
        if (kSeg * BP % 32 == 0 || i < kSeg * BP) {
          const int t = t0 + i / BP, n = (i % BP) * E;
          const int bytes = t < S ? clamp16((N - n) * int(sizeof(T))) : 0;
          cp_async16(smem_addr(dst + 3 * TB + 16 * i),
                     bg + (bytes ? t * p.b_ss + n : 0), bytes);
          cp_async16(smem_addr(dst + 3 * TB + RB + 16 * i),
                     cg + (bytes ? t * p.c_ss + n : 0), bytes);
        }
      }
    };
    unsigned char* raw = smem + L::kRawOff;
    if constexpr (sizeof(T) == 2) {
      issue(nseg - 1, raw);
      cp_async_commit();
    }
    for (int i = 0; i < nseg; ++i) {
      const int seg = nseg - 1 - i, s = i % kBStages;
      unsigned char* st = smem + L::kStageOff + s * L::kStage;
      if constexpr (sizeof(T) == 4) {   // straight into the ring
        if (i >= kBStages) mbar_wait(empty(s), ((i / kBStages) + 1) & 1);
        issue(seg, st);
        cp_async_commit();
        cp_async_wait<0>();
        mbar_arrive(full(s));
      } else {                          // the raw stage, widened
        cp_async_wait<0>();
        __syncwarp();                   // every lane's pieces have landed
        if (i >= kBStages) mbar_wait(empty(s), ((i / kBStages) + 1) & 1);
        constexpr int kPieces = L::kRaw / 16 / 32;
        static_assert(L::kRaw % (16 * 32) == 0, "whole pieces a lane");
        uint4 u[kPieces];
#pragma unroll
        for (int m = 0; m < kPieces; ++m)
          u[m] = reinterpret_cast<const uint4*>(raw)[lane + 32 * m];
        float4* f = reinterpret_cast<float4*>(st);
#pragma unroll
        for (int m = 0; m < kPieces; ++m) {
          const int i2 = 2 * (lane + 32 * m);
          f[i2] = make_float4(__uint_as_float(u[m].x << 16),
                              __uint_as_float(u[m].x & 0xffff0000u),
                              __uint_as_float(u[m].y << 16),
                              __uint_as_float(u[m].y & 0xffff0000u));
          f[i2 + 1] = make_float4(__uint_as_float(u[m].z << 16),
                                  __uint_as_float(u[m].z & 0xffff0000u),
                                  __uint_as_float(u[m].w << 16),
                                  __uint_as_float(u[m].w & 0xffff0000u));
        }
        mbar_arrive(full(s));
        __syncwarp();                   // the raw stage is read: refill it
        if (seg > 0) issue(seg - 1, raw);
        cp_async_commit();
      }
    }
    return;
  }

  // ------------------------------------------------------ the consumers
  float4* trail = reinterpret_cast<float4*>(smem);
  float* red = reinterpret_cast<float*>(smem + L::kRedOff);
  const int q = lane % kBNL, n0 = q * kBR;
  const int c0 = (warp * kBPairs + lane / kBNL) * kBC;   // in the block
  const int d = d0 + c0;
  bool dok[kBC];
#pragma unroll
  for (int c = 0; c < kBC; ++c) dok[c] = d + c < D;

  // an: A; a2: A log2(e), for exp2; g: the gradient carried from the step
  // after, da_{t+1} g_{t+1}, seeded with dh_last; acc: da_log's sum over
  // time; accd: dD's
  float an[kBC][kBR], a2[kBC][kBR], g[kBC][kBR], acc[kBC][kBR];
  float dv[kBC], accd[kBC];
#pragma unroll
  for (int c = 0; c < kBC; ++c) {
#pragma unroll
    for (int r = 0; r < kBR; ++r) {
      const int n = n0 + r;
      const bool live = dok[c] && n < N;
      const size_t o = static_cast<size_t>(d + c) * N + n;
      an[c][r] = live ? -expf(p.a_log[o]) : 0.f;
      a2[c][r] = an[c][r] * kLog2e;
      g[c][r] = live && p.dh_last
                    ? p.dh_last[static_cast<size_t>(bi) * D * N + o] : 0.f;
      acc[c][r] = 0.f;
    }
    dv[c] = dok[c] ? p.d[d + c] : 0.f;
    accd[c] = 0.f;
  }
  // the states before a segment, loaded a segment ahead of their use
  auto load_h = [&](int seg, float (&h)[kBC][kBR]) {
#pragma unroll
    for (int c = 0; c < kBC; ++c) {
      const float* hs = p.h_seg
          + ((static_cast<size_t>(bi) * nseg + seg) * D + d + c) * N + n0;
#pragma unroll
      for (int r = 0; r < kBR; ++r)
        h[c][r] = dok[c] && n0 + r < N ? hs[r] : 0.f;
    }
  };
  float hn[kBC][kBR];
  load_h(nseg - 1, hn);
  T* dxg = static_cast<T*>(p.dx) + static_cast<size_t>(bi) * S * D + d;
  T* ddtg = static_cast<T*>(p.ddt) + static_cast<size_t>(bi) * S * D + d;
  const bool pair = D % 2 == 0 && dok[1];   // t * D + d is even
  float* part = p.part_bc
                + static_cast<size_t>(bi * gridDim.x + blk) * 2 * S * N;

  for (int i = 0; i < nseg; ++i) {
    const int seg = nseg - 1 - i, s = i % kBStages, t0 = seg * kSeg;
    float h[kBC][kBR];
#pragma unroll
    for (int c = 0; c < kBC; ++c)
#pragma unroll
      for (int r = 0; r < kBR; ++r) h[c][r] = hn[c][r];
    if (seg > 0) load_h(seg - 1, hn);
    mbar_wait(full(s), (i / kBStages) & 1);
    const float* dts = reinterpret_cast<const float*>(
        smem + L::kStageOff + s * L::kStage);
    const float* xs = dts + L::kTile;
    const float* dys = xs + L::kTile;
    const float* bs = dys + L::kTile;
    const float* cs = bs + L::kRow;
    T* dxs = dxg + static_cast<size_t>(t0) * D;       // the segment's rows
    T* ddts = ddtg + static_cast<size_t>(t0) * D;

    // the segment's states from its first: trail[t] holds h_{t-1}
#pragma unroll
    for (int t = 0; t < kSeg; ++t) {
      const float2 dt2 = load2(dts + t * kBCh + c0);
      const float2 x2 = load2(xs + t * kBCh + c0);
      const float4 b4 = load4(bs + t * kNP + n0);
      const float dtv[kBC] = {dt2.x, dt2.y};
      const float dtx[kBC] = {dt2.x * x2.x, dt2.y * x2.y};
      const float bb[kBR] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
      for (int c = 0; c < kBC; ++c) {
        trail[(t * kBC + c) * kBCons + tid] =
            make_float4(h[c][0], h[c][1], h[c][2], h[c][3]);
#pragma unroll
        for (int r = 0; r < kBR; ++r)
          h[c][r] = fmaf(exp2_sfu(dtv[c] * a2[c][r]), h[c][r],
                         dtx[c] * bb[r]);
      }
    }
    // the previous segment's dB and dC are summed (red is free again)
    asm volatile("bar.sync 1, %0;" ::"n"(kBCons) : "memory");

    // the reverse walk, kBBatch steps a straight run (steps past S have
    // dt = x = dy = B = C = 0: g passes through unchanged and adds
    // nothing); h holds h_t of the step walked
#pragma unroll 1
    for (int tb = kSeg - kBBatch; tb >= 0; tb -= kBBatch) {
      // each step's sums: sx, sdt [j][type][c]; dB, dC [j][type][r]
      float vs[kBBatch * 2 * kBC], vb[kBBatch * 2 * kBR];
#pragma unroll
      for (int j = kBBatch - 1; j >= 0; --j) {
        const int t = tb + j;
        const float2 dt2 = load2(dts + t * kBCh + c0);
        const float2 x2 = load2(xs + t * kBCh + c0);
        const float2 dy2 = load2(dys + t * kBCh + c0);
        const float4 b4 = load4(bs + t * kNP + n0);
        const float4 c4 = load4(cs + t * kNP + n0);
        const float dtv[kBC] = {dt2.x, dt2.y}, xv[kBC] = {x2.x, x2.y};
        const float dyv[kBC] = {dy2.x, dy2.y};
        const float bb[kBR] = {b4.x, b4.y, b4.z, b4.w};
        const float cc[kBR] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
        for (int c = 0; c < kBC; ++c) {
          const float4 h4 = trail[(t * kBC + c) * kBCons + tid];
          const float hp[kBR] = {h4.x, h4.y, h4.z, h4.w};
          const float dtx = dtv[c] * xv[c];
          float sx = 0.f, sdt = 0.f;
#pragma unroll
          for (int r = 0; r < kBR; ++r) {
            const float da = exp2_sfu(dtv[c] * a2[c][r]);
            const float gt = fmaf(dyv[c], cc[r], g[c][r]);
            const float gn = gt * da;
            const float u = gn * hp[r];             // g_t da_t h_{t-1}
            acc[c][r] = fmaf(u, dtv[c], acc[c][r]);
            sdt = fmaf(u, an[c][r], sdt);
            sx = fmaf(gt, bb[r], sx);
            float& sb = vb[(j * 2 + 0) * kBR + r];    // dB over channels
            float& sc = vb[(j * 2 + 1) * kBR + r];    // dC
            sb = c == 0 ? gt * dtx : fmaf(gt, dtx, sb);
            sc = c == 0 ? dyv[c] * h[c][r] : fmaf(dyv[c], h[c][r], sc);
            g[c][r] = gn;
            h[c][r] = hp[r];
          }
          vs[(j * 2 + 0) * kBC + c] = sx;
          vs[(j * 2 + 1) * kBC + c] = sdt;
          accd[c] = fmaf(dyv[c], xv[c], accd[c]);
        }
      }
      // sx and sdt over the pair's 4 lanes: lane q keeps step tb + q
      halve<16, 2>(vs, lane);
      halve<8, 1>(vs, lane);
      // dB and dC over the warp's 8 pairs: lane bits 4, 3 pick the step,
      // bit 2 dB or dC, q the 4 states
      halve<32, 16>(vb, lane);
      halve<16, 8>(vb, lane);
      halve<8, 4>(vb, lane);
      {
        const int j = lane >> 3 & 3, w = lane >> 2 & 1;
        *reinterpret_cast<float4*>(
            red + (((tb + j) * kBWarps + warp) * 2 + w) * kNP + n0) =
            make_float4(vb[0], vb[1], vb[2], vb[3]);
      }
      // dx and ddt of step tb + q, both channels
      const int t = tb + q;
      const float2 dt2 = load2(dts + t * kBCh + c0);
      const float2 x2 = load2(xs + t * kBCh + c0);
      const float2 dy2 = load2(dys + t * kBCh + c0);
      if (t0 + t < S) {
        store_pair<T>(dxs + t * D, fmaf(dt2.x, vs[0], dy2.x * dv[0]),
                      fmaf(dt2.y, vs[1], dy2.y * dv[1]), pair, dok[0],
                      dok[1]);
        store_pair<T>(ddts + t * D, fmaf(x2.x, vs[0], vs[2]),
                      fmaf(x2.y, vs[1], vs[3]), pair, dok[0], dok[1]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty(s));   // this warp is done with it
    asm volatile("bar.sync 1, %0;" ::"n"(kBCons) : "memory");
    {                                   // the segment's dB and dC of the
      const int t = tid / 8, w = tid / 4 & 1, n = (tid & 3) * 4;  // block:
      float4 sum = make_float4(0.f, 0.f, 0.f, 0.f);   // the warps in order
#pragma unroll
      for (int k = 0; k < kBWarps; ++k) {
        const float4 v = *reinterpret_cast<const float4*>(
            red + ((t * kBWarps + k) * 2 + w) * kNP + n);
        sum.x += v.x; sum.y += v.y; sum.z += v.z; sum.w += v.w;
      }
      if (t0 + t < S) {
        float* o = part + (static_cast<size_t>(w) * S + t0 + t) * N + n;
        const float e[4] = {sum.x, sum.y, sum.z, sum.w};
#pragma unroll
        for (int k = 0; k < 4; ++k)
          if (n + k < N) o[k] = e[k];
      }
    }
  }

#pragma unroll
  for (int c = 0; c < kBC; ++c) {
#pragma unroll
    for (int r = 0; r < kBR; ++r) {
      const int n = n0 + r;
      if (dok[c] && n < N) {
        const size_t o = (static_cast<size_t>(bi) * D + d + c) * N + n;
        p.dh0[o] = g[c][r];
        p.part_a[o] = acc[c][r];
      }
    }
    if (dok[c] && q == 0) p.part_d[static_cast<size_t>(bi) * D + d + c] =
        accd[c];
  }
}

// The backward's second pass, one output element a thread: dB and dC
// summed over the channel blocks, da_log (times A) and dD over the batch,
// each in index order.
template <typename T>
__global__ void __launch_bounds__(kReduceThreads)
sel_scan_bwd_reduce_kernel(const SelScanBwdArgs p) {
  const long long i =
      static_cast<long long>(blockIdx.x) * kReduceThreads + threadIdx.x;
  const int B = p.B, S = p.S, D = p.D, N = p.N;
  const int nblk = (D + kBCh - 1) / kBCh;
  const long long sn = static_cast<long long>(S) * N;
  const long long nbc = B * sn, dn = static_cast<long long>(D) * N;
  if (i < 2 * nbc) {
    const int w = static_cast<int>(i / nbc);
    const long long j = i % nbc;            // (b, t, n) of dB or dC
    const long long bi = j / sn, tn = j % sn;
    float sum = 0.f;
    for (int k = 0; k < nblk; ++k)
      sum += p.part_bc[((bi * nblk + k) * 2 + w) * sn + tn];
    static_cast<T*>(w ? p.dc : p.db)[j] = from_f32<T>(sum);
  } else if (i < 2 * nbc + dn) {
    const long long j = i - 2 * nbc;        // (d, n)
    float sum = 0.f;
    for (int b = 0; b < B; ++b) sum += p.part_a[b * dn + j];
    p.da_log[j] = -expf(p.a_log[j]) * sum;
  } else if (i < 2 * nbc + dn + D) {
    const long long j = i - 2 * nbc - dn;   // d
    float sum = 0.f;
    for (int b = 0; b < B; ++b) sum += p.part_d[b * static_cast<long long>(D)
                                                + j];
    p.dd[j] = sum;
  }
}

constexpr int kMaxDevices = 64;

// Runs `set` (which sets kernel attributes) once a device: the attributes
// hold for every later launch there. `done` is the caller's.
template <typename F>
cudaError_t once_a_device(std::atomic<bool> (&done)[kMaxDevices], F set) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev < kMaxDevices && done[dev].load(std::memory_order_acquire))
    return cudaSuccess;
  err = set();
  if (err == cudaSuccess && dev < kMaxDevices)
    done[dev].store(true, std::memory_order_release);
  return err;
}

// A kernel's dynamic shared memory, and the largest shared-memory carveout.
template <typename K>
cudaError_t set_smem(K* kernel, int bytes) {
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributePreferredSharedMemoryCarveout,
                               cudaSharedmemCarveoutMaxShared);
  return err;
}

// The selective scan's (three blocks an SM) and its backward's (two).
template <typename T>
cudaError_t prepare_sel() {
  static std::atomic<bool> done[kMaxDevices];
  return once_a_device(done, [] {
    cudaError_t err = set_smem(sel_scan_kernel<T, kR, kP, false>,
                               SelSmem<T>::kBytes);
    return err == cudaSuccess ? set_smem(sel_scan_kernel<T, kR, kP, true>,
                                         SelSmem<T>::kBytes)
                              : err;
  });
}

template <typename T>
cudaError_t prepare_sel_bwd() {
  static std::atomic<bool> done[kMaxDevices];
  return once_a_device(done, [] {
    return set_smem(sel_scan_bwd_kernel<T>, SelBwdSmem<T>::kBytes);
  });
}

template <typename T>
int launch_sel(const SelScanArgs& a, void* stream) {
  if (a.N < 1 || a.N > kNP) return kBadStateDim;
  const cudaError_t err = prepare_sel<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.D + kCh - 1) / kCh, a.B);
  const auto s = static_cast<cudaStream_t>(stream);
  if (a.h_seg)
    sel_scan_kernel<T, kR, kP, true>
        <<<grid, kSelThreads, SelSmem<T>::kBytes, s>>>(a);
  else
    sel_scan_kernel<T, kR, kP, false>
        <<<grid, kSelThreads, SelSmem<T>::kBytes, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_sel_bwd(const SelScanBwdArgs& a, void* stream) {
  if (a.N < 1 || a.N > kNP) return kBadStateDim;
  const cudaError_t err = prepare_sel_bwd<T>();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((a.D + kBCh - 1) / kBCh, a.B);
  sel_scan_bwd_kernel<T><<<grid, kBThreads, SelBwdSmem<T>::kBytes,
                           static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_sel_bwd_reduce(const SelScanBwdArgs& a, void* stream) {
  const long long total = 2LL * a.B * a.S * a.N
                          + static_cast<long long>(a.D) * a.N + a.D;
  sel_scan_bwd_reduce_kernel<T>
      <<<static_cast<unsigned>((total + kReduceThreads - 1) / kReduceThreads),
         kReduceThreads, 0, static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_lin(const LinScanArgs& a, void* stream) {
  const long long tiles =
      static_cast<long long>(a.B) * ((a.D + kLinCh - 1) / kLinCh)
      * ((a.S + kLinSteps - 1) / kLinSteps);
  const auto s = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      cudaMemsetAsync(a.tile_state, 0, (1 + tiles) * sizeof(int), s);
  if (err != cudaSuccess) return static_cast<int>(err);
  lin_scan_kernel<T><<<static_cast<unsigned>(tiles),
                       kLinCh * sizeof(T) / 4, 0, s>>>(a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Plain C entry points for ctypes. Each returns cudaGetLastError() after
// the launch (0 = cudaSuccess) or kBadStateDim; the launch is
// asynchronous on `stream`.
extern "C" int selective_scan_bf16(const SelScanArgs* a, void* stream) {
  return launch_sel<__nv_bfloat16>(*a, stream);
}

extern "C" int selective_scan_f32(const SelScanArgs* a, void* stream) {
  return launch_sel<float>(*a, stream);
}

// The backward: the scan kernel, then its second pass (two launches the
// wrapper counts apart).
extern "C" int selective_scan_bwd_bf16(const SelScanBwdArgs* a,
                                       void* stream) {
  return launch_sel_bwd<__nv_bfloat16>(*a, stream);
}

extern "C" int selective_scan_bwd_f32(const SelScanBwdArgs* a, void* stream) {
  return launch_sel_bwd<float>(*a, stream);
}

extern "C" int selective_scan_bwd_reduce_bf16(const SelScanBwdArgs* a,
                                              void* stream) {
  return launch_sel_bwd_reduce<__nv_bfloat16>(*a, stream);
}

extern "C" int selective_scan_bwd_reduce_f32(const SelScanBwdArgs* a,
                                             void* stream) {
  return launch_sel_bwd_reduce<float>(*a, stream);
}

// The segment length of h_seg, in steps.
extern "C" int selective_scan_seg_steps() { return kSeg; }

extern "C" int ssm_scan_bf16(const LinScanArgs* a, void* stream) {
  return launch_lin<__nv_bfloat16>(*a, stream);
}

extern "C" int ssm_scan_f32(const LinScanArgs* a, void* stream) {
  return launch_lin<float>(*a, stream);
}

// The selective scan's dynamic shared memory a block, in bytes.
extern "C" int selective_scan_smem_bytes(int bf16) {
  return bf16 ? SelSmem<__nv_bfloat16>::kBytes : SelSmem<float>::kBytes;
}

// The split built: which 0 gives kR, 1 gives kP.
extern "C" int selective_scan_split(int which) {
  return which == 0 ? kR : kP;
}

// Selective-scan blocks an SM holds at once (0 on error).
template <typename T>
int sel_blocks_per_sm() {
  int n = 0;
  cudaError_t err = prepare_sel<T>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, sel_scan_kernel<T, kR, kP, false>, kSelThreads,
        SelSmem<T>::kBytes);
  return err == cudaSuccess ? n : 0;
}

extern "C" int selective_scan_blocks_per_sm(int bf16) {
  return bf16 ? sel_blocks_per_sm<__nv_bfloat16>()
              : sel_blocks_per_sm<float>();
}

// The backward's dynamic shared memory a block, its channels a block (the
// wrapper sizes the per-block partials by them) and its blocks an SM (0
// on error).
extern "C" int selective_scan_bwd_smem_bytes(int bf16) {
  return bf16 ? SelBwdSmem<__nv_bfloat16>::kBytes : SelBwdSmem<float>::kBytes;
}

extern "C" int selective_scan_bwd_block_channels() { return kBCh; }

template <typename T>
int sel_bwd_blocks_per_sm() {
  int n = 0;
  cudaError_t err = prepare_sel_bwd<T>();
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &n, sel_scan_bwd_kernel<T>, kBThreads, SelBwdSmem<T>::kBytes);
  return err == cudaSuccess ? n : 0;
}

extern "C" int selective_scan_bwd_blocks_per_sm(int bf16) {
  return bf16 ? sel_bwd_blocks_per_sm<__nv_bfloat16>()
              : sel_bwd_blocks_per_sm<float>();
}

// Linear-scan blocks an SM holds at once (0 on error).
extern "C" int ssm_scan_blocks_per_sm(int bf16) {
  int n = 0;
  const cudaError_t err =
      bf16 ? cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, lin_scan_kernel<__nv_bfloat16>, kLinCh / 2, 0)
           : cudaOccupancyMaxActiveBlocksPerMultiprocessor(
                 &n, lin_scan_kernel<float>, kLinCh, 0);
  return err == cudaSuccess ? n : 0;
}

// The linear scan's tile shape, for the wrapper's scratch.
extern "C" int ssm_scan_tile(int which) {
  return which == 0 ? kLinSteps : kLinCh;
}

extern "C" const char* ssm_scan_error_string(int code) {
  if (code == kBadStateDim) return "state dim N has no kernel (1..16)";
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
