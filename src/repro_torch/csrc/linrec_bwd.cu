// The backward of the diagonal linear recurrence for sm_90a: B2
// `linrec_bwd_f32`, the reverse-time adjoint of `linrec.cu`'s
// `linrec_kernel`.
//
// Replaces: the JAX package's custom VJP, jnp code with no Pallas kernel:
//           src/repro/kernels/linrec/ops.py::_bwd.
//
// Per (b, d) lane, t = T - 1 .. 0:
//   gx_t = a_{t+1} gx_{t+1} + gy_t    (a_T = 0, from 0; gy_{T-1} + g_hT)
//   ga_t = gx_t y_{t-1}                (y_{-1} = h0)
//   gh0  = gx_0 a_0
// g_a comes back in one of two shapes: a (T, B, D) plane, or, where the
// decay is one value a lane for every step and row (a per-neuron decay
// broadcast over T and B, as every training path passes it), its (D,)
// gradient: each lane sums its own ga_t in descending t, from +0, and the
// kernel's last CTA to finish sums those partials over B in ascending b.
// The cotangent gy may be the K-fold broadcast of a (T, B, N) plane, D =
// K N: lane (b, k N + n) reads gy[t, b, n], so a DH-LIF layer's branches
// take the soma's cotangent as it is (`kernels/linrec/ops.py::
// linrec_branches`) and no (T, B, D) gy plane is ever written.
//
// What bounds it on an H100: a lane's serial chain, a rounded product and
// a rounded add a step (about 11 cycles measured alone, 0.33 us at T = 60,
// 1.1 us at T = 200), the round trip that brings the steps in and the
// launch, not the bytes (a readout's are under 0.0002 ms of HBM time).
//
// Design. A CTA owns 32 lanes: a chain warp, whose thread l carries lane
// l's gx, a_{t+1} and g_a partial in registers, and seven helper warps.
// The planes live in shared memory in time order, [plane][row][lane], step
// t in row t % rows: gy (then gx), y_{t-1} (then ga_t, or read once for
// the partial) and a full decay plane where there is one. A call of at
// most MAX_ROWS steps (every training path's: T = 60, 64, 200) comes in as
// one tensor-copy (TMA) box a plane, started by one helper thread and
// landing on one mbarrier; y's box starts at step -1 and the chain puts
// h0 in that row. The chain then runs all T steps in one pass, LSEG steps
// at a time read from shared memory into registers, run with no branch
// among them and written back; the helpers store gx (and a ga plane)
// coalesced once the chain raises a fenced progress flag. Other calls (a
// decay plane, rows not of whole 16-byte groups, longer calls) come in by
// the helpers' cp.async in segments of LSEG steps, BUFS in flight in a
// ring of rows: the first round on one barrier, then a segment at a time
// as the helpers refill the rows the chain is through with.
//   What the stamps showed on the H100 (`chip_smoke.py`'s
// `phase_lane_bwd_passes`, and runs of the chain alone): the chain code
// alone runs at 11 cycles a step, but each hand-off between warps (a
// barrier or a flag and the fence behind it) costs some 300-400 cycles,
// issuing one cp.async or one tensor copy a few hundred, and a CTA's start
// some 500; so the design hands over once a call, issues one copy a plane,
// and warms the chain's code on scratch rows while the copies land.
//   g_a summed: the partials go to a (B, D) scratch; where 32 divides D a
// CTA's lanes are 32 columns of one row, and the last of the B CTAs of
// each 32-column group (a counter each, `arrive_of`) sums the group's
// columns over B in ascending b, its rows staged through shared memory by
// all its threads; else the grid's last CTA sums every column. So the
// wrapper launches nothing after the kernel.
//
// Rounding: every step is __fadd_rn(__fmul_rn(a, gx), gy), a rounded
// product and then a rounded add in descending t, each ga_t one rounded
// product, the partial a rounded add a step; the order of
// `kernels/linrec/ref.py::linrec_bwd_ref`, which this kernel equals bit
// for bit (and its gx equals `linrec.cu`'s forward kernel run on the
// time-reversed, one-shifted decay). nvcc would otherwise contract a step
// into one FMA.

#include <cuda.h>
#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

#ifdef LINREC_BWD_PASS_CLOCKS
#define LANE_BWD_CLK linrec_bwd_pass_clk
#endif
#include "lane_bwd.cuh"

// cycles by phase, in a build with -DLINREC_BWD_PASS_CLOCKS
// (`lane_bwd.cuh`)
LANE_BWD_CLK_READER(linrec_bwd_pass_clocks)

namespace {

// steps a cp.async segment holds, and the chain's batch of steps read
// into registers at once
constexpr int LSEG = 32;
// cp.async segments in flight (a call of fewer holds only its own)
constexpr int BUFS = 8;
// the chain's batch below a whole LSEG
constexpr int FB = 8;
// the most steps the tensor copies take (a box's rows)
constexpr int MAX_ROWS = 256;
// a CTA's threads: the chain warp and seven helper warps (a warp keeps only
// a few copies in flight, so the cp.async helpers are many)
constexpr int LB_THREADS = 256;
// the helper warps' threads
constexpr int HELPERS = LB_THREADS - 32;
static_assert(HELPERS % 32 == 0 && LSEG % FB == 0 && BUFS <= 32,
              "whole warps, batches, a barrier a buffer");
// g_a: none, a (T, B, D) plane, or the (D,) gradient of a decay constant
// over T and B
enum { GA_NONE, GA_PLANE, GA_SUM };
// the helpers' named barrier; barrier 0 is __syncthreads'
constexpr int BAR_HELPERS = 1;
__device__ __forceinline__ void helpers_sync() {
  asm volatile("bar.sync %0, %1;" ::"n"(BAR_HELPERS), "n"(HELPERS)
               : "memory");
}

// mbarriers in shared memory: a buffer's `landed` (the tensor copies'
// bytes, or each helper warp once its lanes' copies have landed), one
// phase a filling of the buffer
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];" ::"r"(bar)
               : "memory");
}
// arrives on `bar`, and makes its phase wait for `bytes` of async copies
// (the tensor copies below)
__device__ __forceinline__ void mbar_arrive_expect(uint32_t bar,
                                                   uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}
// one box of a 2-D or 3-D tensor map into shared memory, completing on
// `bar`; rows and columns past the tensor read zeros
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}
__device__ __forceinline__ void tma_load_3d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

struct LinrecBwdArgs {
  const float* a;        // the decay, read through its element strides
  int64_t sa_t, sa_b, sa_d;
  const float* y;        // (T, B, D): the forward's output
  const float* h0;       // (B, D)
  const float* gy;       // (T, B, N), D = K N: lane (b, k N + n) reads n
  const float* ghT;      // (B, D), or null (zero)
  float* part;           // (B, D): the per-lane g_a partials (GA_SUM)
  unsigned* count;       // counters at 0: the CTAs done (GA_SUM), one a
                         // column group
  float* gx;             // (T, B, D)
  float* ga;             // (T, B, D) or (D,), or null
  float* gh0;            // (B, D), or null
  int T, B, D, N;
  int rows;              // steps the planes hold in shared memory: T (its
                         // tensor copy's box) or min(segments, BUFS) LSEG
  bool branch3d;         // gy's tensor map is the soma's (N, B, T)
  bool grouped;          // D % 32 == 0: a CTA's lanes are 32 columns of
                         // one row, and each group of 32 columns is summed
                         // over B by the last of its B CTAs
  bool vec_gy, vec_y, vec_out;  // the 16-byte copies and stores
};

// The planes in shared memory, [plane][row][lane] with step t in row
// t % rows: a warp's reads of one step fill the 32 banks, and steps in
// time order are rows in order. Pointers at one row of each plane.
struct Rows {
  float* g;              // gy, then gx
  float* y;              // y_{t-1}, then ga_t (GA_PLANE)
  float* a;              // the decay (a full plane)
};

template <bool A_PLANE, int GA>
__device__ __forceinline__ Rows rows_at(float* sm, int rows, int r) {
  constexpr int P_Y = 1, P_A = GA != GA_NONE ? 2 : 1;
  return {sm + r * 32, sm + (P_Y * rows + r) * 32,
          sm + (P_A * rows + r) * 32};
}

// A helper thread's share of a segment's copies: its column (lane, or
// group of four lanes) of each plane and where its elements lie, and its
// first step and stride of steps.
struct Loader {
  int lanes, BN, h;
  bool in_gy, in_y, in_a;
  int off_gy, col_y;
  int64_t off_a;
  int u_gy, du_gy, u_y, du_y, du_a;

  __device__ Loader(const LinrecBwdArgs& p, int base) {
    constexpr int nt = HELPERS;
    lanes = p.B * p.D;
    BN = p.B * p.N;
    h = threadIdx.x - 32;
    // gy: lane (b, d) reads element (b, d % N) of each step
    const int cg = base + (p.vec_gy ? 4 * (h % 8) : h % 32);
    in_gy = cg < lanes;
    const int bg = cg / p.D, dg = cg - bg * p.D;
    off_gy = in_gy ? bg * p.N + (p.N == p.D ? dg : dg % p.N) : 0;
    u_gy = p.vec_gy ? h / 8 : h / 32;
    du_gy = p.vec_gy ? nt / 8 : nt / 32;
    const int cy = base + (p.vec_y ? 4 * (h % 8) : h % 32);
    in_y = cy < lanes;
    col_y = in_y ? cy : 0;
    u_y = p.vec_y ? h / 8 : h / 32;
    du_y = p.vec_y ? nt / 8 : nt / 32;
    du_a = nt / 32;
    // a full decay plane, through its strides, a lane a copy
    const int ca = base + h % 32, ba = ca / p.D;
    in_a = ca < lanes;
    off_a = in_a ? ba * p.sa_b + (int64_t)(ca - ba * p.D) * p.sa_d : 0;
  }

  // steps u .. n - 1 (every du-th) of a plane whose step t0 + u lies at
  // src, `stride` floats a step, into shared memory at dst (a row a step),
  // `SIZE` bytes a copy; lanes past the tensor's end (in false) read zeros
  template <int SIZE>
  __device__ __forceinline__ static void copies(uint32_t dst,
                                                const float* src,
                                                int64_t stride, bool in,
                                                int u, int du, int n) {
    dst += u * 32 * 4;
    src += u * stride;
    const int64_t dsrc = du * stride;
    for (; u < n; u += du, dst += du * 32 * 4, src += dsrc) {
      if constexpr (SIZE == 16)
        cp_async16(dst, src, in);
      else
        cp_async4(dst, src, in);
    }
  }

  // steps t0 .. t0 + n - 1 into the rows at `at`: gy, y_{t-1} where GA,
  // the decay where A_PLANE
  template <bool A_PLANE, int GA>
  __device__ __forceinline__ void load(const Rows& at, const LinrecBwdArgs& p,
                                       int t0, int n) const {
    const int q = h % 8, l = h % 32;
    const float* gy = p.gy + (int64_t)t0 * BN + off_gy;
    if (p.vec_gy)
      copies<16>(smem_u32(at.g + 4 * q), gy, BN, in_gy, u_gy, du_gy, n);
    else
      copies<4>(smem_u32(at.g + l), gy, BN, in_gy, u_gy, du_gy, n);
    if constexpr (GA != GA_NONE) {
      // y_{t-1}: step t0 - 1 on, h0 in step 0's place
      int u = u_y;
      const uint32_t dst = smem_u32(at.y + (p.vec_y ? 4 * q : l));
      if (t0 == 0 && u == 0) {
        if (p.vec_y)
          cp_async16(dst, p.h0 + col_y, in_y);
        else
          cp_async4(dst, p.h0 + col_y, in_y);
        u += du_y;
      }
      const float* y = p.y + (int64_t)(t0 - 1) * lanes + col_y;
      if (p.vec_y)
        copies<16>(dst, y, lanes, in_y, u, du_y, n);
      else
        copies<4>(dst, y, lanes, in_y, u, du_y, n);
    }
    if constexpr (A_PLANE)
      copies<4>(smem_u32(at.a + l), p.a + (int64_t)t0 * p.sa_t + off_a,
                p.sa_t, in_a, h / 32, du_a, n);
  }
};

// The helper warps write n rows from `src` on (a plane, steps t0 .. t0 +
// n - 1) to dst (T, B, D) at the CTA's lanes, coalesced.
__device__ __forceinline__ void store_helpers(const float* src, float* dst,
                                              bool vec, int lanes, int base,
                                              int t0, int n) {
  const int h = threadIdx.x - 32;
  if (vec) {
    for (int e = h; e < n * 8; e += HELPERS) {
      const int u = e / 8, col = base + 4 * (e % 8);
      if (col < lanes)
        *reinterpret_cast<float4*>(dst + (int64_t)(t0 + u) * lanes + col) =
            *reinterpret_cast<const float4*>(src + 4 * e);
    }
  } else {
    for (int e = h; e < n * 32; e += HELPERS) {
      const int col = base + e % 32;
      if (col < lanes) dst[(int64_t)(t0 + e / 32) * lanes + col] = src[e];
    }
  }
}

// The chain warp, once its lanes' partials are written: counts its CTA
// done on `count` by one acquire-release add of lane 0 after the warp's
// barrier (`lane_bwd.cuh`'s `arrive`, against `expected` arrivals);
// `last` (shared memory) is then true in the CTA that counted last.
__device__ __forceinline__ void arrive_of(unsigned* count, unsigned expected,
                                          bool& last) {
  __syncwarp();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], 1;"
                 : "=r"(old) : "l"(count) : "memory");
    last = old == expected - 1;
  }
}

// Columns d0 .. d0 + ncols - 1 of the partials part (B, D), each summed
// over B in ascending b, ((p[0] + p[1]) + p[2]) + ..., by the threads of
// the last CTA of their group, the rows read from L2 at once (the order
// of `sum_rows_ascending`, as `lane_bwd.cuh`'s `sum_over_b`); the counter
// goes back to 0 for the next launch on the stream.
__device__ __forceinline__ void sum_columns(const float* part, float* out,
                                            unsigned* count, int d0,
                                            int ncols, int B, int D) {
  constexpr int BB = 64;                   // loads in flight a thread
  for (int q = threadIdx.x; q < ncols; q += LB_THREADS) {
    const float* src = part + d0 + q;
    float sum = __ldcg(src);
    for (int b0 = 1; b0 < B; b0 += BB) {
      // rows past B read row B - 1 and are not added: loads with no
      // predicate, all in flight at once
      float x[BB];
#pragma unroll
      for (int j = 0; j < BB; ++j)
        x[j] = __ldcg(src + (int64_t)min(b0 + j, B - 1) * D);
#pragma unroll
      for (int j = 0; j < BB; ++j)
        if (b0 + j < B) sum = __fadd_rn(sum, x[j]);
    }
    out[d0 + q] = sum;
  }
  if (threadIdx.x == 0) *count = 0;
}

// A group's 32 columns d0 .. d0 + 31 of part (B, D) summed over B in
// ascending b, as `sum_columns`, the rows staged by every thread of the
// CTA through `stage` (64 rows of 32 floats), then added up by the chain
// warp's lanes from shared memory, a column a lane.
__device__ __forceinline__ void sum_group(const float* part, float* out,
                                          unsigned* count, float* stage,
                                          int d0, int B, int D) {
  constexpr int RB = 64;                   // rows staged at once
  const int lane = threadIdx.x % 32;
  float sum = 0.f;
  for (int b0 = 0; b0 < B; b0 += RB) {
    const int nb = min(RB, B - b0);
    for (int e = threadIdx.x; e < nb * 32; e += LB_THREADS)
      stage[e] = __ldcg(part + (int64_t)(b0 + e / 32) * D + d0 + e % 32);
    __syncthreads();
    if (threadIdx.x < 32) {
      int b = 0;
      if (b0 == 0) {
        sum = stage[lane];
        b = 1;
      }
      for (; b + 8 <= nb; b += 8) {
        float x[8];
#pragma unroll
        for (int j = 0; j < 8; ++j) x[j] = stage[(b + j) * 32 + lane];
#pragma unroll
        for (int j = 0; j < 8; ++j) sum = __fadd_rn(sum, x[j]);
      }
      for (; b < nb; ++b) sum = __fadd_rn(sum, stage[b * 32 + lane]);
    }
    __syncthreads();                       // before the stage refills
  }
  if (threadIdx.x < 32) out[d0 + lane] = sum;
  if (threadIdx.x == 0) *count = 0;
}

// The chain warp's reverse over n steps in the rows from `at` on, t
// descending: gx in place of gy, and ga_t in place of y_{t-1} (GA_PLANE)
// or added to the lane's partial `acc` (GA_SUM). g: gx_{t+1}, then gx_t;
// a_next: a_{t+1}; first: no step has run yet (the call's last step adds
// g_hT). Steps go in batches of LSEG, then FB, then one at a time: a
// batch's rows are read into registers at once, run with no branch among
// them, then written back.
template <bool A_PLANE, int GA>
__device__ __forceinline__ void reverse(const Rows& at, int n, float a_const,
                                        float g_last, float& g,
                                        float& a_next, float& acc,
                                        bool& first) {
  const int lane = threadIdx.x % 32;
  float* pg = at.g + lane;
  float* py = at.y + lane;
  const float* pa = at.a + lane;
  // one step: gx_t from gy_t, ga_t from y_{t-1}; a_t for the next
  auto step = [&](float gy, float yp, float at_, float& gx, float& ga) {
    g = __fadd_rn(__fmul_rn(a_next, g), gy);
    gx = g;
    if constexpr (GA != GA_NONE) {
      const float term = __fmul_rn(g, yp);
      if constexpr (GA == GA_SUM) {
        acc = __fadd_rn(acc, term);
      } else {
        ga = term;
      }
    }
    a_next = A_PLANE ? at_ : a_const;
  };
  // K steps top, top - 1, ...: all loads, the chain, all stores
  auto batch = [&](auto k, int top) {
    constexpr int K = decltype(k)::value;
    float GY[K], Y[K], A[K], GX[K], GA_[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const int u = 32 * (top - j);
      GY[j] = pg[u];
      Y[j] = GA != GA_NONE ? py[u] : 0.f;
      A[j] = A_PLANE ? pa[u] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) step(GY[j], Y[j], A[j], GX[j], GA_[j]);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      pg[32 * (top - j)] = GX[j];
      if (GA == GA_PLANE) py[32 * (top - j)] = GA_[j];
    }
  };
  int u0 = n - 1;
  if (first) {                             // the call's last step
    float gx, ga = 0.f;
    step(__fadd_rn(pg[32 * u0], g_last), GA != GA_NONE ? py[32 * u0] : 0.f,
         A_PLANE ? pa[32 * u0] : 0.f, gx, ga);
    pg[32 * u0] = gx;
    if (GA == GA_PLANE) py[32 * u0] = ga;
    first = false;
    --u0;
  }
  for (; u0 + 1 >= LSEG; u0 -= LSEG)
    batch(std::integral_constant<int, LSEG>{}, u0);
  for (; u0 + 1 >= FB; u0 -= FB) batch(std::integral_constant<int, FB>{}, u0);
  for (; u0 >= 0; --u0) batch(std::integral_constant<int, 1>{}, u0);
}

// The kernel. Two routes fill the planes:
//   tensor copies (TMA, T <= MAX_ROWS): one box a plane of all T steps,
//     started by one helper thread, landing on one barrier; the chain runs
//     all T steps at once, then the helpers store gx (and the ga plane);
//   cp.async (any call): segments of LSEG steps, BUFS of them in flight
//     in a ring of rows; the first round lands on one barrier (the chain
//     then runs it at once), later segments each on their buffer's barrier
//     as the helpers refill the rows the chain is through with (a fenced
//     progress flag, which the helpers poll; they store each segment's gx
//     as the chain finishes it).
template <bool A_PLANE, int GA, bool TMA>
__global__ void __launch_bounds__(LB_THREADS) linrec_bwd_kernel(
    const LinrecBwdArgs p, const __grid_constant__ CUtensorMap gy_map,
    const __grid_constant__ CUtensorMap y_map) {
  extern __shared__ __align__(16) float sm_raw[];
  __shared__ __align__(8) uint64_t landed[BUFS];
  // the segments the chain is through with (a flag the chain writes after
  // a fence, which the helpers poll)
  __shared__ int progress;
  __shared__ bool last;                      // this CTA counted last
  PASS_CLK_BEGIN;
  constexpr int NP = 1 + (GA != GA_NONE) + A_PLANE;
  // the tensor copies' destinations 128-byte aligned (an offset from the
  // shared array, so that the compiler keeps shared loads and stores)
  float* sm = sm_raw + ((128 - (smem_u32(sm_raw) & 127)) & 127) / 4;
  const int rows = p.rows;
  // past the planes: the chain's scratch rows
  float* scratch = sm + (size_t)NP * rows * 32;
  const int lanes = p.B * p.D;
  const int lane = threadIdx.x % 32;
  const int base = blockIdx.x * 32, idx = base + lane;
  const bool in = idx < lanes;
  // segments of LSEG steps, walked from the last; BUFS in flight
  const int segs = (p.T + LSEG - 1) / LSEG;
  const int nbuf = segs < BUFS ? segs : BUFS;
  const bool ring = !TMA && segs > BUFS;
  auto seg_t0 = [&](int i) { return (segs - 1 - i) * LSEG; };
  auto at = [&](int t) { return rows_at<A_PLANE, GA>(sm, rows, t % rows); };
  if (threadIdx.x < BUFS) {
    mbar_init(smem_u32(landed + threadIdx.x), TMA ? 1 : HELPERS / 32);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  if (threadIdx.x == 0) progress = 0;
  __syncthreads();
  // segment i's barrier: the first round lands on landed[0]'s phase 0, a
  // refill of buffer j = i % nbuf on landed[j]'s next phase
  auto landed_bar = [&](int i) { return smem_u32(landed + i % nbuf); };
  auto landed_phase = [&](int i) {
    const int r = i / nbuf;
    return (uint32_t)(i % nbuf == 0 ? r : r - 1) & 1;
  };
  if (threadIdx.x >= 32) {
    // the helper warps
    if constexpr (TMA) {
      if (threadIdx.x == 32) {
        const uint32_t b = smem_u32(landed);
        mbar_arrive_expect(b, (GA != GA_NONE ? 2 : 1) * rows * 32 *
                                  (uint32_t)sizeof(float));
        const Rows r0 = at(0);
        if (p.branch3d)
          tma_load_3d(smem_u32(r0.g), &gy_map, b,
                      (base - base / p.D * p.D) % p.N, base / p.D, 0);
        else
          tma_load_2d(smem_u32(r0.g), &gy_map, b, base, 0);
        if constexpr (GA != GA_NONE)
          tma_load_2d(smem_u32(r0.y), &y_map, b, base, -1);
      }
      if (threadIdx.x == 32) {
        while (*(volatile int*)&progress < 1) __nanosleep(64);
        __threadfence_block();               // the chain's writes seen
      }
      helpers_sync();
      store_helpers(at(0).g, p.gx, p.vec_out, lanes, base, 0, p.T);
      if constexpr (GA == GA_PLANE)
        store_helpers(at(0).y, p.ga, p.vec_out, lanes, base, 0, p.T);
    } else {
      const Loader ld(p, base);
      for (int j = 0; j < nbuf; ++j) {
        ld.load<A_PLANE, GA>(at(seg_t0(j)), p, seg_t0(j),
                             min(LSEG, p.T - seg_t0(j)));
        cp_async_commit();
      }
      cp_async_wait<0>();
      __syncwarp();
      if (lane == 0) mbar_arrive(smem_u32(landed));
      // the chain's progress in rounds: the first round (nbuf segments)
      // at once, then a segment at a time
      const int steps = ring ? segs : 1;
      for (int i = 0; i < steps; ++i) {
        if (threadIdx.x == 32) {
          while (*(volatile int*)&progress <= i) __nanosleep(64);
          __threadfence_block();             // the chain's writes seen
        }
        helpers_sync();
        // the segments this progress finished: the first round, or one
        const int s0 = ring ? i : 0, s1 = ring ? i + 1 : nbuf;
        for (int k = s0; k < s1; ++k) {
          const int t0 = seg_t0(k), n = min(LSEG, p.T - t0);
          store_helpers(at(t0).g, p.gx, p.vec_out, lanes, base, t0, n);
          if constexpr (GA == GA_PLANE)
            store_helpers(at(t0).y, p.ga, p.vec_out, lanes, base, t0, n);
        }
        if (ring && i + nbuf < segs) {
          helpers_sync();                    // the rows read out
          const int t1 = seg_t0(i + nbuf);
          ld.load<A_PLANE, GA>(at(t1), p, t1, min(LSEG, p.T - t1));
          cp_async_commit();
          cp_async_wait<0>();
          __syncwarp();
          if (lane == 0) mbar_arrive(landed_bar(i + nbuf));
        }
      }
    }
  } else {
    // the chain warp: the lane's decay (where it is one value for every
    // step), g_hT and (for the tensor copies) h0 loaded; its code run once
    // over the scratch rows while the first steps land (its instruction
    // fetches off the chain); then the steps from the last
    float a_const = 0.f, g_last = 0.f, h0v = 0.f;
    if (in) {
      const int b = idx / p.D;
      if (!A_PLANE) a_const = p.a[b * p.sa_b + (idx - b * p.D) * p.sa_d];
      if (p.ghT) g_last = p.ghT[idx];
      if (TMA && GA != GA_NONE) h0v = p.h0[idx];
    }
    float g = 0.f, a_next = 0.f, acc = 0.f;
    bool first = true;
    {
      float g_ = 0.f, a_ = 0.f, acc_ = 0.f;
      bool first_ = true;
      const Rows sc = rows_at<A_PLANE, GA>(scratch, LSEG, 0);
      reverse<A_PLANE, GA>(sc, FB + 2, 0.f, 0.f, g_, a_, acc_, first_);
      reverse<A_PLANE, GA>(sc, LSEG, 0.f, 0.f, g_, a_, acc_, first_);
    }
    auto signal = [&](int k) {               // through with k rounds
      __syncwarp();
      if (lane == 0) {
        __threadfence_block();
        *(volatile int*)&progress = k;
      }
    };
    auto finish = [&]() {                    // the call's first step done
      if (in && p.gh0) p.gh0[idx] = __fmul_rn(g, a_next);
      if constexpr (GA == GA_SUM) {
        if (in) p.part[idx] = acc;
        arrive_of(p.count + (p.grouped ? blockIdx.x % (p.D / 32) : 0),
                  p.grouped ? p.B : gridDim.x, last);
      }
    };
    if (lane == 0) mbar_wait(smem_u32(landed), 0);
    __syncwarp();
    PASS_CLK(CLK_LOAD);
    if (!ring) {
      // every step in place: y_{-1} = h0 in row 0 (the tensor box read
      // zeros there), then all T steps at once
      if (TMA && GA != GA_NONE) at(0).y[lane] = h0v;
      reverse<A_PLANE, GA>(at(0), p.T, a_const, g_last, g, a_next, acc,
                           first);
      PASS_CLK(CLK_REVERSE);
      signal(1);                             // the helpers store meanwhile
      finish();
    } else {
      for (int i = 0; i < segs; ++i) {
        const int t0 = seg_t0(i);
        if (i >= nbuf) {
          if (lane == 0) mbar_wait(landed_bar(i), landed_phase(i));
          __syncwarp();
          PASS_CLK(CLK_LOAD);
        }
        reverse<A_PLANE, GA>(at(t0), min(LSEG, p.T - t0), a_const, g_last,
                             g, a_next, acc, first);
        PASS_CLK(CLK_REVERSE);
        signal(i + 1);
        if (t0 == 0) finish();
      }
    }
  }
  if constexpr (GA == GA_SUM) {
    __syncthreads();                         // `last` seen
    PASS_CLK(CLK_STORE);
    // g_a over B, in ascending b, by the last CTA of each column group (of
    // the grid where D is no multiple of 32)
    if (last) {
      if (p.grouped) {
        const int g0 = blockIdx.x % (p.D / 32);
        sum_group(p.part, p.ga, p.count + g0, scratch, 32 * g0, p.B, p.D);
      } else {
        sum_columns(p.part, p.ga, p.count, 0, p.D, p.B, p.D);
      }
      __syncthreads();                       // `last` is the CTA's
    }
    PASS_CLK(CLK_SUMS);
  }
  PASS_CLK_END
}

// cuTensorMapEncodeTiled from the CUDA driver API, through the runtime
// (the library links no -lcuda)
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* f = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &f, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &f, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(f);
  }
  return fn;
}

// a contiguous fp32 tensor of `rank` dimensions (innermost first) as a
// tensor map of boxes of 32 x 1 ... x `rows` elements, no swizzle, zeros
// past every edge
bool make_map(CUtensorMap* map, const float* ptr, int rank,
              const cuuint64_t* dims, int rows) {
  cuuint64_t strides[2];
  cuuint64_t stride = dims[0] * sizeof(float);
  for (int i = 1; i < rank; ++i) {
    strides[i - 1] = stride;
    stride *= dims[i];
  }
  const cuuint32_t box3[3] = {32, 1, (cuuint32_t)rows},
                   box2[2] = {32, (cuuint32_t)rows};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, rank,
                        const_cast<float*>(ptr), dims, strides,
                        rank == 3 ? box3 : box2, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_NONE,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// The kernel's dynamic shared memory past the default 48 KB: take the
// opt-in, then launch a CTA of LB_THREADS a 32-lane group.
template <class Kernel>
int launch_kernel(Kernel kernel, size_t smem, const LinrecBwdArgs& p,
                  const CUtensorMap& gy_map, const CUtensorMap& y_map,
                  void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = ((int64_t)p.B * p.D + 31) / 32;
  kernel<<<(unsigned)blocks, LB_THREADS, smem, (cudaStream_t)stream>>>(
      p, gy_map, y_map);
  return (int)cudaGetLastError();
}

template <bool A_PLANE, bool TMA>
int launch(const LinrecBwdArgs& p, int ga_mode, const CUtensorMap& gy_map,
           const CUtensorMap& y_map, void* stream) {
  const int np = 1 + (ga_mode != GA_NONE) + A_PLANE;
  // the planes' rows and the chain's scratch rows, 128-byte aligned
  const size_t smem =
      (size_t)(p.rows + LSEG) * np * 32 * sizeof(float) + 128;
  switch (ga_mode) {
    case GA_PLANE:
      return launch_kernel(linrec_bwd_kernel<A_PLANE, GA_PLANE, TMA>, smem,
                           p, gy_map, y_map, stream);
    case GA_SUM:
      return launch_kernel(linrec_bwd_kernel<A_PLANE, GA_SUM, TMA>, smem, p,
                           gy_map, y_map, stream);
    default:
      return launch_kernel(linrec_bwd_kernel<A_PLANE, GA_NONE, TMA>, smem,
                           p, gy_map, y_map, stream);
  }
}

}  // namespace

extern "C" {

// The backward of linrec_f32 (see above): gx (T, B, D) from gy (T, B, N),
// D = K N (N = D where gy is the full plane), and g_hT (B, D) or null
// (zero); where not null, ga and gh0 (B, D). ga is a (T, B, D) plane, or
// with ga_summed the (D,) gradient of a decay with strides 0 over T and B,
// which needs `part` ((B, D) floats) and `count`: zeroed counters of the
// stream, D / 32 of them where 32 divides D, else one (left at 0). The
// segments come in by tensor copies where `kernels/linrec/ops.py::
// linrec_bwd_plan` says so (`tma`: a decay with no time stride, at most
// MAX_ROWS steps, rows of whole 16-byte groups, 16-byte aligned, the
// soma's rows of whole warps), else by cp.async; a `tma` call the planes
// do not allow, or whose tensor maps cannot be encoded, is refused.
int linrec_bwd_f32(const float* a, int64_t sa_t, int64_t sa_b, int64_t sa_d,
                   const float* y, const float* h0, const float* gy,
                   const float* ghT, float* part, unsigned* count, float* gx,
                   float* ga, float* gh0, int T, int B, int D, int N,
                   int ga_summed, int tma, void* stream) {
  const int64_t lanes = (int64_t)B * D;
  if (T < 1 || B < 1 || D < 1 || N < 1 || D % N != 0 ||
      lanes >= (int64_t)1 << 30 ||
      (ga && ga_summed && (!part || !count || (sa_t != 0 && T > 1) ||
                           (sa_b != 0 && B > 1))))
    return (int)cudaErrorInvalidValue;
  const int segs = (T + LSEG - 1) / LSEG;
  const int ga_mode = !ga ? GA_NONE : ga_summed ? GA_SUM : GA_PLANE;
  const bool aligned_gy = (uintptr_t)gy % 16 == 0;
  if (tma && !(sa_t == 0 && T <= MAX_ROWS && aligned_gy &&
               (N == D ? lanes % 4 == 0 : N % 32 == 0) &&
               (ga_mode == GA_NONE || lane_bwd_vec(lanes, y))))
    return (int)cudaErrorInvalidValue;
  if (tma && encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  LinrecBwdArgs p{
      a, sa_t, sa_b, sa_d, y, h0, gy, ghT, part, count, gx, ga, gh0, T, B, D,
      N, tma ? T : (segs < BUFS ? segs : BUFS) * LSEG, N != D, D % 32 == 0,
      (N == D ? lanes % 4 == 0 : N % 4 == 0) && aligned_gy,
      lane_bwd_vec(lanes, y, h0),
      ga_mode == GA_PLANE ? lane_bwd_vec(lanes, gx, ga)
                          : lane_bwd_vec(lanes, gx)};
  CUtensorMap gy_map{}, y_map{};
  if (tma) {
    const cuuint64_t plane[2] = {(cuuint64_t)lanes, (cuuint64_t)T};
    const cuuint64_t soma[3] = {(cuuint64_t)N, (cuuint64_t)B, (cuuint64_t)T};
    if (!(N == D ? make_map(&gy_map, gy, 2, plane, T)
                 : make_map(&gy_map, gy, 3, soma, T)) ||
        !(ga_mode == GA_NONE || make_map(&y_map, y, 2, plane, T)))
      return (int)cudaErrorNotSupported;
  }
  if (sa_t != 0) return launch<true, false>(p, ga_mode, gy_map, y_map, stream);
  return tma ? launch<false, true>(p, ga_mode, gy_map, y_map, stream)
             : launch<false, false>(p, ga_mode, gy_map, y_map, stream);
}

}  // extern "C"
