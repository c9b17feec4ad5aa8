// The backward of the self-recurrent time scan for sm_90a: B4
// `lifrec_bwd_f32` (LIF, ADAPT = false) and B5 `alifrec_bwd_f32`
// (adaptive-threshold LIF, ADAPT = true).
//
// Replaces: the JAX package's custom VJPs, jnp `lax.scan` code with no
//           Pallas kernel: src/repro/kernels/lifrec/ops.py::_lifrec_bwd
//           and src/repro/kernels/alifrec/ops.py::_bwd_core (through
//           `_alifrec_bwd`).
//
// The STBP adjoint of `rec_scan.cuh`'s scan, per batch row b and neuron j,
// in two passes:
//   1. forward, along the saved spikes (their resets and adaptation;
//      nothing is re-thresholded), the forward's rounded steps
//        u_t = ((tau v_{t-1}) + I_t) + sum over i with s_{t-1}[i] = 1 of
//              W[i, j]  (ascending i)
//      written to a (T, B, N) scratch, and for ALIF a_{t-1} to another;
//   2. reverse, t = T - 1 .. 0, with (gv, ga) the cotangents of (v_t, a_t)
//      (gv_{T-1} = g_vT, ga_{T-1} = g_aT):
//        rec_t = sum_k Gu_{t+1}[k] W[j, k]  (from +0, ascending k; +0 at
//                t = T - 1)
//        and `surrogate.cuh`'s `neuron_adjoint`: Gs~ = (gs [+ ga]) + rec,
//        Sig = (Gs~ - gv u) g(u - th), Gu = gv (1 - s) + Sig,
//        gv <- tau Gu, ga <- rho ga - beta Sig;
//      writing g_current = Gu, the lane's g_tau partial (Gu_t v_{t-1}
//      summed in descending t; v_{t-1} = u_{t-1} (1 - s_{t-1}) arrives one
//      step late) and, for ALIF, its g_rho partial
//      (ga_t a_{t-1}, descending t); the wrapper sums the partials over B.
//      After t = 0: g_v0 = gv, g_a0 = ga and g_s0 = sum_k Gu_0[k] W[j, k],
//      the recurrent adjoint the chain would add at t = -1. A null output
//      pointer skips that output (the wrapper passes what autograd asks).
// g_W = sum_t s_{t-1}^T Gu_t is not computed here: the wrapper's
// autograd.Function hands it to the spike product (`csrc/spikemm.cu` or
// `spikemm_sparse.cu`) on the transposed, one-step-shifted raster.
//
// What bounds it on an H100: the chain. Each reverse step needs every
// neuron's Gu_{t+1} of its row (Gu is dense, so the recurrent adjoint is
// a full matvec, N terms a neuron, where the forward's is a sum over the
// set bits), and the N terms of a neuron are one dependent chain of
// rounded adds, to equal the plain version bit for bit. So a window of T
// steps takes at least T x N dependent adds of ~4 cycles (the chain
// floor: 200 x 64 x 4 cycles, ~26 us at 1.98 GHz, for the ECG's
// training window), plus a step's few rounded operations after the sum,
// its Gu exchange, and pass 1's T event-driven steps; the bytes (the
// planes read and written once) are about a microsecond at 3.35 TB/s.
//
// Design: the forward's two routes, chosen by the wrapper with the same
// `kernels/common.py::rec_route(N)`.
// - The warp route, N <= 32 * REC_LANE_NEURONS (the ECG SRNN's 64). A
//   block owns a batch row (B = 16 takes 16 SMs), 256 threads: the row's
//   neurons a thread each over NW = ceil(N / 32) "chain" warps (KP = 32 NW
//   threads), and 8 - NW helper warps. Both passes walk chunks of TC steps
//   (32; 16 above 64 neurons) through shared memory, so that the chain
//   threads do only what is serial and the rest runs beside them:
//   * pass 1's chain is u_t = ((tau v) + I_t) + rec_t, v = u (1 - s), a =
//     rho a + s: four rounded operations a step. Two phases a chunk,
//     each ended by a __syncthreads: (a) the chain runs chunk k - 1 while
//     the helpers load chunk k's currents and spikes and ballot its spike
//     words; (b) every warp sums W's rows of the set bits of chunk k
//     (rec_t, W in shared memory) and writes chunk k - 1's u (and
//     a_{t-1}) to the scratch and g(u - th) (the surrogate switch once a
//     thread and chunk) to g_current's plane, which pass 2 reads before
//     it overwrites it with Gu;
//   * pass 2's chain is rec_t and `neuron_adjoint_g`'s four rounded
//     operations on it (+ rec, - gv u, x g, + gv (1 - s)), with the named
//     barrier of the chain warps (`bar.sync 1, KP`; __syncwarp for one
//     warp) for the row's Gu exchange a step; gv u, gv (1 - s), the g_tau
//     and g_rho terms and ga run beside the sum. One __syncthreads a
//     chunk: while the chain runs chunk k, the helpers stage chunk k + 1
//     (u, g, s, Gs, a_{t-1}) and write chunk k - 1's Gu to g_current.
//   For rows of up to 64 neurons a chain thread keeps its neuron's row of
//   W (W[j, k], all k: 64 registers at the ECG's N, loaded from W^T
//   coalesced before pass 1), so a term of the sum reads only
//   Gu_{t+1}[k], 16 bytes at a time from the row's double-buffered Gu
//   array (the same address in every thread: a broadcast); wider rows
//   (96, 128) read W^T[k, j] from shared memory, which replaces W there
//   between the passes.
// - The block route, wider rows. One block owns one batch row, each thread
//   NPT neurons (j, j + blockDim, ...), as the forward's block route. Pass
//   1 keeps the spikes as a bit mask in shared memory (one ballot per 32
//   neurons, double-buffered: one __syncthreads a step); pass 2 exchanges
//   Gu through a double-buffered shared array, one __syncthreads a step.
//   W (then W^T) sits in shared memory when it fits beside the masks and
//   the Gu buffers (N <= 240 on an H100's 227 KB opt-in, one fewer than
//   the forward's 241: the Gu buffers), else both passes read W and W^T
//   through L2, coalesced across the threads at each step of the chain.
//   A thread loads the inputs of a group of steps (the current and spike
//   in pass 1; u, a_{t-1}, s and Gs in pass 2) into registers while the
//   chain runs over the group before, and issues the adjoint's shared
//   loads 8 terms ahead of their adds (`rec_adjoint`).
// Both routes sum rec_t in the plain version's order: from +0, one chain
// over ascending k (the warp route's zero terms past N leave it as it is:
// a sum that starts at +0 is never -0).
//
// Rounding: every product and sum is __fmul_rn/__fadd_rn/__fsub_rn in the
// plain versions' order (`kernels/lifrec/ref.py::lifrec_scan_bwd_ref`,
// `kernels/alifrec/ref.py::alifrec_scan_bwd_ref`), and a neuron's
// arithmetic does not depend on which thread owns it or on the route, so
// the kernels equal them bit for bit (sigmoid: within its expf).

#include <cuda_runtime.h>
#include <cstdint>

#include "surrogate.cuh"

#ifndef REC_LANE_NEURONS
#error "rec_bwd.cu needs -DREC_LANE_NEURONS (kernels/_build.py passes it)"
#endif

// Cycles by pass of the warp route, in a build with -DREC_BWD_PASS_CLOCKS
// (`chip_smoke.py` makes one beside the library): thread 0 of block b
// stamps clock64() into rec_bwd_pass_clk[4 b + k] at the kernel's start
// (k = 0), after its prologue (1), after pass 1 (2) and at its end (3);
// `rec_bwd_pass_clocks` copies the stamps out. Without the flag the
// stamps compile to nothing.
#ifdef REC_BWD_PASS_CLOCKS
constexpr int PASS_CLK_BLOCKS = 65536;
__device__ long long rec_bwd_pass_clk[4 * PASS_CLK_BLOCKS];
#define PASS_STAMP(k)                                        \
  if (threadIdx.x == 0 && blockIdx.x < PASS_CLK_BLOCKS)     \
    rec_bwd_pass_clk[4 * blockIdx.x + (k)] = clock64()

extern "C" int rec_bwd_pass_clocks(long long* dst, int n) {
  if (n < 0 || n > 4 * PASS_CLK_BLOCKS) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(dst, rec_bwd_pass_clk,
                                   n * sizeof(long long));
}
#else
#define PASS_STAMP(k)
#endif

namespace {

constexpr int BWD_THREADS = 1024;   // most threads a block may have
constexpr unsigned ALL = 0xffffffffu;
constexpr int LANE_NB = REC_LANE_NEURONS;   // the forward's neurons a lane
constexpr int WARP_NB = 32 * LANE_NB;       // widest row of the warp route
// The warp route: threads a block (a row's KP = 32 NW chain threads, the
// rest helpers), the widest row whose neurons keep W's row in registers,
// and the steps a pass-2 thread unrolls.
constexpr int ROW_THREADS = 256;
constexpr int REGW_MAX_KP = 64;
constexpr int G2 = 4;
static_assert(LANE_NB > 0 && (LANE_NB & (LANE_NB - 1)) == 0,
              "REC_LANE_NEURONS is a power of two");
static_assert(WARP_NB % 32 == 0 && WARP_NB <= ROW_THREADS - 4 * 32,
              "a row of the warp route leaves four helper warps");

struct BwdArgs {
  const float* cur;  // (T, B, N)
  const float* w;    // (N, N)
  const float* wt;   // (N, N): w transposed
  const float* tau;  // (N,)
  const float* rho;  // (N,); ALIF only
  const float* v0;   // (B, N)
  const float* a0;   // (B, N); ALIF only
  const float* s0;   // (B, N), 0/1
  const float* sp;   // (T, B, N): the forward's spikes
  const float* gs;   // (T, B, N): their cotangent
  const float* gvT;  // (B, N)
  const float* gaT;  // (B, N); ALIF only
  float* ubuf;       // (T, B, N) scratch: u_t
  float* abuf;       // (T, B, N) scratch: a_{t-1}; ALIF only
  float* gc;         // (T, B, N): g_current
  float* gtau;       // (B, N): g_tau partials, or null
  float* grho;       // (B, N): g_rho partials, or null; ALIF only
  float* gv0;        // (B, N), or null
  float* ga0;        // (B, N), or null; ALIF only
  float* gs0;        // (B, N), or null
  int T, B, N;
  float v_th, beta, alpha;
  int sur;
};

// Steps whose inputs a thread loads ahead: the loads of the next group of
// G steps are issued before this group's chain, 8 values a plane a thread.
template <int R>
__host__ __device__ constexpr int group_steps() {
  return R >= 8 ? 1 : 8 / R;
}

// Terms of the recurrent adjoint whose shared loads are issued before
// their products and adds.
template <int R>
__host__ __device__ constexpr int adjoint_unroll() {
  return R <= 2 ? 8 : (R <= 8 ? 4 : 1);
}

// rec[r] = sum_k gu[k] W[j[r], k], from +0 over ascending k, for the R
// neurons a thread owns; wt = W^T (row stride N), so the threads of a warp
// read consecutive words at each k. U terms' loads go out before their
// products and adds: the add chain, which must stay in order to equal the
// plain version, then waits on no load.
template <int R>
__device__ __forceinline__ void rec_adjoint(float (&rec)[R], const float* gu,
                                            const float* wt, int N,
                                            const int (&j)[R],
                                            const bool (&in)[R]) {
  constexpr int U = adjoint_unroll<R>();
#pragma unroll(R <= 8 ? R : 1)
  for (int r = 0; r < R; ++r) rec[r] = 0.f;
  int k = 0;
  for (; k + U <= N; k += U) {
    float x[U], wv[U][R];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      x[u] = gu[k + u];
      const float* wk = wt + (int64_t)(k + u) * N;
#pragma unroll(R <= 8 ? R : 1)
      for (int r = 0; r < R; ++r) wv[u][r] = in[r] ? wk[j[r]] : 0.f;
    }
#pragma unroll
    for (int u = 0; u < U; ++u)
#pragma unroll(R <= 8 ? R : 1)
      for (int r = 0; r < R; ++r)
        rec[r] = __fadd_rn(rec[r], __fmul_rn(x[u], wv[u][r]));
  }
  for (; k < N; ++k) {
    const float x = gu[k];
    const float* wk = wt + (int64_t)k * N;
#pragma unroll(R <= 8 ? R : 1)
    for (int r = 0; r < R; ++r)
      rec[r] = __fadd_rn(rec[r], __fmul_rn(x, in[r] ? wk[j[r]] : 0.f));
  }
}

// Group g of pass 1, steps t0 .. t0 + G - 1 (those inside T): the current
// and the saved spike of the thread's R neurons.
template <int G, int R>
__device__ __forceinline__ void load_forward(float (&c)[G][R],
                                             float (&s)[G][R],
                                             const BwdArgs& p, int t0,
                                             int64_t row, const int (&j)[R],
                                             const bool (&in)[R]) {
  const int64_t stride_t = (int64_t)p.B * p.N;
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll(R <= 8 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int t = t0 + i;
      const bool ld = in[r] && t < p.T;
      const int64_t at = t * stride_t + row + j[r];
      c[i][r] = ld ? p.cur[at] : 0.f;
      s[i][r] = ld ? p.sp[at] : 0.f;
    }
}

// Group g of pass 2, steps t0, t0 - 1, .. t0 - G + 1 (those at or above
// 0): u, a_{t-1} (ALIF), the spike and its cotangent.
template <bool ADAPT, int G, int R>
__device__ __forceinline__ void load_reverse(
    float (&u)[G][R], float (&ap)[G][R], float (&s)[G][R], float (&g)[G][R],
    const BwdArgs& p, int t0, int64_t row, const int (&j)[R],
    const bool (&in)[R]) {
  const int64_t stride_t = (int64_t)p.B * p.N;
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll(R <= 8 ? R : 1)
    for (int r = 0; r < R; ++r) {
      const int t = t0 - i;
      const bool ld = in[r] && t >= 0;
      const int64_t at = t * stride_t + row + j[r];
      u[i][r] = ld ? p.ubuf[at] : 0.f;
      ap[i][r] = (ADAPT && ld) ? p.abuf[at] : 0.f;
      s[i][r] = ld ? p.sp[at] : 0.f;
      g[i][r] = ld ? p.gs[at] : 0.f;
    }
}

template <int G, int R>
__device__ __forceinline__ void take(float (&dst)[G][R],
                                     const float (&src)[G][R]) {
#pragma unroll
  for (int i = 0; i < G; ++i)
#pragma unroll(R <= 8 ? R : 1)
    for (int r = 0; r < R; ++r) dst[i][r] = src[i][r];
}

// Pass 1's step for one neuron: u = ((tau v) + I) + rec into the scratch
// (and a_{t-1} for ALIF), then the reset and adaptation along s.
template <bool ADAPT>
__device__ __forceinline__ void forward_step(const BwdArgs& p, int64_t at,
                                             float tn, float rn, float c,
                                             float s, float rec, float& v,
                                             float& a) {
  const float u = __fadd_rn(__fadd_rn(__fmul_rn(tn, v), c), rec);
  p.ubuf[at] = u;
  if (ADAPT) p.abuf[at] = a;
  v = __fmul_rn(u, __fsub_rn(1.f, s));
  if (ADAPT) a = __fadd_rn(__fmul_rn(rn, a), s);
}

// Pass 2's step for one neuron at t: Gu_{t+1} v_t into the g_tau partial
// (t < T - 1), the adjoint, g_current. Returns Gu_t.
template <bool ADAPT>
__device__ __forceinline__ float reverse_step(
    const BwdArgs& p, int64_t at, bool later, float u, float ap, float s,
    float g, float rec, float tn, float rn, const Surrogate& g_of,
    float& gv, float& ga, float& acc, float& accr, float gnext) {
  if (later)                          // Gu_{t+1} v_t
    acc = __fadd_rn(acc, __fmul_rn(gnext, __fmul_rn(u, __fsub_rn(1.f, s))));
  const float gu = neuron_adjoint<ADAPT, true>(
      u, threshold<ADAPT>(p.v_th, p.beta, ap), ap, s, g, rec, tn, rn, p.beta,
      g_of, gv, ga, accr);
  p.gc[at] = gu;
  return gu;
}

// The outputs of a neuron after t = 0; gs0 where asked for is written by
// the caller.
template <bool ADAPT>
__device__ __forceinline__ void write_lane(const BwdArgs& p, int64_t at,
                                           float acc, float accr, float gnext,
                                           float gv, float ga) {
  if (p.gtau) p.gtau[at] = __fadd_rn(acc, __fmul_rn(gnext, p.v0[at]));
  if (ADAPT && p.grho) p.grho[at] = accr;
  if (p.gv0) p.gv0[at] = gv;
  if (ADAPT && p.ga0) p.ga0[at] = ga;
}

// ---------------------------------------------------------------------------
// The warp route
// ---------------------------------------------------------------------------

// Steps a chunk: the unit the helpers stage ahead of the chain threads.
template <int KP>
__host__ __device__ constexpr int chunk_steps() {
  return KP <= 64 ? 32 : 16;
}

// Dynamic shared memory of the warp route (floats): the two Gu buffers, a
// chunk's spike words, the staged chunks (two buffers of five planes of
// TC x KP), the chain's outputs (two planes of TC x KP), W.
template <int KP>
__host__ __device__ constexpr int row_smem_floats(int N) {
  return 2 * KP + chunk_steps<KP>() * (KP / 32) +
         12 * chunk_steps<KP>() * KP + N * N;
}

// dst[0 .. n) = src[0 .. n) by the block, 16 bytes a thread where src is
// 16-byte aligned, each thread's loads of a round issued before its
// stores: a round waits on one load's latency, not one a word.
__device__ __forceinline__ void stage_w(float* dst, const float* src, int n) {
  constexpr int U = 8;
  const int step = blockDim.x;
  if ((reinterpret_cast<uintptr_t>(src) & 15) == 0) {
    const float4* s4 = reinterpret_cast<const float4*>(src);
    float4* d4 = reinterpret_cast<float4*>(dst);
    const int n4 = n / 4;
    for (int e0 = threadIdx.x; e0 < n4; e0 += U * step) {
      float4 x[U];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (e0 + u * step < n4) x[u] = s4[e0 + u * step];
#pragma unroll
      for (int u = 0; u < U; ++u)
        if (e0 + u * step < n4) d4[e0 + u * step] = x[u];
    }
    for (int e = 4 * n4 + threadIdx.x; e < n; e += step) dst[e] = src[e];
    return;
  }
  for (int e0 = threadIdx.x; e0 < n; e0 += U * step) {
    float x[U];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e0 + u * step < n) x[u] = src[e0 + u * step];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (e0 + u * step < n) dst[e0 + u * step] = x[u];
  }
}

// The chain threads' barrier (named barrier 1; __syncwarp for one warp).
template <int NW>
__device__ __forceinline__ void chain_sync() {
  if constexpr (NW == 1) {
    __syncwarp();
  } else {
    asm volatile("bar.sync 1, %0;" ::"n"(32 * NW) : "memory");
  }
}

// rec = sum_k gu[k] W[j, k] from +0 over ascending k: W's row j from
// registers (wr, zero past N; gu is zero there too, and +0 terms leave a
// sum that starts at +0 as it is), or from W^T in shared memory (wt, row
// stride N; j < N) for the rows too wide for registers. gu is the row's
// Gu buffer, read 16 bytes at a time, the same address in every thread.
template <int KP, bool REGW>
__device__ __forceinline__ float rec_row(const float* gu,
                                         const float (&wr)[REGW ? KP : 1],
                                         const float* wt, int N, int j) {
  const float4* g4 = reinterpret_cast<const float4*>(gu);
  float rec = 0.f;
  if constexpr (REGW) {
#pragma unroll
    for (int k = 0; k < KP / 4; ++k) {
      const float4 x = g4[k];
      rec = __fadd_rn(rec, __fmul_rn(x.x, wr[4 * k]));
      rec = __fadd_rn(rec, __fmul_rn(x.y, wr[4 * k + 1]));
      rec = __fadd_rn(rec, __fmul_rn(x.z, wr[4 * k + 2]));
      rec = __fadd_rn(rec, __fmul_rn(x.w, wr[4 * k + 3]));
    }
  } else {
    int k = 0;
#pragma unroll 4
    for (; k + 4 <= N; k += 4) {
      const float4 x = g4[k / 4];
      const float* w = wt + k * N + j;
      rec = __fadd_rn(rec, __fmul_rn(x.x, w[0]));
      rec = __fadd_rn(rec, __fmul_rn(x.y, w[N]));
      rec = __fadd_rn(rec, __fmul_rn(x.z, w[2 * N]));
      rec = __fadd_rn(rec, __fmul_rn(x.w, w[3 * N]));
    }
    for (; k < N; ++k) rec = __fadd_rn(rec, __fmul_rn(gu[k], wt[k * N + j]));
  }
  return rec;
}

// The planes of a staged chunk (each TC x KP, [step in chunk][neuron]):
// pass 1 stages the current, the recurrent sum and the spike; pass 2 u,
// g(u - th), the spike, its cotangent and a_{t-1}.
enum { P_CUR = 0, P_REC = 1, P_SP = 2 };
enum { P_U = 0, P_G = 1, P_GS = 3, P_AP = 4 };

// Pass 1, helpers: chunk k's steps t0 .. t0 + TC - 1 staged for the
// chain: the current, the spike, and the spike words of the step before
// each (s_{t-1}, s0 at t = 0; word w holds neurons 32 w .. 32 w + 31),
// for `sum_events`. A warp owns (step, 32-neuron slice) items.
template <int KP, int H>
__device__ __forceinline__ void stage_forward(const BwdArgs& p, int k,
                                              float* st, uint32_t* words,
                                              int64_t row, int hw, int lane) {
  constexpr int NW = KP / 32, TC = chunk_steps<KP>(), PL = TC * KP;
  constexpr int IPW = (TC * NW + H - 1) / H;   // items a helper warp
  const int N = p.N, T = p.T, t0 = k * TC;
  const int64_t stride_t = (int64_t)p.B * N;
  float sprev[IPW], c[IPW], sv[IPW];
#pragma unroll
  for (int q = 0; q < IPW; ++q) {     // every load first
    const int item = hw + q * H, t = t0 + item / NW;
    const int jj = (item % NW) * 32 + lane;
    const bool ok = item < TC * NW && t < T && jj < N;
    sprev[q] = !ok ? 0.f
                   : (t == 0 ? p.s0[row + jj]
                             : p.sp[(t - 1) * stride_t + row + jj]);
    c[q] = ok ? p.cur[t * stride_t + row + jj] : 0.f;
    sv[q] = ok ? p.sp[t * stride_t + row + jj] : 0.f;
  }
#pragma unroll
  for (int q = 0; q < IPW; ++q) {
    const int item = hw + q * H;
    const unsigned m = __ballot_sync(ALL, sprev[q] != 0.f);
    if (item < TC * NW) {
      const int at = (item / NW) * KP + (item % NW) * 32 + lane;
      if (lane == 0) words[item] = m;
      st[P_CUR * PL + at] = c[q];
      st[P_SP * PL + at] = sv[q];
    }
  }
}

// Pass 1, every warp: chunk k's recurrent sums, rec_t = the sum of W's
// rows of the set bits of step t - 1's spike words over ascending
// neurons, from +0 (W in shared memory), into the staged chunk. A warp
// owns (step, 32-neuron slice) items, so a step's words are the same in
// all its lanes.
template <int KP>
__device__ __forceinline__ void sum_events(const uint32_t* words, float* st,
                                           const float* ws, int N, int wid,
                                           int lane) {
  constexpr int NW = KP / 32, TC = chunk_steps<KP>(), PL = TC * KP;
  constexpr int NWARP = ROW_THREADS / 32;
  for (int item = wid; item < TC * NW; item += NWARP) {
    const int tl = item / NW, jj = (item % NW) * 32 + lane;
    const int jw = jj < N ? jj : 0;   // a valid column of W
    float rec = 0.f;
#pragma unroll
    for (int c = 0; c < (NW + 1) / 2; ++c) {
      uint64_t bits = words[tl * NW + 2 * c];
      if (2 * c + 1 < NW)
        bits |= (uint64_t)words[tl * NW + 2 * c + 1] << 32;
      for (; bits; bits &= bits - 1)
        rec = __fadd_rn(rec, ws[(64 * c + __ffsll(bits) - 1) * N + jw]);
    }
    st[P_REC * PL + tl * KP + jj] = rec;
  }
}

// Pass 1, every thread: chunk k's u (and a_{t-1}) from the chain, with
// g(u - th), to the scratch planes and g_current's plane (which pass 2
// reads before it overwrites it with Gu).
template <bool ADAPT, int KP>
__device__ __forceinline__ void flush_forward(const BwdArgs& p, int k,
                                              const float* o, int64_t row,
                                              const Surrogate& g_of) {
  constexpr int TC = chunk_steps<KP>(), PL = TC * KP;
  constexpr int EPT = (PL + ROW_THREADS - 1) / ROW_THREADS;  // a thread's
  const int N = p.N, T = p.T, t0 = k * TC;
  const int64_t stride_t = (int64_t)p.B * N;
  float u[EPT], ap[EPT], x[EPT], g[EPT];
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int e = threadIdx.x + q * ROW_THREADS;
    u[q] = e < PL ? o[e] : 0.f;
    ap[q] = (ADAPT && e < PL) ? o[PL + e] : 0.f;
    x[q] = __fsub_rn(u[q], threshold<ADAPT>(p.v_th, p.beta, ap[q]));
  }
  surrogate_group<EPT>(g, x, g_of);
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int e = threadIdx.x + q * ROW_THREADS;
    const int t = t0 + e / KP, jj = e % KP;
    if (e < PL && t < T && jj < N) {
      const int64_t at = t * stride_t + row + jj;
      p.ubuf[at] = u[q];
      if (ADAPT) p.abuf[at] = ap[q];
      p.gc[at] = g[q];
    }
  }
}

// Pass 2, helpers: chunk k's steps T - 1 - k TC downwards staged for the
// chain: u, g, the spike, its cotangent and a_{t-1}.
template <bool ADAPT, int KP, int H>
__device__ __forceinline__ void stage_reverse(const BwdArgs& p, int k,
                                              float* st, int64_t row,
                                              int hid) {
  constexpr int TC = chunk_steps<KP>(), PL = TC * KP;
  constexpr int EPT = (PL + 32 * H - 1) / (32 * H);
  const int N = p.N, thi = p.T - 1 - k * TC;
  const int64_t stride_t = (int64_t)p.B * N;
  float u[EPT], g[EPT], s[EPT], gs[EPT], ap[EPT];
#pragma unroll
  for (int q = 0; q < EPT; ++q) {     // every load first
    const int e = hid + q * 32 * H, t = thi - e / KP, jj = e % KP;
    const bool ok = e < PL && t >= 0 && jj < N;
    const int64_t at = t * stride_t + row + jj;
    u[q] = ok ? p.ubuf[at] : 0.f;
    g[q] = ok ? p.gc[at] : 0.f;
    s[q] = ok ? p.sp[at] : 0.f;
    gs[q] = ok ? p.gs[at] : 0.f;
    ap[q] = (ADAPT && ok) ? p.abuf[at] : 0.f;
  }
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int e = hid + q * 32 * H;
    if (e < PL) {
      st[P_U * PL + e] = u[q];
      st[P_G * PL + e] = g[q];
      st[P_SP * PL + e] = s[q];
      st[P_GS * PL + e] = gs[q];
      if (ADAPT) st[P_AP * PL + e] = ap[q];
    }
  }
}

// Pass 2, helpers: chunk k's Gu from the chain to g_current.
template <int KP, int H>
__device__ __forceinline__ void flush_reverse(const BwdArgs& p, int k,
                                              const float* o, int64_t row,
                                              int hid) {
  constexpr int TC = chunk_steps<KP>(), PL = TC * KP;
  constexpr int EPT = (PL + 32 * H - 1) / (32 * H);
  const int N = p.N, thi = p.T - 1 - k * TC;
  const int64_t stride_t = (int64_t)p.B * N;
#pragma unroll
  for (int q = 0; q < EPT; ++q) {
    const int e = hid + q * 32 * H, t = thi - e / KP, jj = e % KP;
    if (e < PL && t >= 0 && jj < N) p.gc[t * stride_t + row + jj] = o[e];
  }
}

// Block b owns batch row b. Threads 0 .. KP - 1 (NW = KP / 32 warps) are
// the chain: thread j owns neuron j (j < N live). The other H warps are
// helpers. Both passes walk chunks of TC steps through shared memory, the
// chain a chunk behind the staging (two phases a chunk in pass 1, one in
// pass 2; see the note at the top).
template <bool ADAPT, int KP>
__global__ void __launch_bounds__(ROW_THREADS, 1) rec_bwd_row_kernel(
    const BwdArgs p) {
  constexpr int NW = KP / 32, H = ROW_THREADS / 32 - NW;
  constexpr int TC = chunk_steps<KP>(), PL = TC * KP;
  constexpr bool REGW = KP <= REGW_MAX_KP;
  extern __shared__ __align__(16) float rsm[];
  const int N = p.N, T = p.T, K = (T + TC - 1) / TC;
  const int64_t row = (int64_t)blockIdx.x * N;
  float* gus = rsm;                                     // [2][KP]
  uint32_t* words = reinterpret_cast<uint32_t*>(rsm + 2 * KP);  // [TC][NW]
  float* stage = rsm + 2 * KP + TC * NW;                // [2][5][TC][KP]
  float* outp = stage + 10 * PL;                        // [2][TC][KP]
  float* ws = outp + 2 * PL;                            // W (N x N)
  const int tid = threadIdx.x;
  const bool chain = tid < KP;        // uniform across a warp
  const int j = tid, hid = tid - KP;  // neuron (chain), index (helpers)
  const bool in = chain && j < N;
  PASS_STAMP(0);

  for (int e = tid; e < 2 * KP; e += blockDim.x) gus[e] = 0.f;
  stage_w(ws, p.w, N * N);
  float wr[REGW ? KP : 1];            // W[j, k], issued now, used in pass 2
  if constexpr (REGW) {
#pragma unroll
    for (int k = 0; k < KP; ++k)
      wr[k] = (in && k < N) ? p.wt[(int64_t)k * N + j] : 0.f;
  }
  const float tn = in ? p.tau[j] : 0.f;
  const float rn = (ADAPT && in) ? p.rho[j] : 0.f;
  const Surrogate g_of = make_surrogate(p.sur, p.alpha);
  __syncthreads();                    // W, the zeroed Gu buffers
  PASS_STAMP(1);

  // 1. forward along the saved spikes, two phases a chunk: (a) the chain
  //    runs chunk k - 1's u_t = ((tau v) + I_t) + rec_t, v = u (1 - s), a
  //    = rho a + s while the helpers load chunk k and ballot its spike
  //    words; (b) every warp sums chunk k's recurrent terms and writes
  //    chunk k - 1's u, a_{t-1} and g(u - th) out
  {
    float v = in ? p.v0[row + j] : 0.f;
    float a = (ADAPT && in) ? p.a0[row + j] : 0.f;
    for (int it = 0; it <= K; ++it) {
      if (chain) {
        if (it >= 1) {                // chunk it - 1
          const float* st = stage + ((it - 1) & 1) * 5 * PL;
#pragma unroll
          for (int i = 0; i < TC; ++i) {
            const int at = i * KP + j;
            const float u = __fadd_rn(
                __fadd_rn(__fmul_rn(tn, v), st[P_CUR * PL + at]),
                st[P_REC * PL + at]);
            const float sv = st[P_SP * PL + at];
            outp[at] = u;
            if (ADAPT) outp[PL + at] = a;
            v = __fmul_rn(u, __fsub_rn(1.f, sv));
            if (ADAPT) a = __fadd_rn(__fmul_rn(rn, a), sv);
          }
        }
      } else if (it < K) {
        stage_forward<KP, H>(p, it, stage + (it & 1) * 5 * PL, words, row,
                             hid / 32, hid % 32);
      }
      __syncthreads();
      if (it < K)
        sum_events<KP>(words, stage + (it & 1) * 5 * PL, ws, N, tid / 32,
                       tid % 32);
      if (it >= 1) flush_forward<ADAPT, KP>(p, it - 1, outp, row, g_of);
      __syncthreads();
    }
  }
  PASS_STAMP(2);
  if constexpr (!REGW) {              // W^T replaces W, read in pass 2
    stage_w(ws, p.wt, N * N);
    __syncthreads();
  }

  // 2. the reverse chain: a step's serial part is the N-term adjoint and
  //    neuron_adjoint_g's four rounded operations on it; every input is
  //    in shared memory, staged a chunk ahead
  const int jw = in ? j : 0;          // a valid column of W^T
  float gv = in ? p.gvT[row + j] : 0.f;
  float ga = (ADAPT && in) ? p.gaT[row + j] : 0.f;
  float acc = 0.f, accr = 0.f, gnext = 0.f;
  for (int it = 0; it <= K + 1; ++it) {
    if (chain) {
      if (it >= 1 && it <= K) {       // chunk it - 1: steps thi downwards
        const int thi = T - 1 - (it - 1) * TC;
        const float* st = stage + ((it - 1) & 1) * 5 * PL;
        float* o = outp + ((it - 1) & 1) * PL;
        for (int i0 = 0; i0 < TC && thi - i0 >= 0; i0 += G2) {
#pragma unroll
          for (int ii = 0; ii < G2; ++ii) {
            const int i = i0 + ii, t = thi - i;
            if (t < 0) break;
            const int at = i * KP + j;
            const float u = st[P_U * PL + at], g = st[P_G * PL + at];
            const float s = st[P_SP * PL + at], gs = st[P_GS * PL + at];
            const float ap = ADAPT ? st[P_AP * PL + at] : 0.f;
            const float sum =
                rec_row<KP, REGW>(gus + ((t + 1) & 1) * KP, wr, ws, N, jw);
            const bool last = t == T - 1;   // no Gu_{t+1}: rec = +0
            const float rec = last ? 0.f : sum;
            // Gu_{t+1} v_t into the g_tau partial
            const float tv = __fadd_rn(
                acc, __fmul_rn(gnext, __fmul_rn(u, __fsub_rn(1.f, s))));
            acc = last ? acc : tv;
            gnext = neuron_adjoint_g<ADAPT, true>(u, g, ap, s, gs, rec, tn,
                                                  rn, p.beta, gv, ga, accr);
            o[at] = gnext;
            if (in) gus[(t & 1) * KP + j] = gnext;
            chain_sync<NW>();         // the row's Gu_t, for step t - 1
          }
        }
      }
    } else {
      if (it < K)
        stage_reverse<ADAPT, KP, H>(p, it, stage + (it & 1) * 5 * PL, row,
                                    hid);
      if (it >= 2)
        flush_reverse<KP, H>(p, it - 2, outp + (it & 1) * PL, row, hid);
    }
    __syncthreads();
  }
  if (in) write_lane<ADAPT>(p, row + j, acc, accr, gnext, gv, ga);
  if (p.gs0 && chain) {               // Gu_0 W^T: the step t = -1's rec
    const float rec = rec_row<KP, REGW>(gus, wr, ws, N, jw);  // buffer 0
    if (in) p.gs0[row + j] = rec;
  }
  PASS_STAMP(3);
}

// The instantiation of KP = 32 NW chain threads that
// `kernels/common.py::rec_plan(backward=True)` chose (the least that covers
// the row); a block a row. Any other KP is refused.
template <bool ADAPT, int KP>
int launch_bwd_rows(const BwdArgs& p, int unit, cudaStream_t stream) {
  if constexpr (KP < WARP_NB) {
    if (KP < unit) return launch_bwd_rows<ADAPT, KP + 32>(p, unit, stream);
  }
  if (KP != unit || KP < p.N || KP - 32 >= p.N)
    return (int)cudaErrorInvalidValue;  // not the plan's instantiation
  const int smem = (int)sizeof(float) * row_smem_floats<KP>(p.N);
  auto kern = rec_bwd_row_kernel<ADAPT, KP>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<p.B, ROW_THREADS, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The block route
// ---------------------------------------------------------------------------

// Thread x owns neurons x + r * blockDim.x, r < NPT. Warp w's 32 neurons
// of round r fill mask word r * (blockDim.x / 32) + w. Shared memory: the
// two masks, the two Gu buffers of N floats, then (SMEM) W, later W^T.
template <bool ADAPT, bool SMEM, int NPT>
__global__ void __launch_bounds__(BWD_THREADS) rec_bwd_block_kernel(
    const BwdArgs p) {
  extern __shared__ uint32_t bsm[];
  constexpr int G = group_steps<NPT>();
  const int N = p.N, T = p.T;
  const int words = (N + 31) / 32;
  const int wpb = blockDim.x / 32;
  uint32_t* mask = bsm;                                   // [2][words]
  float* gus = reinterpret_cast<float*>(bsm + 2 * words);  // [2][N]
  float* ws = gus + 2 * N;
  const float* W = p.w;
  const float* WT = p.wt;
  if (SMEM) {
    for (int e = threadIdx.x; e < N * N; e += blockDim.x) ws[e] = p.w[e];
    W = ws;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * N;
  const int64_t stride_t = (int64_t)p.B * N;

  int j[NPT];
  bool in[NPT];
  float tn[NPT], rn[NPT], v[NPT], a[NPT];
#pragma unroll(NPT <= 8 ? NPT : 1)
  for (int r = 0; r < NPT; ++r) {
    j[r] = r * (int)blockDim.x + (int)threadIdx.x;
    in[r] = j[r] < N;
    tn[r] = in[r] ? p.tau[j[r]] : 0.f;
    rn[r] = (ADAPT && in[r]) ? p.rho[j[r]] : 0.f;
    v[r] = in[r] ? p.v0[row + j[r]] : 0.f;
    a[r] = (ADAPT && in[r]) ? p.a0[row + j[r]] : 0.f;
    const unsigned bits0 =
        __ballot_sync(ALL, in[r] && p.s0[row + j[r]] != 0.f);
    if (lane == 0 && (r * wpb + warp) * 32 < N) mask[r * wpb + warp] = bits0;
  }
  __syncthreads();

  // 1. u (and a_{t-1}) forward, along the saved spikes
  {
    float c[G][NPT], s[G][NPT];
    load_forward<G, NPT>(c, s, p, 0, row, j, in);
    int buf = 0;
    for (int t0 = 0; t0 < T; t0 += G) {
      float cn[G][NPT], sn[G][NPT];
      load_forward<G, NPT>(cn, sn, p, t0 + G, row, j, in);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int t = t0 + i;
        if (t >= T) break;
        float rec[NPT];
#pragma unroll(NPT <= 8 ? NPT : 1)
        for (int r = 0; r < NPT; ++r) rec[r] = 0.f;
        const uint32_t* m = mask + buf * words;
        for (int wi = 0; wi < words; ++wi)
          for (uint32_t bits = m[wi]; bits; bits &= bits - 1) {
            const float* wrow = W + (int64_t)(wi * 32 + __ffs(bits) - 1) * N;
#pragma unroll(NPT <= 8 ? NPT : 1)
            for (int r = 0; r < NPT; ++r)
              if (in[r]) rec[r] = __fadd_rn(rec[r], wrow[j[r]]);
          }
#pragma unroll(NPT <= 8 ? NPT : 1)
        for (int r = 0; r < NPT; ++r) {
          if (in[r])
            forward_step<ADAPT>(p, t * stride_t + row + j[r], tn[r], rn[r],
                                c[i][r], s[i][r], rec[r], v[r], a[r]);
          const unsigned bits = __ballot_sync(ALL, in[r] && s[i][r] != 0.f);
          if (lane == 0 && (r * wpb + warp) * 32 < N)
            mask[(buf ^ 1) * words + r * wpb + warp] = bits;
        }
        __syncthreads();
        buf ^= 1;
      }
      take<G, NPT>(c, cn);
      take<G, NPT>(s, sn);
    }
  }
  if (SMEM) {                         // every thread is past pass 1's reads
    for (int e = threadIdx.x; e < N * N; e += blockDim.x) ws[e] = p.wt[e];
    WT = ws;
    __syncthreads();
  }

  // 2. the reverse chain
  const Surrogate g_of = make_surrogate(p.sur, p.alpha);
  float gv[NPT], ga[NPT], acc[NPT], accr[NPT], gnext[NPT];
#pragma unroll(NPT <= 8 ? NPT : 1)
  for (int r = 0; r < NPT; ++r) {
    gv[r] = in[r] ? p.gvT[row + j[r]] : 0.f;
    ga[r] = (ADAPT && in[r]) ? p.gaT[row + j[r]] : 0.f;
    acc[r] = accr[r] = gnext[r] = 0.f;
  }
  float u[G][NPT], ap[G][NPT], s[G][NPT], g[G][NPT];
  load_reverse<ADAPT, G, NPT>(u, ap, s, g, p, T - 1, row, j, in);
  for (int t0 = T - 1; t0 >= 0; t0 -= G) {
    float un[G][NPT], apn[G][NPT], sn[G][NPT], gn[G][NPT];
    load_reverse<ADAPT, G, NPT>(un, apn, sn, gn, p, t0 - G, row, j, in);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int t = t0 - i;
      if (t < 0) break;
      float rec[NPT];
      if (t + 1 < T) {                // Gu_{t+1} W^T, ascending k
        rec_adjoint<NPT>(rec, gus + ((t + 1) & 1) * N, WT, N, j, in);
      } else {
#pragma unroll(NPT <= 8 ? NPT : 1)
        for (int r = 0; r < NPT; ++r) rec[r] = 0.f;
      }
      float* gw = gus + (t & 1) * N;
#pragma unroll(NPT <= 8 ? NPT : 1)
      for (int r = 0; r < NPT; ++r)
        if (in[r]) {
          gnext[r] = reverse_step<ADAPT>(
              p, t * stride_t + row + j[r], t + 1 < T, u[i][r], ap[i][r],
              s[i][r], g[i][r], rec[r], tn[r], rn[r], g_of, gv[r], ga[r],
              acc[r], accr[r], gnext[r]);
          gw[j[r]] = gnext[r];
        }
      __syncthreads();                // the row's Gu_t, for step t - 1
    }
    take<G, NPT>(u, un);
    take<G, NPT>(ap, apn);
    take<G, NPT>(s, sn);
    take<G, NPT>(g, gn);
  }
#pragma unroll(NPT <= 8 ? NPT : 1)
  for (int r = 0; r < NPT; ++r)
    if (in[r])
      write_lane<ADAPT>(p, row + j[r], acc[r], accr[r], gnext[r], gv[r],
                        ga[r]);
  if (p.gs0) {                        // Gu_0 W^T: the step t = -1's rec
    float rec[NPT];
    rec_adjoint<NPT>(rec, gus, WT, N, j, in);  // buffer 0: Gu_0
#pragma unroll(NPT <= 8 ? NPT : 1)
    for (int r = 0; r < NPT; ++r)
      if (in[r]) p.gs0[row + j[r]] = rec[r];
  }
}

// Dynamic shared memory of a block-route block: the two spike masks and
// the two Gu buffers, plus W_rec where the plan keeps it there (`smem_w`:
// all fit under the device's opt-in maximum, as the plan reads it).
inline int bwd_block_smem(int N, bool smem_w) {
  const size_t base = 2 * sizeof(uint32_t) * ((N + 31) / 32) +
                      2 * sizeof(float) * (size_t)N;
  return (int)(smem_w ? base + sizeof(float) * (size_t)N * N : base);
}

template <typename K>
int launch_bwd_block(K kern, const BwdArgs& p, int threads, int smem,
                     cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<p.B, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The instantiation of NPT neurons a thread that the plan chose (the least
// whose BWD_THREADS threads cover the row); any other NPT is refused.
template <bool ADAPT, int NPT>
int launch_bwd_npt(const BwdArgs& p, int unit, int smem,
                   cudaStream_t stream) {
  if constexpr (NPT < 256) {
    if (NPT < unit)
      return launch_bwd_npt<ADAPT, 2 * NPT>(p, unit, smem, stream);
  }
  if (NPT != unit || (int64_t)NPT * BWD_THREADS < p.N ||
      (NPT > 1 && (int64_t)NPT * BWD_THREADS / 2 >= p.N))
    return (int)cudaErrorInvalidValue;
  const int per = (p.N + NPT - 1) / NPT;
  return launch_bwd_block(rec_bwd_block_kernel<ADAPT, false, NPT>, p,
                          (per + 31) / 32 * 32, smem, stream);
}

// Launch the backward as `kernels/common.py::rec_plan(backward=True)`
// planned it: the warp route (`warp` set) with `unit` = KP chain threads,
// or B blocks of `unit` neurons a thread, W_rec in shared memory where
// `smem_w` is set (then one neuron a thread).
template <bool ADAPT>
int launch_rec_bwd(const BwdArgs& p, bool warp, int unit, bool smem_w,
                   cudaStream_t stream) {
  if (p.T < 1 || p.B < 1 || p.N < 1 || p.sur < 0 || p.sur > 3 || unit < 1)
    return (int)cudaErrorInvalidValue;
  if (warp) return launch_bwd_rows<ADAPT, 32>(p, unit, stream);
  const int smem = bwd_block_smem(p.N, smem_w);
  if (smem_w) {
    if (unit != 1 || p.N > BWD_THREADS) return (int)cudaErrorInvalidValue;
    return launch_bwd_block(rec_bwd_block_kernel<ADAPT, true, 1>, p,
                            (p.N + 31) / 32 * 32, smem, stream);
  }
  return launch_bwd_npt<ADAPT, 1>(p, unit, smem, stream);
}

}  // namespace

extern "C" {

// The backward of lifrec_f32 (see above); wt = w transposed (contiguous),
// ubuf a (T, B, N) scratch; gtau (the per-lane partials), gv0 and gs0 may
// be null. surrogate: 0 arctan, 1 rectangle, 2 sigmoid, 3 triangle; warp,
// unit, smem_w: the launch `kernels/common.py::rec_plan(backward=True)`
// planned (its route, KP or neurons a thread, W_rec in shared memory).
int lifrec_bwd_f32(const float* cur, const float* w, const float* wt,
                   const float* tau, const float* v0, const float* s0,
                   const float* spikes, const float* gs, const float* gvT,
                   float* ubuf, float* gc, float* gtau, float* gv0,
                   float* gs0, int T, int B, int N, float v_th,
                   int surrogate, float alpha, int warp, int unit,
                   int smem_w, void* stream) {
  const BwdArgs p{cur,     w,       wt,      tau,     nullptr, v0,
                  nullptr, s0,      spikes,  gs,      gvT,     nullptr,
                  ubuf,    nullptr, gc,      gtau,    nullptr, gv0,
                  nullptr, gs0,     T,       B,       N,       v_th,
                  0.f,     alpha,   surrogate};
  return launch_rec_bwd<false>(p, warp != 0, unit, smem_w != 0,
                               (cudaStream_t)stream);
}

// The backward of alifrec_f32: as lifrec_bwd_f32, with rho, a0 and g_aT
// in, abuf a second (T, B, N) scratch (a_{t-1}), and the g_rho partials
// and g_a0 out (each may be null).
int alifrec_bwd_f32(const float* cur, const float* w, const float* wt,
                    const float* tau, const float* rho, const float* v0,
                    const float* a0, const float* s0, const float* spikes,
                    const float* gs, const float* gvT, const float* gaT,
                    float* ubuf, float* abuf, float* gc, float* gtau,
                    float* grho, float* gv0, float* ga0, float* gs0, int T,
                    int B, int N, float v_th, float beta, int surrogate,
                    float alpha, int warp, int unit, int smem_w,
                    void* stream) {
  const BwdArgs p{cur,  w,    wt,  tau, rho,  v0,   a0,   s0,   spikes,
                  gs,   gvT,  gaT, ubuf, abuf, gc,  gtau, grho, gv0,
                  ga0,  gs0,  T,   B,   N,    v_th, beta, alpha, surrogate};
  return launch_rec_bwd<true>(p, warp != 0, unit, smem_w != 0,
                              (cudaStream_t)stream);
}

}  // extern "C"
