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
//      step late, as in `lif_bwd_f32`) and, for ALIF, its g_rho partial
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
// rounded adds, to equal the plain version bit for bit. A window of T
// steps is T such chains back to back, plus pass 1's T event-driven
// steps; the bytes (the planes read and written once) are a few
// microseconds at 3.35 TB/s.
//
// Design: the forward's two routes, chosen by the wrapper with the same
// `kernels/common.py::rec_route(N)`.
// - The warp route, N <= 32 * REC_LANE_NEURONS (the ECG SRNN's 64). One
//   warp owns one batch row, lane l the neurons l, l + 32, ... (R of
//   them), with their state in registers; up to REC_ROWS rows a block
//   share one copy of W_rec in shared memory. Pass 1 keeps the previous
//   step's spikes as R ballot words in every lane and adds the rows of
//   their set bits. Pass 2 exchanges Gu through warp-private shared memory
//   (double-buffered, one __syncwarp a step), and every lane adds
//   Gu[k] W[j, k] over ascending k for its R neurons. Between the passes
//   the block overwrites W with W^T (the wrapper hands both): lane j then
//   reads W^T[k, j], 32 consecutive words at each k, where a row-major W
//   would put all 32 lanes of a row of N = 64 on one bank.
// - The block route, wider rows. One block owns one batch row, each thread
//   NPT neurons (j, j + blockDim, ...), as the forward's block route. Pass
//   1 keeps the spikes as a bit mask in shared memory (one ballot per 32
//   neurons, double-buffered: one __syncthreads a step); pass 2 exchanges
//   Gu through a double-buffered shared array, one __syncthreads a step.
//   W (then W^T) sits in shared memory when it fits beside the masks and
//   the Gu buffers (N <= 240 on an H100's 227 KB opt-in, one fewer than
//   the forward's 241: the Gu buffers), else both passes read W and W^T
//   through L2, coalesced across the threads at each step of the chain.
// A thread loads the inputs of a group of steps (the current and spike in
// pass 1; u, a_{t-1}, s and Gs in pass 2) into registers while the chain
// runs over the group before (8 values a plane a thread: 4 steps of 2
// neurons at the ECG's 64), and issues the adjoint's shared loads 8 terms
// ahead of their adds (`rec_adjoint`), so the add chain does not wait on
// a shared load's latency at every term.
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

namespace {

constexpr int BWD_THREADS = 1024;   // most threads a block may have
constexpr unsigned ALL = 0xffffffffu;
constexpr int LANE_NB = REC_LANE_NEURONS;   // most neurons a lane owns
constexpr int WARP_NB = 32 * LANE_NB;       // widest row of the warp route
constexpr int ROWS_NB = 4;                  // rows a block on the warp route
static_assert(LANE_NB > 0 && (LANE_NB & (LANE_NB - 1)) == 0,
              "REC_LANE_NEURONS is a power of two");
static_assert(4 * (WARP_NB * WARP_NB + ROWS_NB * 2 * WARP_NB) <= 227 * 1024,
              "W_rec and the Gu buffers of the widest rows fit");

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

// Warp w of block x owns batch row x * (blockDim.x / 32) + w; lane l owns
// neurons l + 32 r, r < R. Shared memory: W (N * N floats; W^T in pass
// 2), then each warp's two Gu buffers of WARP_NB floats.
template <bool ADAPT, int R>
__global__ void __launch_bounds__(32 * ROWS_NB) rec_bwd_warp_kernel(
    const BwdArgs p) {
  extern __shared__ __align__(16) float wsm[];
  constexpr int G = group_steps<R>();
  const int N = p.N, T = p.T, B = p.B;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.x * (blockDim.x / 32) + warp;
  const bool live = b < B;            // uniform across the warp
  const int64_t row = (int64_t)b * N;
  const int64_t stride_t = (int64_t)B * N;
  float* gus = wsm + N * N + warp * 2 * WARP_NB;

  for (int e = threadIdx.x; e < N * N; e += blockDim.x) wsm[e] = p.w[e];

  int j[R];
  bool in[R];
  float tn[R], rn[R], v[R], a[R];
  uint32_t mask[R];                   // the previous step's spikes, all lanes
#pragma unroll
  for (int r = 0; r < R; ++r) {
    j[r] = lane + 32 * r;
    in[r] = live && j[r] < N;
    tn[r] = in[r] ? p.tau[j[r]] : 0.f;
    rn[r] = (ADAPT && in[r]) ? p.rho[j[r]] : 0.f;
    v[r] = in[r] ? p.v0[row + j[r]] : 0.f;
    a[r] = (ADAPT && in[r]) ? p.a0[row + j[r]] : 0.f;
    mask[r] = __ballot_sync(ALL, in[r] && p.s0[row + j[r]] != 0.f);
  }
  __syncthreads();                    // W

  // 1. u (and a_{t-1}) forward, along the saved spikes
  if (live) {
    float c[G][R], s[G][R];
    load_forward<G, R>(c, s, p, 0, row, j, in);
    for (int t0 = 0; t0 < T; t0 += G) {
      float cn[G][R], sn[G][R];
      load_forward<G, R>(cn, sn, p, t0 + G, row, j, in);
#pragma unroll
      for (int i = 0; i < G; ++i) {
        const int t = t0 + i;
        if (t >= T) break;
        float rec[R];
#pragma unroll
        for (int r = 0; r < R; ++r) rec[r] = 0.f;
#pragma unroll
        for (int wi = 0; wi < R; ++wi)
          for (uint32_t bits = mask[wi]; bits; bits &= bits - 1) {
            const float* wrow = wsm + (wi * 32 + __ffs(bits) - 1) * N;
#pragma unroll
            for (int r = 0; r < R; ++r)
              if (in[r]) rec[r] = __fadd_rn(rec[r], wrow[j[r]]);
          }
#pragma unroll
        for (int r = 0; r < R; ++r) {
          if (in[r])
            forward_step<ADAPT>(p, t * stride_t + row + j[r], tn[r], rn[r],
                                c[i][r], s[i][r], rec[r], v[r], a[r]);
          mask[r] = __ballot_sync(ALL, in[r] && s[i][r] != 0.f);
        }
      }
      take<G, R>(c, cn);
      take<G, R>(s, sn);
    }
  }
  __syncthreads();                    // every warp is past pass 1
  for (int e = threadIdx.x; e < N * N; e += blockDim.x) wsm[e] = p.wt[e];
  __syncthreads();                    // W^T
  if (!live) return;

  // 2. the reverse chain
  const Surrogate g_of = make_surrogate(p.sur, p.alpha);
  float gv[R], ga[R], acc[R], accr[R], gnext[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    gv[r] = in[r] ? p.gvT[row + j[r]] : 0.f;
    ga[r] = (ADAPT && in[r]) ? p.gaT[row + j[r]] : 0.f;
    acc[r] = accr[r] = gnext[r] = 0.f;
  }
  float u[G][R], ap[G][R], s[G][R], g[G][R];
  load_reverse<ADAPT, G, R>(u, ap, s, g, p, T - 1, row, j, in);
  for (int t0 = T - 1; t0 >= 0; t0 -= G) {
    float un[G][R], apn[G][R], sn[G][R], gn[G][R];
    load_reverse<ADAPT, G, R>(un, apn, sn, gn, p, t0 - G, row, j, in);
#pragma unroll
    for (int i = 0; i < G; ++i) {
      const int t = t0 - i;
      if (t < 0) break;
      float rec[R];
      if (t + 1 < T) {                // Gu_{t+1} W^T, ascending k
        rec_adjoint<R>(rec, gus + ((t + 1) & 1) * WARP_NB, wsm, N, j, in);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) rec[r] = 0.f;
      }
      float* gw = gus + (t & 1) * WARP_NB;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (in[r]) {
          gnext[r] = reverse_step<ADAPT>(
              p, t * stride_t + row + j[r], t + 1 < T, u[i][r], ap[i][r],
              s[i][r], g[i][r], rec[r], tn[r], rn[r], g_of, gv[r], ga[r],
              acc[r], accr[r], gnext[r]);
          gw[j[r]] = gnext[r];
        }
      __syncwarp();                   // the row's Gu_t, for step t - 1
    }
    take<G, R>(u, un);
    take<G, R>(ap, apn);
    take<G, R>(s, sn);
    take<G, R>(g, gn);
  }
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (in[r])
      write_lane<ADAPT>(p, row + j[r], acc[r], accr[r], gnext[r], gv[r],
                        ga[r]);
  if (p.gs0) {                        // Gu_0 W^T: the step t = -1's rec
    float rec[R];
    rec_adjoint<R>(rec, gus, wsm, N, j, in);   // buffer 0: Gu_0
#pragma unroll
    for (int r = 0; r < R; ++r)
      if (in[r]) p.gs0[row + j[r]] = rec[r];
  }
}

// The instantiation whose R lanes-worth of neurons covers the row.
template <bool ADAPT, int R>
int launch_bwd_warp(const BwdArgs& p, cudaStream_t stream) {
  if constexpr (R < LANE_NB) {
    if (32 * R < p.N) return launch_bwd_warp<ADAPT, 2 * R>(p, stream);
  } else if (32 * R < p.N) {
    return (int)cudaErrorInvalidValue;  // wider rows take the block route
  }
  const int rows = p.B < ROWS_NB ? p.B : ROWS_NB;
  const int smem = (int)sizeof(float) * (p.N * p.N + rows * 2 * WARP_NB);
  auto kern = rec_bwd_warp_kernel<ADAPT, R>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<(p.B + rows - 1) / rows, 32 * rows, smem, stream>>>(p);
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
// the two Gu buffers, plus W_rec when all fit under the device's opt-in
// maximum (then `smem_w` is set). Returns a CUDA error code, 0 on success.
int plan_bwd_smem(int N, int* bytes, bool* smem_w) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t base = 2 * sizeof(uint32_t) * ((N + 31) / 32) +
                      2 * sizeof(float) * (size_t)N;
  const size_t with_w = base + sizeof(float) * (size_t)N * N;
  *smem_w = with_w <= (size_t)optin;
  *bytes = (int)(*smem_w ? with_w : base);
  return 0;
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

// The instantiation that owns NPT neurons a thread, or the next wider one.
template <bool ADAPT, int NPT>
int launch_bwd_npt(const BwdArgs& p, int smem, cudaStream_t stream) {
  if constexpr (NPT < 256) {
    if ((int64_t)NPT * BWD_THREADS < p.N)
      return launch_bwd_npt<ADAPT, 2 * NPT>(p, smem, stream);
  } else if ((int64_t)NPT * BWD_THREADS < p.N) {
    return (int)cudaErrorInvalidValue;  // W_rec alone would be 275 GB
  }
  const int per = (p.N + NPT - 1) / NPT;
  return launch_bwd_block(rec_bwd_block_kernel<ADAPT, false, NPT>, p,
                          (per + 31) / 32 * 32, smem, stream);
}

template <bool ADAPT>
int launch_rec_bwd(const BwdArgs& p, bool warp, cudaStream_t stream) {
  if (p.T < 1 || p.B < 1 || p.N < 1 || p.sur < 0 || p.sur > 3)
    return (int)cudaErrorInvalidValue;
  if (warp) return launch_bwd_warp<ADAPT, 1>(p, stream);
  int smem = 0;
  bool smem_w = false;
  const int err = plan_bwd_smem(p.N, &smem, &smem_w);
  if (err) return err;
  if (smem_w)  // N <= 240: one neuron a thread
    return launch_bwd_block(rec_bwd_block_kernel<ADAPT, true, 1>, p,
                            (p.N + 31) / 32 * 32, smem, stream);
  return launch_bwd_npt<ADAPT, 1>(p, smem, stream);
}

}  // namespace

extern "C" {

// On the block route: 1 when the backward holds W_rec (N, N) in shared
// memory, 0 when it reads W_rec and W_rec^T through L2, a negative CUDA
// error code when the device cannot be queried.
int rec_bwd_w_in_smem(int N) {
  int bytes = 0;
  bool smem_w = false;
  const int err = plan_bwd_smem(N, &bytes, &smem_w);
  return err ? -err : (int)smem_w;
}

// The backward of lifrec_f32 (see above); wt = w transposed (contiguous),
// ubuf a (T, B, N) scratch; gtau (the per-lane partials), gv0 and gs0 may
// be null. surrogate: 0 arctan, 1 rectangle, 2 sigmoid, 3 triangle; warp:
// the route (`kernels/common.py::rec_route`).
int lifrec_bwd_f32(const float* cur, const float* w, const float* wt,
                   const float* tau, const float* v0, const float* s0,
                   const float* spikes, const float* gs, const float* gvT,
                   float* ubuf, float* gc, float* gtau, float* gv0,
                   float* gs0, int T, int B, int N, float v_th,
                   int surrogate, float alpha, int warp, void* stream) {
  const BwdArgs p{cur,     w,       wt,      tau,     nullptr, v0,
                  nullptr, s0,      spikes,  gs,      gvT,     nullptr,
                  ubuf,    nullptr, gc,      gtau,    nullptr, gv0,
                  nullptr, gs0,     T,       B,       N,       v_th,
                  0.f,     alpha,   surrogate};
  return launch_rec_bwd<false>(p, warp != 0, (cudaStream_t)stream);
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
                    float alpha, int warp, void* stream) {
  const BwdArgs p{cur,  w,    wt,  tau, rho,  v0,   a0,   s0,   spikes,
                  gs,   gvT,  gaT, ubuf, abuf, gc,  gtau, grho, gv0,
                  ga0,  gs0,  T,   B,   N,    v_th, beta, alpha, surrogate};
  return launch_rec_bwd<true>(p, warp != 0, (cudaStream_t)stream);
}

}  // extern "C"
