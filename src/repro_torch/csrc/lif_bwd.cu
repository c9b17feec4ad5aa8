// The backward of the fused LIF scan for sm_90a: B1 `lif_bwd_f32`, the
// STBP adjoint of `lif.cu`'s `lif_kernel`.
//
// Replaces: the JAX package's custom VJP, jnp `lax.scan` code with no
//           Pallas kernel: src/repro/kernels/lif/ops.py::_lif_bwd.
//
// Per (b, n) lane:
//   forward  along the saved spikes (their resets; nothing is
//            re-thresholded), with the forward's rounded steps: the
//            pre-reset membrane u_t = (tau v_{t-1}) + I_t and
//            v_t = after_reset(u_t, s_t);
//   reverse  t = T - 1 .. 0, with Gv the cotangent of v_t (Gv_{T-1} =
//            g_vT) and g = g(u_t - v_th):
//              zero:     Gu = Gv (1 - s) + (Gs - Gv u) g
//              subtract: Gu = Gv (1 - v_th g) + Gs g
//              Gv <- tau Gu
//            writing g_current = Gu and the lane's g_tau partial (Gu_{t+1}
//            v_t, descending t, then Gu_0 v0); after t = 0, g_v0 = Gv.
//   sums     g_tau, the partials summed over B in ascending b by the
//            kernel's last CTA to finish. A null g_tau or g_v0 is skipped.
//
// What bounds it on an H100: a lane's serial chain, not the bytes
// (current, spikes and their cotangent in, g_current out, four bytes each
// a lane-step: 0.89 us at (60, 48, 64)) or the twenty operations a
// lane-step. The reverse step's chain on Gv is five rounded operations
// deep under the zero reset (Gv u, Gs - Gv u, times g, + Gv (1 - s), tau
// Gu), three under subtract; the forward's three on v.
//
// Design: `alif_bwd.cu`'s, on the skeleton both share (`lane_bwd.cuh`). A
// CTA owns 32 lanes: a chain warp, whose thread l carries lane l's v, Gv,
// Gu_{t+1} and g_tau partial in registers, and three helper warps. Time is
// cut into segments of SEG steps (LANE_BWD_SEG); a segment's planes live in
// shared memory, [plane][step][lane]:
//   load     all four warps copy the segment's current and spikes, and in a
//            commit group of its own that lands while the forward runs
//            their cotangent, by cp.async, 16 bytes a copy where the
//            planes allow;
//   forward  the chain warp runs the segment's forward steps from its
//            checkpoint v and writes u_t;
//   terms    all four warps compute, for every (step, lane), what the
//            reverse step needs that does not depend on Gv: g(u_t - v_th)
//            (the surrogate a run-time argument: `surrogate_group`, one
//            warp-uniform switch for four values a thread) in place of the
//            current, Gv's coefficient (1 - s under the zero reset, 1 -
//            v_th g under subtract) in place of the spikes, and v_t for
//            g_tau;
//   reverse  the chain warp runs only the dependent adjoint steps, every
//            load from shared memory, and writes Gu in place of the
//            cotangent; Gu_{t+1} crosses a segment's edge in a register;
//   store    all four warps write the segment's g_current, coalesced.
// With more than one segment, a first forward pass over segments 0 ..
// S - 2 writes each segment's starting v to the `ckpt` scratch ((S, B, N);
// the wrapper allocates it only for T > SEG), and the reverse walks the
// segments from the last, each recomputing its forward from its
// checkpoint: no (T, B, N) scratch plane. Then the g_tau partials go to a
// (B, N) scratch and the last CTA to finish sums them over B, so that the
// wrapper launches nothing after the kernel.
//
// Rounding: every operation is one rounded fp32 step (__fmul_rn,
// __fadd_rn, __fsub_rn, __fdiv_rn: no contraction into an FMA) in the
// order of `kernels/lif/ref.py::lif_scan_bwd_ref`, so the kernel equals it
// bit for bit for the rectangle, triangle and arctan surrogates (sigmoid:
// within its expf); computing the terms off the chain changes no
// operation, only where it runs, and the sum over B follows
// `sum_rows_ascending`, the plain version's.

#include <cuda_runtime.h>
#include <cstdint>

#ifdef LIF_BWD_PASS_CLOCKS
#define LANE_BWD_CLK lif_bwd_pass_clk
#endif
#include "lane_bwd.cuh"
#include "surrogate.cuh"

// cycles by phase, in a build with -DLIF_BWD_PASS_CLOCKS (`lane_bwd.cuh`)
LANE_BWD_CLK_READER(lif_bwd_pass_clocks)

namespace {

// the segment's planes in shared memory, [plane][step][lane]: the current
// (then g), the spikes (then Gv's coefficient), their cotangent (then Gu),
// u_t, v_t
enum { P_I, P_S, P_GS, P_U, P_V, PLANES };
constexpr size_t SMEM = (size_t)PLANES * SEG * 32 * sizeof(float);
// the (step, lane) pairs of a segment each thread computes the terms of
constexpr int EPT = SEG * 32 / THREADS;
static_assert(SEG * 32 % THREADS == 0, "whole rows of pairs a thread");

struct LifBwdArgs {
  const float* cur;  // (T, B, N)
  const float* tau;  // (N,)
  const float* v0;   // (B, N)
  const float* sp;   // (T, B, N): the forward's spikes
  const float* gs;   // (T, B, N): their cotangent
  const float* gvT;  // (B, N)
  float* ckpt;       // (S, B, N): segment k's starting v, S > 1
  float* part;       // (B, N): the per-lane g_tau partials
  unsigned* count;   // a counter at 0: the CTAs done with their partials
  float* gc;         // (T, B, N): g_current
  float* gtau;       // (N,), or null
  float* gv0;        // (B, N), or null
  int T, B, N;
  float v_th, alpha;
  int sur;
  bool vec;          // B N % 4 == 0 and the planes 16-byte aligned
};

template <bool SUBTRACT>
__device__ __forceinline__ float after_reset(float u, float s, float v_th) {
  return SUBTRACT ? __fsub_rn(u, __fmul_rn(v_th, s))
                  : __fmul_rn(u, __fsub_rn(1.f, s));
}

// Steps a chain thread takes from shared memory at once. The compiler
// keeps a shared load after every earlier store to the same array, so a
// load a step would put its latency on the chain; a batch's loads are
// issued together, its chain runs with no branch, its stores follow. The
// steps past the last whole batch run one at a time.
constexpr int FB = 8;

// The chain warp's forward over a segment's n steps from v; with KEEP,
// u_t goes to its plane.
template <bool SUBTRACT, bool KEEP>
__device__ __forceinline__ void forward(float* sm, int n, float tn,
                                        float v_th, float& v) {
  const int lane = threadIdx.x % 32;
  const float* pi = at(sm, P_I, 0) + lane;
  const float* ps = at(sm, P_S, 0) + lane;
  float* pu = at(sm, P_U, 0) + lane;
  auto step = [&](float i, float s) {
    const float u = __fadd_rn(__fmul_rn(tn, v), i);
    v = after_reset<SUBTRACT>(u, s, v_th);
    return u;
  };
  int u0 = 0;
  for (; u0 + FB <= n; u0 += FB) {
    float I[FB], S[FB], U[FB];
#pragma unroll
    for (int j = 0; j < FB; ++j) {
      I[j] = pi[32 * (u0 + j)];
      S[j] = ps[32 * (u0 + j)];
    }
#pragma unroll
    for (int j = 0; j < FB; ++j) U[j] = step(I[j], S[j]);
    if (KEEP) {
#pragma unroll
      for (int j = 0; j < FB; ++j) pu[32 * (u0 + j)] = U[j];
    }
  }
  for (; u0 < n; ++u0) {
    const float u = step(pi[32 * u0], ps[32 * u0]);
    if (KEEP) pu[32 * u0] = u;
  }
}

// The chain warp's reverse over a segment's n steps, t descending, from
// the terms the helpers wrote (g, Gv's coefficient c, v_t) and the
// cotangent Gs (and u under the zero reset); Gu goes in place of Gs. gv:
// Gv; acc: the lane's g_tau partial; gnext: Gu_{t+1}; first: no step has
// run yet (the call's last step has no Gu_{t+1} v_t term).
template <bool SUBTRACT>
__device__ __forceinline__ void reverse(float* sm, int n, float tn,
                                        float& gv, float& acc, float& gnext,
                                        bool& first) {
  const int lane = threadIdx.x % 32;
  const float* pg = at(sm, P_I, 0) + lane;
  const float* pc = at(sm, P_S, 0) + lane;
  float* pgs = at(sm, P_GS, 0) + lane;
  const float* pu = at(sm, P_U, 0) + lane;
  const float* pv = at(sm, P_V, 0) + lane;
  // zero: Gu = Gv (1 - s) + (Gs - Gv u) g; subtract: Gv (1 - v_th g) + Gs g
  auto adjoint = [&](float g, float c, float gs, float u) {
    const float sig = SUBTRACT
                          ? __fmul_rn(gs, g)
                          : __fmul_rn(__fsub_rn(gs, __fmul_rn(gv, u)), g);
    const float gu = __fadd_rn(__fmul_rn(gv, c), sig);
    gv = __fmul_rn(tn, gu);
    return gu;
  };
  int u0 = n - 1;
  if (first) {                             // the call's last step
    gnext = adjoint(pg[32 * u0], pc[32 * u0], pgs[32 * u0],
                    SUBTRACT ? 0.f : pu[32 * u0]);
    pgs[32 * u0] = gnext;
    first = false;
    --u0;
  }
  for (; u0 + 1 >= FB; u0 -= FB) {         // steps u0, u0 - 1, ...
    float G[FB], C[FB], GS[FB], U[FB], V[FB], GU[FB];
#pragma unroll
    for (int j = 0; j < FB; ++j) {
      const int u = 32 * (u0 - j);
      G[j] = pg[u];
      C[j] = pc[u];
      GS[j] = pgs[u];
      V[j] = pv[u];
      U[j] = SUBTRACT ? 0.f : pu[u];
    }
#pragma unroll
    for (int j = 0; j < FB; ++j) {
      acc = __fadd_rn(acc, __fmul_rn(gnext, V[j]));  // Gu_{t+1} v_t
      GU[j] = gnext = adjoint(G[j], C[j], GS[j], U[j]);
    }
#pragma unroll
    for (int j = 0; j < FB; ++j) pgs[32 * (u0 - j)] = GU[j];
  }
  for (; u0 >= 0; --u0) {
    acc = __fadd_rn(acc, __fmul_rn(gnext, pv[32 * u0]));
    gnext = adjoint(pg[32 * u0], pc[32 * u0], pgs[32 * u0],
                    SUBTRACT ? 0.f : pu[32 * u0]);
    pgs[32 * u0] = gnext;
  }
}

template <bool SUBTRACT>
__global__ void __launch_bounds__(THREADS) lif_bwd_kernel(
    const LifBwdArgs p) {
  extern __shared__ __align__(16) float sm[];
  __shared__ bool last;                      // this CTA counted last
  PASS_CLK_BEGIN;
  const int64_t lanes = (int64_t)p.B * p.N;
  const int lane = threadIdx.x % 32;
  const bool chain = threadIdx.x < 32;       // warp 0
  const int64_t base = (int64_t)blockIdx.x * 32, idx = base + lane;
  const bool in = idx < lanes;
  const float tn = p.tau[in ? (int)(idx % p.N) : 0];
  const float v_init = in ? p.v0[idx] : 0.f;
  const int segs = (p.T + SEG - 1) / SEG;
  const float* const in_src[2] = {p.cur, p.sp};
  const int in_pl[2] = {P_I, P_S};
  const float* const gs_src[1] = {p.gs};
  const int gs_pl[1] = {P_GS};

  // forward over segments 0 .. segs - 2: their successors' checkpoints
  float v = v_init;
  for (int k = 0; k + 1 < segs; ++k) {
    load_planes<2>(sm, p.vec, lanes, base, k * SEG, SEG, in_src, in_pl);
    cp_async_wait<0>();
    __syncthreads();
    if (chain) {
      forward<SUBTRACT, false>(sm, SEG, tn, p.v_th, v);
      if (in) p.ckpt[(int64_t)(k + 1) * lanes + idx] = v;
    }
    __syncthreads();                         // before the planes refill
  }
  PASS_CLK(CLK_FORWARD);

  // the reverse, a segment at a time from the last
  const Surrogate g_of = make_surrogate(p.sur, p.alpha);
  float gv = in ? p.gvT[idx] : 0.f, acc = 0.f, gnext = 0.f;
  bool first = true;
  for (int k = segs - 1; k >= 0; --k) {
    const int t0 = k * SEG, n = min(SEG, p.T - t0);
    load_planes<2>(sm, p.vec, lanes, base, t0, n, in_src, in_pl);
    load_planes<1>(sm, p.vec, lanes, base, t0, n, gs_src, gs_pl);
    cp_async_wait<1>();                      // the current and the spikes
    __syncthreads();
    PASS_CLK(CLK_LOAD);
    if (chain) {
      // this thread's checkpoint from the first pass, or the call's state
      v = k == 0 ? v_init : (in ? p.ckpt[(int64_t)k * lanes + idx] : 0.f);
      forward<SUBTRACT, true>(sm, n, tn, p.v_th, v);
    }
    __syncthreads();
    PASS_CLK(CLK_FORWARD);
    // the terms of every (step, lane) that do not depend on Gv, all four
    // warps, EPT a thread: all loaded first, then g of all at once, then
    // stored: g in place of the current, Gv's coefficient in place of the
    // spikes, v_t
    {
      float uu[EPT], ss[EPT], x[EPT], g[EPT];
#pragma unroll
      for (int q = 0; q < EPT; ++q) {
        const int e = min((int)threadIdx.x + q * THREADS, n * 32 - 1);
        uu[q] = at(sm, P_U, 0)[e];
        ss[q] = at(sm, P_S, 0)[e];
        x[q] = __fsub_rn(uu[q], p.v_th);
      }
      surrogate_group<EPT>(g, x, g_of);
#pragma unroll
      for (int q = 0; q < EPT; ++q) {
        const int e = threadIdx.x + q * THREADS;
        if (e >= n * 32) continue;
        at(sm, P_V, 0)[e] = after_reset<SUBTRACT>(uu[q], ss[q], p.v_th);
        at(sm, P_S, 0)[e] = SUBTRACT
                                ? __fsub_rn(1.f, __fmul_rn(p.v_th, g[q]))
                                : __fsub_rn(1.f, ss[q]);
        at(sm, P_I, 0)[e] = g[q];
      }
    }
    PASS_CLK(CLK_G);
    cp_async_wait<0>();                      // the cotangent
    __syncthreads();
    PASS_CLK(CLK_GS_WAIT);
    if (chain) reverse<SUBTRACT>(sm, n, tn, gv, acc, gnext, first);
    __syncthreads();
    PASS_CLK(CLK_REVERSE);
    // the call's last segment done: the chain warp writes its lanes' sum
    // partials and counts the CTA done while the others store
    if (k == 0 && chain && p.gtau) {
      if (in)
        p.part[idx] = __fadd_rn(acc, __fmul_rn(gnext, v_init));
      arrive(p.count, last);
    }
    // g_current of the segment, all four warps
    store_plane(sm, P_GS, p.gc, p.vec, lanes, base, t0, n);
    __syncthreads();                         // before the planes refill
    PASS_CLK(CLK_STORE);
  }
  if (chain && in && p.gv0) p.gv0[idx] = gv;
  // g_tau over B, in ascending b, by the last CTA to finish
  float* const dst[1] = {p.gtau};
  if (p.gtau) sum_over_b<1>(p.part, dst, p.count, last, lanes, p.B, p.N);
  PASS_CLK(CLK_SUMS);
  PASS_CLK_END
}

}  // namespace

extern "C" {

// The backward of lif_f32 (see above): g_current (T, B, N), and where not
// null g_tau (N,), summed over B in ascending b, and g_v0 (B, N). `ckpt`
// holds (ceil(T / LANE_BWD_SEG), B, N) floats of scratch where T is over
// one segment (else it may be null); `part` (B, N) floats and `count` a
// zeroed counter (left at 0) where g_tau is asked for. subtract: the
// reset (0 zero, 1 subtract); surrogate: 0 arctan, 1 rectangle, 2
// sigmoid, 3 triangle.
int lif_bwd_f32(const float* cur, const float* tau, const float* v0,
                const float* spikes, const float* gs, const float* gvT,
                float* ckpt, float* part, unsigned* count, float* gc,
                float* gtau, float* gv0, int T, int B, int N, float v_th,
                int subtract, int surrogate, float alpha, void* stream) {
  if (T < 1 || B < 1 || N < 1 || (T > SEG && !ckpt) ||
      (gtau && (!part || !count)) || surrogate < 0 || surrogate > 3)
    return (int)cudaErrorInvalidValue;
  const int64_t lanes = (int64_t)B * N;
  const LifBwdArgs p{cur, tau,  v0, spikes, gs,    gvT,   ckpt,
                     part, count, gc, gtau,  gv0,   T,     B,
                     N,   v_th, alpha, surrogate,
                     lane_bwd_vec(lanes, cur, spikes, gs, gc)};
  return subtract ? launch_lane_bwd(lif_bwd_kernel<true>, SMEM, lanes, p,
                                    stream)
                  : launch_lane_bwd(lif_bwd_kernel<false>, SMEM, lanes, p,
                                    stream);
}

}  // extern "C"
