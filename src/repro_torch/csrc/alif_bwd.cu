// The backward of the feed-forward adaptive-threshold LIF scan for sm_90a:
// B5 `alif_bwd_f32`, the STBP adjoint of `alifrec.cu`'s `alif_kernel`.
//
// Replaces: the JAX package's custom VJP, jnp `lax.scan` code with no
//           Pallas kernel: src/repro/kernels/alifrec/ops.py::_bwd_core
//           (through `_alif_bwd`, w_rec None).
//
// Per (b, n) lane:
//   forward  along the saved spikes (their resets and adaptation; nothing
//            is re-thresholded), with the forward's rounded steps: the
//            pre-reset membrane u_t = (tau v_{t-1}) + I_t and the
//            adaptation a_{t-1} before its update;
//   reverse  t = T - 1 .. 0, with (gv, ga) the cotangents of (v_t, a_t)
//            (gv_{T-1} = g_vT, ga_{T-1} = g_aT), g = g(u_t - th_t) and
//            th_t = v_th + beta a_{t-1}, `surrogate.cuh`'s adjoint without
//            a recurrent term:
//              Gs~ = gs + ga;  Sig = (Gs~ - gv u) g
//              Gu  = gv (1 - s) + Sig;  gv <- tau Gu;  ga <- rho ga - beta Sig
//            writing g_current = Gu, the lane's g_tau partial (Gu_{t+1}
//            v_t, descending t, then Gu_0 v0) and g_rho partial (ga_t
//            a_{t-1}, descending t); after t = 0, g_v0 = gv and g_a0 = ga.
//   sums     g_tau and g_rho, the partials summed over B in ascending b,
//            by the kernel's last CTA to finish. A null output pointer
//            skips that output.
//
// What bounds it on an H100: a lane's serial chain, not the bytes
// (current, spikes and their cotangent in, g_current out, four bytes each
// a lane-step: 0.90 us at (60, 48, 64)) or the few dozen operations a
// lane-step. The reverse step's chain is five rounded operations deep on
// gv (gv u, Gs~ - gv u, times g, + gv (1 - s), tau Gu) and as many on ga;
// the forward's three on v.
//
// Design (its skeleton, the load, the store and the sums over B, in
// `lane_bwd.cuh`, shared with `lif_bwd.cu`). A CTA owns 32 lanes (a
// warp's width): a chain warp, whose thread l carries lane l's state in
// registers, and three helper warps. Time is cut into segments of SEG
// steps (LANE_BWD_SEG, from kernels/_build.py); a segment's planes live
// in shared memory, [plane][step][lane]:
//   load     all four warps copy the segment's current, spikes and (for
//            the reverse) their cotangent by cp.async, 16 bytes (four
//            lanes) a copy where the planes allow, the cotangent in a
//            commit group of its own that lands while the forward runs;
//   forward  the chain warp runs the segment's forward steps from its
//            checkpoint (v, a) and writes u_t and a_{t-1};
//   g        all four warps evaluate the surrogate g(u_t - th_t) of every
//            (step, lane) of the segment, four a thread at once, with its
//            division and, under sigmoid, its expf, in place of the
//            current;
//   reverse  the chain warp runs the segment's reverse steps, every load
//            from shared memory, and writes Gu in place of the cotangent;
//   store    all four warps write the segment's g_current, coalesced.
// With more than one segment, a first forward pass over segments 0 ..
// S - 2 writes each segment's starting (v, a) to the `ckpt` scratch
// ((S, 2, B, N); the wrapper allocates it only for T > SEG), and the
// reverse walks the segments from the last, each recomputing its forward
// from its checkpoint: no (T, B, N) scratch plane. Then the partials of
// g_tau and g_rho go to a (2, B, N) scratch and the last CTA to finish (a
// counter of the stream) sums them over B, so that the
// wrapper launches nothing after the kernel. (A lane a thread in CTAs of
// one warp, pass 1 writing u and a_{t-1} to two (T, B, N) scratch planes
// that pass 2 read back, and the sums over B two PyTorch launches, took
// 548 cycles a reverse step on the H100: the surrogate, the loads and the
// stores on the one warp of an SM.)
//
// Rounding: every operation is one rounded fp32 step in the order of
// `kernels/alifrec/ref.py::alif_scan_bwd_ref`, so the kernel equals it bit
// for bit (sigmoid: within its expf); computing g off the chain changes no
// operation, only where it runs, and the sums over B follow
// `sum_rows_ascending`, the plain version's. The surrogate is a run-time
// argument (one switch a group of values, warp-uniform).

#include <cuda_runtime.h>
#include <cstdint>

#ifdef ALIF_BWD_PASS_CLOCKS
#define LANE_BWD_CLK alif_bwd_pass_clk
#endif
#include "lane_bwd.cuh"
#include "surrogate.cuh"

// cycles by phase, in a build with -DALIF_BWD_PASS_CLOCKS (`lane_bwd.cuh`)
LANE_BWD_CLK_READER(alif_bwd_pass_clocks)

namespace {

// the segment's planes in shared memory, [plane][step][lane]: the current
// (then g), the spikes, their cotangent (then Gu), u_t, a_{t-1}
enum { P_I, P_S, P_GS, P_U, P_A, PLANES };
constexpr size_t SMEM = (size_t)PLANES * SEG * 32 * sizeof(float);

struct AlifBwdArgs {
  const float* cur;  // (T, B, N)
  const float* tau;  // (N,)
  const float* rho;  // (N,)
  const float* v0;   // (B, N)
  const float* a0;   // (B, N)
  const float* sp;   // (T, B, N): the forward's spikes
  const float* gs;   // (T, B, N): their cotangent
  const float* gvT;  // (B, N)
  const float* gaT;  // (B, N)
  float* ckpt;       // (S, 2, B, N): segment k's starting (v, a), S > 1
  float* part;       // (2, B, N): the per-lane g_tau, g_rho partials
  unsigned* count;   // a counter at 0: the CTAs done with their partials
  float* gc;         // (T, B, N): g_current
  float* gtau;       // (N,), or null
  float* grho;       // (N,), or null
  float* gv0;        // (B, N), or null
  float* ga0;        // (B, N), or null
  int T, B, N;
  float v_th, beta, alpha;
  int sur;
  bool vec;          // B N % 4 == 0 and the planes 16-byte aligned
};

// The chain warp's forward over a segment's n steps from (v, a); with
// KEEP, u_t and a_{t-1} go to the planes.
template <bool KEEP>
__device__ __forceinline__ void forward(float* sm, int n, float tn, float rn,
                                        float& v, float& a) {
  const int lane = threadIdx.x % 32;
#pragma unroll 4
  for (int u = 0; u < n; ++u) {
    const float s = at(sm, P_S, u)[lane];
    const float ut = __fadd_rn(__fmul_rn(tn, v), at(sm, P_I, u)[lane]);
    if (KEEP) {
      at(sm, P_U, u)[lane] = ut;
      at(sm, P_A, u)[lane] = a;
    }
    v = __fmul_rn(ut, __fsub_rn(1.f, s));
    a = __fadd_rn(__fmul_rn(rn, a), s);
  }
}

__global__ void __launch_bounds__(THREADS) alif_bwd_kernel(
    const AlifBwdArgs p) {
  extern __shared__ __align__(16) float sm[];
  __shared__ bool last;                      // this CTA counted last
  PASS_CLK_BEGIN;
  const int64_t lanes = (int64_t)p.B * p.N;
  const int lane = threadIdx.x % 32;
  const bool chain = threadIdx.x < 32;       // warp 0
  const int64_t base = (int64_t)blockIdx.x * 32, idx = base + lane;
  const bool in = idx < lanes;
  const int n_of = in ? (int)(idx % p.N) : 0;
  const float tn = p.tau[n_of], rn = p.rho[n_of];
  const float v_init = in ? p.v0[idx] : 0.f;
  const float a_init = in ? p.a0[idx] : 0.f;
  const int segs = (p.T + SEG - 1) / SEG;
  const float* const in_src[2] = {p.cur, p.sp};
  const int in_pl[2] = {P_I, P_S};
  const float* const gs_src[1] = {p.gs};
  const int gs_pl[1] = {P_GS};

  // forward over segments 0 .. segs - 2: their successors' checkpoints
  float v = v_init, a = a_init;
  for (int k = 0; k + 1 < segs; ++k) {
    load_planes<2>(sm, p.vec, lanes, base, k * SEG, SEG, in_src, in_pl);
    cp_async_wait<0>();
    __syncthreads();
    if (chain) {
      forward<false>(sm, SEG, tn, rn, v, a);
      if (in) {
        p.ckpt[(2 * (int64_t)(k + 1)) * lanes + idx] = v;
        p.ckpt[(2 * (int64_t)(k + 1) + 1) * lanes + idx] = a;
      }
    }
    __syncthreads();                         // before the planes refill
  }
  PASS_CLK(CLK_FORWARD);

  // the reverse, a segment at a time from the last
  const Surrogate g_of = make_surrogate(p.sur, p.alpha);
  float gv = in ? p.gvT[idx] : 0.f, ga = in ? p.gaT[idx] : 0.f;
  float acc = 0.f, accr = 0.f, gnext = 0.f;
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
      v = k == 0 ? v_init : (in ? p.ckpt[2 * (int64_t)k * lanes + idx] : 0.f);
      a = k == 0 ? a_init
                 : (in ? p.ckpt[(2 * (int64_t)k + 1) * lanes + idx] : 0.f);
      forward<true>(sm, n, tn, rn, v, a);
    }
    __syncthreads();
    PASS_CLK(CLK_FORWARD);
    // g(u_t - th_t) of every (step, lane) in place of the current, GQ a
    // thread at once, all four warps
    for (int e0 = threadIdx.x; e0 < n * 32; e0 += GQ * THREADS) {
      float x[GQ], g[GQ];
#pragma unroll
      for (int q = 0; q < GQ; ++q) {
        const int e = min(e0 + q * THREADS, n * 32 - 1);
        x[q] = __fsub_rn(at(sm, P_U, 0)[e],
                         threshold<true>(p.v_th, p.beta, at(sm, P_A, 0)[e]));
      }
      surrogate_group<GQ>(g, x, g_of);
#pragma unroll
      for (int q = 0; q < GQ; ++q)
        if (e0 + q * THREADS < n * 32) at(sm, P_I, 0)[e0 + q * THREADS] = g[q];
    }
    cp_async_wait<0>();                      // the cotangent
    __syncthreads();
    PASS_CLK(CLK_G);
    if (chain) {
#pragma unroll 4
      for (int u = n - 1; u >= 0; --u) {
        const float ut = at(sm, P_U, u)[lane], ap = at(sm, P_A, u)[lane];
        const float s = at(sm, P_S, u)[lane], g = at(sm, P_I, u)[lane];
        if (!first)                          // Gu_{t+1} v_t
          acc = __fadd_rn(acc,
                          __fmul_rn(gnext, __fmul_rn(ut, __fsub_rn(1.f, s))));
        first = false;
        const float gu = neuron_adjoint_g<true, false>(
            ut, g, ap, s, at(sm, P_GS, u)[lane], 0.f, tn, rn, p.beta, gv, ga,
            accr);
        at(sm, P_GS, u)[lane] = gu;
        gnext = gu;
      }
    }
    __syncthreads();
    PASS_CLK(CLK_REVERSE);
    // the call's last segment done: the chain warp writes its lanes' sum
    // partials and counts the CTA done while the others store
    if (k == 0 && chain && (p.gtau || p.grho)) {
      if (in) {
        p.part[idx] = __fadd_rn(acc, __fmul_rn(gnext, v_init));
        p.part[lanes + idx] = accr;
      }
      arrive(p.count, last);
    }
    // g_current of the segment, all four warps
    store_plane(sm, P_GS, p.gc, p.vec, lanes, base, t0, n);
    __syncthreads();                         // before the planes refill
    PASS_CLK(CLK_STORE);
  }
  if (chain && in) {
    if (p.gv0) p.gv0[idx] = gv;
    if (p.ga0) p.ga0[idx] = ga;
  }
  // g_tau and g_rho over B, in ascending b, by the last CTA to finish
  float* const dst[2] = {p.gtau, p.grho};
  if (p.gtau || p.grho)
    sum_over_b<2>(p.part, dst, p.count, last, lanes, p.B, p.N);
  PASS_CLK(CLK_SUMS);
  PASS_CLK_END
}

}  // namespace

extern "C" {

// The backward of alif_f32 (see above): g_current (T, B, N), and where not
// null g_tau and g_rho (N,), summed over B in ascending b, g_v0 and g_a0
// (B, N). `ckpt` holds (ceil(T / LANE_BWD_SEG), 2, B, N) floats of scratch
// where T is over one segment (else it may be null); `part` (2, B, N)
// floats and `count` a zeroed counter (left at 0) where g_tau or g_rho is
// asked for. surrogate: 0 arctan, 1 rectangle, 2 sigmoid, 3 triangle.
int alif_bwd_f32(const float* cur, const float* tau, const float* rho,
                 const float* v0, const float* a0, const float* spikes,
                 const float* gs, const float* gvT, const float* gaT,
                 float* ckpt, float* part, unsigned* count, float* gc,
                 float* gtau, float* grho, float* gv0, float* ga0, int T,
                 int B, int N, float v_th, float beta, int surrogate,
                 float alpha, void* stream) {
  if (T < 1 || B < 1 || N < 1 || (T > SEG && !ckpt) ||
      ((gtau || grho) && (!part || !count)) || surrogate < 0 ||
      surrogate > 3)
    return (int)cudaErrorInvalidValue;
  const int64_t lanes = (int64_t)B * N;
  const AlifBwdArgs p{cur,  tau,  rho,   v0,   a0,   spikes, gs,   gvT,
                      gaT,  ckpt, part,  count, gc,  gtau,   grho, gv0,
                      ga0,  T,    B,     N,    v_th, beta,   alpha, surrogate,
                      lane_bwd_vec(lanes, cur, spikes, gs, gc)};
  return launch_lane_bwd(alif_bwd_kernel, SMEM, lanes, p, stream);
}

}  // extern "C"
