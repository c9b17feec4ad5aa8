// The backward of the feed-forward adaptive-threshold LIF scan for sm_90a:
// B5 `alif_bwd_f32`, the STBP adjoint of `alifrec.cu`'s `alif_kernel`.
//
// Replaces: the JAX package's custom VJP, jnp `lax.scan` code with no
//           Pallas kernel: src/repro/kernels/alifrec/ops.py::_bwd_core
//           (through `_alif_bwd`, w_rec None).
//
// Per (b, n) lane, in two passes, as `lif.cu`'s `lif_bwd_f32`:
//   1. forward, along the saved spikes (their resets and adaptation;
//      nothing is re-thresholded), with the forward's rounded steps: the
//      pre-reset membrane u_t = (tau v_{t-1}) + I_t and the adaptation
//      a_{t-1} before its update, written to two (T, B, N) scratch planes;
//   2. reverse, t = T - 1 .. 0, with (gv, ga) the cotangents of (v_t, a_t)
//      (gv_{T-1} = g_vT, ga_{T-1} = g_aT) and th = v_th + beta a_{t-1},
//      `surrogate.cuh`'s `neuron_adjoint` without a recurrent term:
//        Gs~ = gs + ga;  Sig = (Gs~ - gv u) g(u - th)
//        Gu  = gv (1 - s) + Sig;  gv <- tau Gu;  ga <- rho ga - beta Sig
//      writing g_current = Gu and the lane's g_tau partial (Gu_t v_{t-1},
//      descending t; v_{t-1} rebuilt from u_{t-1} and s_{t-1}, a step
//      late) and g_rho partial (ga_t a_{t-1}, descending t), which the
//      wrapper sums over B; after t = 0, g_v0 = gv and g_a0 = ga. A null
//      output pointer skips that output.
//
// What bounds it on an H100: like `lif_bwd`, a lane's serial chain, not
// the bytes (current, spikes and their cotangent in, g_current out, four
// bytes each a lane-step) or the few dozen operations a lane-step. Lanes
// are independent, so there is no exchange: one thread owns one lane with
// its carries in registers, and both passes run `lane_scan.cuh`'s cp.async
// ring, as the forward does: pass 1 over (I, s) forward, pass 2 over
// (u, a_{t-1}, s, Gs) reversed (base at t = T - 1, stride -B N). CTAs of
// one warp, as `lif_bwd_f32`'s: a training step's lanes are few.
//
// Rounding: every operation is one rounded fp32 step in the order of
// `kernels/alifrec/ref.py::alif_scan_bwd_ref`, so the kernel equals it bit
// for bit (sigmoid: within its expf). The surrogate is a run-time
// argument: one instantiation a ring layout keeps the build short.

#include <cuda_runtime.h>
#include <cstdint>

#include "lane_scan.cuh"
#include "surrogate.cuh"

namespace {

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
  float* ubuf;       // (T, B, N) scratch: u_t
  float* abuf;       // (T, B, N) scratch: a_{t-1}
  float* gc;         // (T, B, N): g_current
  float* gtau;       // (B, N): g_tau partials, or null
  float* grho;       // (B, N): g_rho partials, or null
  float* gv0;        // (B, N), or null
  float* ga0;        // (B, N), or null
  int T, B, N;
  float v_th, beta, alpha;
  int sur;
};

template <int THREADS, bool VEC>
__global__ void __launch_bounds__(THREADS) alif_bwd_kernel(
    const AlifBwdArgs p) {
  extern __shared__ __align__(16) float ring_smem[];
  const int64_t lanes = (int64_t)p.B * p.N;
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= lanes) return;                 // no barrier below: leave
  const int n = (int)(idx % p.N);
  const float tn = p.tau[n], rn = p.rho[n];
  const float v_init = p.v0[idx];
  {  // 1. u and a_{t-1} forward, along the saved spikes
    const float* base[2] = {p.cur + idx, p.sp + idx};
    const int64_t stride[2] = {lanes, lanes};
    LaneRing<2, THREADS, VEC> ring(ring_smem, base, stride, p.T);
    float v = v_init, a = p.a0[idx];
    float* up = p.ubuf + idx;
    float* ap = p.abuf + idx;
    lane_scan(ring, [&](const auto& in, int k) {
      const float u = __fadd_rn(__fmul_rn(tn, v), in[0][k]);
      const float s = in[1][k];
      *up = u;
      *ap = a;
      up += lanes;
      ap += lanes;
      v = __fmul_rn(u, __fsub_rn(1.f, s));
      a = __fadd_rn(__fmul_rn(rn, a), s);
    });
  }
  // VEC: the warp's u stores are read back by its neighbours' copies, and
  // the ring's slots are refilled: every thread is past pass 1
  __threadfence_block();
  if (VEC) __syncwarp();
  {  // 2. the reverse scan
    const int64_t last = (int64_t)(p.T - 1) * lanes + idx;
    const float* base[4] = {p.ubuf + last, p.abuf + last, p.sp + last,
                            p.gs + last};
    const int64_t stride[4] = {-lanes, -lanes, -lanes, -lanes};
    LaneRing<4, THREADS, VEC> ring(ring_smem, base, stride, p.T);
    const Surrogate g_of = make_surrogate(p.sur, p.alpha);
    float gv = p.gvT[idx], ga = p.gaT[idx];
    float acc = 0.f, accr = 0.f, gnext = 0.f;
    bool first = true;
    float* gp = p.gc + last;
    lane_scan(ring, [&](const auto& in, int k) {
      const float u = in[0][k], ap = in[1][k], s = in[2][k];
      if (!first)                            // Gu_{t+1} v_t
        acc = __fadd_rn(acc,
                        __fmul_rn(gnext, __fmul_rn(u, __fsub_rn(1.f, s))));
      first = false;
      const float gu = neuron_adjoint<true, false>(
          u, threshold<true>(p.v_th, p.beta, ap), ap, s, in[3][k], 0.f, tn,
          rn, p.beta, g_of, gv, ga, accr);
      *gp = gu;
      gp -= lanes;
      gnext = gu;
    });
    if (p.gtau) p.gtau[idx] = __fadd_rn(acc, __fmul_rn(gnext, v_init));
    if (p.grho) p.grho[idx] = accr;
    if (p.gv0) p.gv0[idx] = gv;
    if (p.ga0) p.ga0[idx] = ga;
  }
}

}  // namespace

extern "C" {

// The backward of alif_f32 (see above): g_current (T, B, N), and where not
// null the per-lane g_tau and g_rho partials (B, N), g_v0 and g_a0 (B, N),
// with u and a_{t-1} (T, B, N) as scratch. surrogate: 0 arctan,
// 1 rectangle, 2 sigmoid, 3 triangle; stages as alif_f32's (`lane_plan`).
// The ring holds four planes (pass 2's; pass 1 uses two).
int alif_bwd_f32(const float* cur, const float* tau, const float* rho,
                 const float* v0, const float* a0, const float* spikes,
                 const float* gs, const float* gvT, const float* gaT,
                 float* ubuf, float* abuf, float* gc, float* gtau,
                 float* grho, float* gv0, float* ga0, int T, int B, int N,
                 float v_th, float beta, int surrogate, float alpha,
                 int stages, void* stream) {
  if (T < 1 || B < 1 || N < 1 || stages != lane_ring_stages(T) ||
      surrogate < 0 || surrogate > 3)
    return (int)cudaErrorInvalidValue;
  const AlifBwdArgs p{cur,  tau,  rho,  v0,  a0,  spikes, gs,   gvT,
                      gaT,  ubuf, abuf, gc,  gtau, grho,  gv0,  ga0,
                      T,    B,    N,    v_th, beta, alpha, surrogate};
  const int64_t lanes = (int64_t)B * N;
  const cudaStream_t st = (cudaStream_t)stream;
  // pass 1 copies the current, pass 2 the u scratch, 16 bytes a thread
  const bool vec = lane_vec(cur, lanes) && lane_vec(ubuf, lanes);
  return vec ? launch_lane_scan<32, 4>(alif_bwd_kernel<32, true>, lanes,
                                      stages, st, p)
             : launch_lane_scan<32, 4>(alif_bwd_kernel<32, false>, lanes,
                                      stages, st, p);
}

}  // extern "C"
