// The surrogate spike gradients and one neuron's reverse step, shared by
// the backward kernels: `lif_bwd.cu`'s `lif_bwd_f32` (B1), `rec_bwd.cu`'s
// `lifrec_bwd_f32` (B4) and `alifrec_bwd_f32` (B5), `alif_bwd.cu`'s
// `alif_bwd_f32` (B5). Each takes the surrogate as a run-time argument.
//
// Every operation is one rounded fp32 step (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn: nvcc cannot contract them into an FMA), in the
// order of the plain versions (`core/surrogate.py`, `kernels/*/ref.py`),
// so the kernels equal them bit for bit for the rectangle, triangle and
// arctan surrogates; sigmoid's expf is within an ulp or two of PyTorch's.

#pragma once

#include <cuda_runtime.h>

namespace {

constexpr float HALF_PI = 1.57079637050628662109375f;   // fp32(pi / 2)

// d spike / d x at x = u - th: 0 arctan, 1 rectangle (its window
// indicator; the callers map it to the quotient), 2 sigmoid, 3 triangle
// (the plain versions' arithmetic, `core/surrogate.py`)
template <int SUR>
__device__ __forceinline__ float surrogate(float x, float alpha) {
  if constexpr (SUR == 0) {
    const float y = __fmul_rn(__fmul_rn(HALF_PI, alpha), x);
    return __fdiv_rn(alpha,
                     __fmul_rn(2.f, __fadd_rn(1.f, __fmul_rn(y, y))));
  } else if constexpr (SUR == 1) {
    // 1/alpha or 0/alpha: both quotients hoisted by the caller (a division
    // of 0 takes the slow path of __fdiv_rn at every step)
    return fabsf(x) < __fmul_rn(alpha, 0.5f) ? 1.f : 0.f;
  } else if constexpr (SUR == 2) {
    const float sg =
        __fdiv_rn(1.f, __fadd_rn(1.f, expf(-__fmul_rn(alpha, x))));
    return __fmul_rn(__fmul_rn(alpha, sg), __fsub_rn(1.f, sg));
  } else {
    return __fmul_rn(
        fmaxf(0.f, __fsub_rn(1.f, fabsf(__fmul_rn(alpha, x)))), alpha);
  }
}

// The surrogate chosen at run time (the index above) and its constants:
// rectangle's quotients in_win = 1/alpha and out_win = 0/alpha, the same
// bits as the plain version's per-element division (`make_surrogate`,
// once a thread).
struct Surrogate {
  int sur;
  float alpha, in_win, out_win;
  __device__ __forceinline__ float operator()(float x) const;
};

__device__ __forceinline__ Surrogate make_surrogate(int sur, float alpha) {
  return Surrogate{sur, alpha, __fdiv_rn(1.f, alpha), __fdiv_rn(0.f, alpha)};
}

// g[i] = g(x[i]) for a group of G values with one switch on the surrogate
// (warp-uniform, so a branch and not a divergence), so that the G
// evaluations run side by side and not behind a branch each.
template <int G>
__device__ __forceinline__ void surrogate_group(float (&g)[G],
                                                const float (&x)[G],
                                                const Surrogate& g_of) {
  switch (g_of.sur) {
    case 0:
#pragma unroll
      for (int i = 0; i < G; ++i) g[i] = surrogate<0>(x[i], g_of.alpha);
      break;
    case 1:
#pragma unroll
      for (int i = 0; i < G; ++i)
        g[i] = surrogate<1>(x[i], g_of.alpha) != 0.f ? g_of.in_win
                                                     : g_of.out_win;
      break;
    case 2:
#pragma unroll
      for (int i = 0; i < G; ++i) g[i] = surrogate<2>(x[i], g_of.alpha);
      break;
    default:
#pragma unroll
      for (int i = 0; i < G; ++i) g[i] = surrogate<3>(x[i], g_of.alpha);
  }
}

__device__ __forceinline__ float Surrogate::operator()(float x) const {
  float g[1];
  const float xs[1] = {x};
  surrogate_group<1>(g, xs, *this);
  return g[0];
}

// One reverse step of a hard-reset neuron (LIF, or ALIF with ADAPT), the
// STBP adjoint of the JAX package's custom VJPs: from its pre-reset u_t,
// its surrogate gradient g = g(u_t - th_t) (th_t = v_th, or v_th + beta
// a_{t-1}), spike s_t, the spike's outer cotangent gs_t and, where REC,
// the recurrent adjoint rec_t = sum_k Gu_{t+1}[k] W[j, k]; with (gv, ga)
// the cotangents of (v_t, a_t):
//   Gs~   = (gs [+ ga]) [+ rec]
//   Sig   = (Gs~ - gv u) g
//   Gu    = gv (1 - s) + Sig
//   gv   <- tau Gu;   ga <- rho ga - beta Sig   (ADAPT)
// and acc_rho += ga_t a_{t-1} (ADAPT: the lane's g_rho partial, before ga
// moves). Returns Gu_t. This is the step's one body; g_at() gives g,
// evaluated between Gs~ and Sig: `neuron_adjoint_g` takes g computed
// ahead (the recurrent backward's warp route, off its chain) and
// `neuron_adjoint` computes it there from th_t. (Computing g before Gs~,
// as an argument, put the surrogate's switch ahead of the adds and made
// the recurrent backward's block route slower on an H100.)
template <bool ADAPT, bool REC, class GAt>
__device__ __forceinline__ float adjoint_step(
    float u, const GAt& g_at, float ap, float s, float gs, float rec,
    float tn, float rn, float beta, float& gv, float& ga, float& acc_rho) {
  float gst = ADAPT ? __fadd_rn(gs, ga) : gs;
  if (REC) gst = __fadd_rn(gst, rec);
  const float g = g_at();
  const float sig = __fmul_rn(__fsub_rn(gst, __fmul_rn(gv, u)), g);
  const float gu = __fadd_rn(__fmul_rn(gv, __fsub_rn(1.f, s)), sig);
  if (ADAPT) {
    acc_rho = __fadd_rn(acc_rho, __fmul_rn(ga, ap));
    ga = __fsub_rn(__fmul_rn(rn, ga), __fmul_rn(beta, sig));
  }
  gv = __fmul_rn(tn, gu);
  return gu;
}

template <bool ADAPT, bool REC>
__device__ __forceinline__ float neuron_adjoint_g(
    float u, float g, float ap, float s, float gs, float rec, float tn,
    float rn, float beta, float& gv, float& ga, float& acc_rho) {
  return adjoint_step<ADAPT, REC>(
      u, [g] { return g; }, ap, s, gs, rec, tn, rn, beta, gv, ga, acc_rho);
}

template <bool ADAPT, bool REC>
__device__ __forceinline__ float neuron_adjoint(
    float u, float th, float ap, float s, float gs, float rec, float tn,
    float rn, float beta, const Surrogate& g_of, float& gv, float& ga,
    float& acc_rho) {
  return adjoint_step<ADAPT, REC>(
      u, [&] { return g_of(__fsub_rn(u, th)); }, ap, s, gs, rec, tn, rn,
      beta, gv, ga, acc_rho);
}

// th_t of a neuron: v_th, or v_th + beta a_{t-1} (the forward's order)
template <bool ADAPT>
__device__ __forceinline__ float threshold(float v_th, float beta, float ap) {
  return ADAPT ? __fadd_rn(v_th, __fmul_rn(beta, ap)) : v_th;
}

}  // namespace
