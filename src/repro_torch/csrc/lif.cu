// Fused leaky integrate-and-fire over time (DIFF + threshold + SEND) for
// sm_90a.
//
// Replaces: src/repro/kernels/lif/kernel.py::lif_pallas
//           (body `_lif_kernel`).
//
// Per (b, n) lane and step t:
//   v = tau[n] * v + I_t;  s_t = [v >= v_th];
//   reset "zero":     v = v * (1 - s_t)
//   reset "subtract": v = v - v_th * s_t
// Writes the spikes (T, B, N) and the final membrane v_T (B, N).
//
// What bounds it on an H100. A handful of FLOP per element against 8
// bytes per element (current in, spike out), far below the fp32 ridge, so
// its bound is the bytes. But its real calls are small: the SHD window's
// soma is 4096 lanes of 32 steps, a learning run's hidden layer 1024
// lanes of 300, the banded topology's chunk 8192 lanes of 64. There the
// time is each lane's serial chain and the memory round trips it waits
// on: the reset makes the recurrence non-associative, so time stays
// serial. The TPU kernel keeps a (ct, bb, bn) current block in VMEM and
// carries v across a sequential grid; here the B * N lanes are the
// parallelism: one thread owns one (b, n) lane and holds v in a register.
//
// Design: `linrec.cu`'s. The current reaches the chain through
// `lane_scan.cuh`'s ring (chunks of LS_CHUNK steps copied by cp.async into
// shared memory, LS_STAGES - 1 in flight while the chain runs over the oldest,
// the copies issued in the chain's gaps: 16 bytes a thread, four steps of the
// warp's lanes a copy, where the rows are whole warps, else a step a copy),
// tau sits in a register, and the spike is stored every step, one coalesced
// 128-byte store a warp. The wrapper sizes the CTA from the lanes (one to four
// warps, `kernels/common.py::lane_plan`), so that 1024 lanes spread over 32
// SMs and 8192 over 128. In steady state a step costs its dependent chain plus
// the shared load, copy and store a lone warp issues around it. The chain is
// the product, the sum, the compare and the reset, so the compare gives its
// result as a value (`set_ge`, and for the zero reset its complement 1 - s,
// `set_ltu`, straight from the same compare): a predicate and a select would
// wait longer on it.
//
// Rounding: __fadd_rn(__fmul_rn(tau, v), I) is a rounded product then a
// rounded sum, exactly what the plain PyTorch version computes; a fused
// multiply-add would differ by one ulp now and then, and at the threshold
// one ulp flips a spike. The resets are the plain version's own
// arithmetic, v * (1 - s) and v - v_th * s with s and 1 - s exactly 1.0
// or 0.0, so every output has its bits, signs of zeros and non-positive
// thresholds included.
//
// The backward kernel (B1, `lif_bwd_f32`) is the STBP adjoint of the JAX
// package's custom VJP (`repro/kernels/lif/ops.py::_lif_bwd`), one thread
// a (b, n) lane in two passes:
//   1. forward, the pre-reset membrane u_t = tau v_{t-1} + I_t recomputed
//      with the forward's rounded steps along the saved spikes (their
//      resets; nothing is re-thresholded), written to a (T, B, N) scratch;
//   2. reverse, with g = surrogate'(u_t - v_th) computed in registers
//      (SUR: the index of the surrogate in sorted names, and alpha):
//        zero:     Gu = Gv (1 - s) + (Gs - Gv u) g
//        subtract: Gu = Gv (1 - v_th g) + Gs g
//        Gv_{t-1} = tau Gu_t
//      writing g_current = Gu, the lane's g_tau partial (the sum of
//      Gu_t v_{t-1} in descending t; the wrapper sums it over B) and
//      g_v0 = tau Gu_0. v_{t-1} is rebuilt from u_{t-1} and s_{t-1}.
// Both passes run `lane_scan.cuh`'s cp.async ring, as the forward does:
// pass 1 over (I, s) forward, pass 2 over (u, s, Gs) reversed (base at
// t = T - 1, stride -B N: the ring walks any series; a VEC copy is four
// adjacent lanes of one step, so its alignment is the step's, whatever
// the direction).
// Every operation is one rounded fp32 step (__fmul_rn, __fadd_rn,
// __fsub_rn, __fdiv_rn: no contraction into an FMA), the order of
// `lif_scan_bwd_ref`, so the kernel equals it bit for bit for the
// rectangle, triangle and arctan surrogates; sigmoid's expf is within an
// ulp or two of PyTorch's.

#include <cuda_runtime.h>
#include <cstdint>

#include "lane_scan.cuh"
#include "surrogate.cuh"

namespace {

template <bool SUBTRACT, int THREADS, bool VEC>
__global__ void __launch_bounds__(THREADS)
lif_kernel(const float* __restrict__ cur, const float* __restrict__ tau,
           const float* __restrict__ v0, float* __restrict__ spikes,
           float* __restrict__ vT, int T, int B, int N, float v_th) {
  extern __shared__ __align__(16) float ring_smem[];
  const int64_t lanes = (int64_t)B * N;
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= lanes) return;                 // no barrier below: leave
  const float* base[1] = {cur + idx};
  const int64_t stride[1] = {lanes};
  LaneRing<1, THREADS, VEC> ring(ring_smem, base, stride, T);
  const float tn = tau[idx % N];
  float* sp = spikes + idx;
  float v = v0[idx];
  lane_scan(ring, [&](const auto& in, int u) {
    const float w = __fadd_rn(__fmul_rn(tn, v), in[0][u]);
    const float s = set_ge(w, v_th);
    v = SUBTRACT ? __fsub_rn(w, __fmul_rn(v_th, s))
                 : __fmul_rn(w, set_ltu(w, v_th));   // w * (1 - s)
    *sp = s;
    sp += lanes;
  });
  vT[idx] = v;
}

template <bool SUBTRACT>
__device__ __forceinline__ float after_reset(float u, float s, float v_th) {
  return SUBTRACT ? __fsub_rn(u, __fmul_rn(v_th, s))
                  : __fmul_rn(u, __fsub_rn(1.f, s));
}

// Pass 2 walks the series reversed: the ring's base is step T - 1 and its
// stride -lanes, so its first chunk is the last LS_CHUNK steps and the
// partial chunk (if any) holds t = 0. v_{t-1} arrives one step after Gu_t,
// with u_{t-1} and s_{t-1}: Gu_t v_{t-1} is added then, in descending t.
template <int SUR, bool SUBTRACT, int THREADS, bool VEC>
__global__ void __launch_bounds__(THREADS)
lif_bwd_kernel(const float* __restrict__ cur, const float* __restrict__ tau,
               const float* __restrict__ v0, const float* __restrict__ sp,
               const float* __restrict__ gs, const float* __restrict__ gvT,
               float* __restrict__ ubuf, float* __restrict__ gc,
               float* __restrict__ gtau, float* __restrict__ gv0, int T,
               int B, int N, float v_th, float alpha) {
  extern __shared__ __align__(16) float ring_smem[];
  const int64_t lanes = (int64_t)B * N;
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= lanes) return;                 // no barrier below: leave
  const float tn = tau[idx % N];
  const float v_init = v0[idx];
  {  // 1. u forward, along the saved spikes
    const float* base[2] = {cur + idx, sp + idx};
    const int64_t stride[2] = {lanes, lanes};
    LaneRing<2, THREADS, VEC> ring(ring_smem, base, stride, T);
    float v = v_init;
    float* up = ubuf + idx;
    lane_scan(ring, [&](const auto& in, int k) {
      const float u = __fadd_rn(__fmul_rn(tn, v), in[0][k]);
      *up = u;
      up += lanes;
      v = after_reset<SUBTRACT>(u, in[1][k], v_th);
    });
  }
  // VEC: the warp's u stores are read back by its neighbours' copies, and
  // the ring's slots are refilled: every thread is past pass 1
  __threadfence_block();
  if (VEC) __syncwarp();
  {  // 2. the reverse scan
    const int64_t last = (int64_t)(T - 1) * lanes + idx;
    const float* base[3] = {ubuf + last, sp + last, gs + last};
    const int64_t stride[3] = {-lanes, -lanes, -lanes};
    LaneRing<3, THREADS, VEC> ring(ring_smem, base, stride, T);
    float gv = gvT[idx], acc = 0.f, gu_next = 0.f;
    // rectangle: the quotients 1/alpha and 0/alpha, the same bits as the
    // plain version's per-element division
    const float in_win = __fdiv_rn(1.f, alpha), out_win = __fdiv_rn(0.f, alpha);
    bool first = true;
    float* gp = gc + last;
    lane_scan(ring, [&](const auto& in, int k) {
      const float u = in[0][k], s = in[1][k];
      if (!first)                            // Gu_{t+1} v_t
        acc = __fadd_rn(acc,
                        __fmul_rn(gu_next, after_reset<SUBTRACT>(u, s, v_th)));
      first = false;
      float g = surrogate<SUR>(__fsub_rn(u, v_th), alpha);
      if constexpr (SUR == 1) g = g != 0.f ? in_win : out_win;
      const float gu =
          SUBTRACT
              ? __fadd_rn(__fmul_rn(gv, __fsub_rn(1.f, __fmul_rn(v_th, g))),
                          __fmul_rn(in[2][k], g))
              : __fadd_rn(__fmul_rn(gv, __fsub_rn(1.f, s)),
                          __fmul_rn(__fsub_rn(in[2][k], __fmul_rn(gv, u)),
                                    g));
      *gp = gu;
      gp -= lanes;
      gv = __fmul_rn(tn, gu);
      gu_next = gu;
    });
    gtau[idx] = __fadd_rn(acc, __fmul_rn(gu_next, v_init));
    gv0[idx] = gv;
  }
}

}  // namespace

extern "C" {

// The backward of lif_f32 (see above): g_current (T, B, N), the per-lane
// g_tau partials (B, N) and g_v0 (B, N), with u (T, B, N) as scratch.
// surrogate: 0 arctan, 1 rectangle, 2 sigmoid, 3 triangle; stages as
// lif_f32's (`lane_plan`). CTAs of one warp: the lanes of a training step
// are few, and one layout a surrogate and reset keeps the build short. The
// ring holds three planes (pass 2's u, s and Gs; pass 1 uses two).
int lif_bwd_f32(const float* cur, const float* tau, const float* v0,
                const float* spikes, const float* gs, const float* gvT,
                float* ubuf, float* gc, float* gtau, float* gv0, int T, int B,
                int N, float v_th, int subtract, int surrogate, float alpha,
                int stages, void* stream) {
  if (T < 1 || B < 1 || N < 1 || stages != lane_ring_stages(T) ||
      surrogate < 0 || surrogate > 3)
    return (int)cudaErrorInvalidValue;
  const int64_t lanes = (int64_t)B * N;
  const cudaStream_t st = (cudaStream_t)stream;
  // pass 1 copies the current, pass 2 the u scratch, 16 bytes a thread
  const bool vec = lane_vec(cur, lanes) && lane_vec(ubuf, lanes);
  return with_lane_layout(1, vec, [&](auto threads, auto vec_) {
    constexpr int TH = decltype(threads)::value;
    constexpr bool V = decltype(vec_)::value;
    auto go = [&](auto kernel) {
      return launch_lane_scan<TH, 3>(kernel, lanes, stages, st, cur, tau, v0,
                                     spikes, gs, gvT, ubuf, gc, gtau, gv0, T,
                                     B, N, v_th, alpha);
    };
    auto by_reset = [&](auto sur) {
      constexpr int S = decltype(sur)::value;
      return subtract ? go(lif_bwd_kernel<S, true, TH, V>)
                      : go(lif_bwd_kernel<S, false, TH, V>);
    };
    switch (surrogate) {
      case 0:
        return by_reset(std::integral_constant<int, 0>{});
      case 1:
        return by_reset(std::integral_constant<int, 1>{});
      case 2:
        return by_reset(std::integral_constant<int, 2>{});
      default:
        return by_reset(std::integral_constant<int, 3>{});
    }
  });
}

// warps: warps a CTA (1, 2 or 4); stages: the ring's stages, exactly
// lane_ring_stages(T) (`kernels/common.py::lane_plan` computes both).
int lif_f32(const float* cur, const float* tau, const float* v0,
            float* spikes, float* vT, int T, int B, int N, float v_th,
            int subtract, int warps, int stages, void* stream) {
  if (T < 1 || B < 1 || N < 1 || stages != lane_ring_stages(T))
    return (int)cudaErrorInvalidValue;
  const int64_t lanes = (int64_t)B * N;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = lane_vec(cur, lanes);
  return with_lane_layout(warps, vec, [&](auto threads, auto vec_) {
    constexpr int TH = decltype(threads)::value;
    constexpr bool V = decltype(vec_)::value;
    return subtract
               ? launch_lane_scan<TH, 1>(lif_kernel<true, TH, V>, lanes,
                                         stages, s, cur, tau, v0, spikes, vT,
                                         T, B, N, v_th)
               : launch_lane_scan<TH, 1>(lif_kernel<false, TH, V>, lanes,
                                         stages, s, cur, tau, v0, spikes, vT,
                                         T, B, N, v_th);
  });
}

}  // extern "C"
