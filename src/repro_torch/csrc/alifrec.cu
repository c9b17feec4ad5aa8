// Fused adaptive-threshold leaky integrate-and-fire over time (DIFF +
// moving threshold + SEND, and the self-recurrent LOCACC) for sm_90a.
//
// Replaces: src/repro/kernels/alifrec/kernel.py::alif_pallas
//           (body `_alif_kernel`) and ::alifrec_pallas
//           (body `_alifrec_kernel`).
//
// Per (b, n) lane and step t:
//   u  = tau[n] * v + I_t  [+ sum over i with s_{t-1}[i] = 1 of W[i, n]]
//   th = v_th + beta * a;  s_t = [u >= th]
//   v  = u * (1 - s_t);    a = rho[n] * a + s_t
// Writes the spikes (T, B, N), v_T and a_T (B, N).
//
// alif (feed-forward): `lif.cu`'s design. Bounded by the bytes, 8 per
// lane-step (current in, spike out) against a handful of FLOP, but its
// calls (alif_ff's 4096 lanes of 250 steps) are a serial chain a lane:
// the reset makes time serial. One thread owns one (b, n) lane with v and
// a in registers, tau and rho too; the current reaches the chain through
// `lane_scan.cuh`'s cp.async ring, and the spike is stored every step,
// coalesced across the warp; CTAs of one to four warps from
// `kernels/common.py::lane_plan`. A step's chain is the membrane's
// product and sum and the threshold's product and sum, side by side, then
// the compare, which gives s and 1 - s as values (`set_ge`, `set_ltu`),
// and the reset and a = rho * a + s.
//
// alifrec (self-recurrent): the scan of `rec_scan.cuh` with the moving
// threshold: a warp per batch row up to 32 * REC_LANE_NEURONS neurons, a
// block per batch row above.
//
// Rounding: every product and sum is __fmul_rn/__fadd_rn/__fsub_rn in the
// plain version's order (`kernels/alifrec/ref.py`), so both kernels equal
// their plain versions bit for bit, signs of zeros included (s and 1 - s
// are exactly 1.0 or 0.0).

#include "lane_scan.cuh"
#include "rec_scan.cuh"

namespace {

template <int THREADS, bool VEC>
__global__ void __launch_bounds__(THREADS)
alif_kernel(const float* __restrict__ cur, const float* __restrict__ tau,
            const float* __restrict__ rho, const float* __restrict__ v0,
            const float* __restrict__ a0, float* __restrict__ spikes,
            float* __restrict__ vT, float* __restrict__ aT, int T, int B,
            int N, float v_th, float beta) {
  extern __shared__ __align__(16) float ring_smem[];
  const int64_t lanes = (int64_t)B * N;
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= lanes) return;                 // no barrier below: leave
  const float* base[1] = {cur + idx};
  const int64_t stride[1] = {lanes};
  LaneRing<1, THREADS, VEC> ring(ring_smem, base, stride, T);
  const int n = (int)(idx % N);
  const float tn = tau[n], rn = rho[n];
  float* sp = spikes + idx;
  float v = v0[idx], a = a0[idx];
  lane_scan(ring, [&](const auto& in, int u) {
    const float w = __fadd_rn(__fmul_rn(tn, v), in[0][u]);
    const float th = __fadd_rn(v_th, __fmul_rn(beta, a));
    const float s = set_ge(w, th);
    v = __fmul_rn(w, set_ltu(w, th));       // w * (1 - s)
    a = __fadd_rn(__fmul_rn(rn, a), s);
    *sp = s;
    sp += lanes;
  });
  vT[idx] = v;
  aT[idx] = a;
}

}  // namespace

extern "C" {

// warps: warps a CTA (1, 2 or 4); stages: the ring's stages, exactly
// lane_ring_stages(T) (`kernels/common.py::lane_plan` computes both).
int alif_f32(const float* cur, const float* tau, const float* rho,
             const float* v0, const float* a0, float* spikes, float* vT,
             float* aT, int T, int B, int N, float v_th, float beta,
             int warps, int stages, void* stream) {
  if (T < 1 || B < 1 || N < 1 || stages != lane_ring_stages(T))
    return (int)cudaErrorInvalidValue;
  const int64_t lanes = (int64_t)B * N;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = lane_vec(cur, lanes);
  return with_lane_layout(warps, vec, [&](auto threads, auto vec_) {
    constexpr int TH = decltype(threads)::value;
    constexpr bool V = decltype(vec_)::value;
    return launch_lane_scan<TH, 1>(alif_kernel<TH, V>, lanes, stages, s, cur,
                                   tau, rho, v0, a0, spikes, vT, aT, T, B,
                                   N, v_th, beta);
  });
}

int alifrec_f32(const float* cur, const float* w, const float* tau,
                const float* rho, const float* v0, const float* a0,
                const float* s0, float* spikes, float* vT, float* aT, int T,
                int B, int N, float v_th, float beta, int warp, int unit,
                int smem_w, void* stream) {
  const ScanArgs p{cur, w, tau, rho, v0, a0, s0, spikes, vT, aT,
                   T, B, N, v_th, beta};
  return launch_rec_scan<true>(p, warp != 0, unit, smem_w != 0,
                               (cudaStream_t)stream);
}

}  // extern "C"
