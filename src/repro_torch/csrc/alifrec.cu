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
// alif (feed-forward), like `lif.cu`: bounded by the bytes, 8 per lane-step
// (current in, spike out) against a handful of FLOP; the reset makes time
// serial. One thread owns one (b, n) lane with v and a in registers, the
// B * N lanes run in parallel, loads and stores are coalesced along n, and
// the currents of 8 steps are loaded before the 8 dependent updates.
//
// alifrec (self-recurrent): the scan of `rec_scan.cuh` with the moving
// threshold, one block per batch row.
//
// Rounding: every product and sum is __fmul_rn/__fadd_rn/__fsub_rn in the
// plain version's order (`kernels/alifrec/ref.py`), so both kernels equal
// their plain versions bit for bit.

#include "rec_scan.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

__global__ void __launch_bounds__(THREADS) alif_kernel(const ScanArgs p) {
  const int64_t lanes = (int64_t)p.B * p.N;
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= lanes) return;
  const int n = (int)(idx % p.N);
  const float tn = p.tau[n], rn = p.rho[n];
  const float* cp = p.cur + idx;
  float* sp = p.spikes + idx;
  float v = p.v0[idx], a = p.a0[idx];

  int t = 0;
  for (; t + UNROLL <= p.T; t += UNROLL) {
    float cv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) cv[u] = cp[(int64_t)(t + u) * lanes];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      sp[(int64_t)(t + u) * lanes] = fire<true>(
          __fadd_rn(__fmul_rn(tn, v), cv[u]), v, a, rn, p.v_th, p.beta);
  }
  for (; t < p.T; ++t)
    sp[(int64_t)t * lanes] =
        fire<true>(__fadd_rn(__fmul_rn(tn, v), cp[(int64_t)t * lanes]), v,
                   a, rn, p.v_th, p.beta);
  p.vT[idx] = v;
  p.aT[idx] = a;
}

}  // namespace

extern "C" {

int alif_f32(const float* cur, const float* tau, const float* rho,
             const float* v0, const float* a0, float* spikes, float* vT,
             float* aT, int T, int B, int N, float v_th, float beta,
             void* stream) {
  const ScanArgs p{cur, nullptr, tau, rho, v0, a0, nullptr, spikes, vT, aT,
                   T, B, N, v_th, beta};
  const int64_t lanes = (int64_t)B * N;
  const int blocks = (int)((lanes + THREADS - 1) / THREADS);
  alif_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}

int alifrec_f32(const float* cur, const float* w, const float* tau,
                const float* rho, const float* v0, const float* a0,
                const float* s0, float* spikes, float* vT, float* aT, int T,
                int B, int N, float v_th, float beta, void* stream) {
  const ScanArgs p{cur, w, tau, rho, v0, a0, s0, spikes, vT, aT,
                   T, B, N, v_th, beta};
  return launch_rec_scan<true>(p, (cudaStream_t)stream);
}

}  // extern "C"
