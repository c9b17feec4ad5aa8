// Fused recurrent leaky integrate-and-fire over time (DIFF + LOCACC(self) +
// threshold + SEND) for sm_90a: the scan of `rec_scan.cuh` with the fixed
// threshold v_th.
//
// Replaces: src/repro/kernels/lifrec/kernel.py::lifrec_pallas
//           (body `_lifrec_kernel`).
//
// The launch geometry (route, neurons a lane or a thread, W_rec in shared
// memory or not) is `kernels/common.py::rec_plan`'s, passed down.

#include "rec_scan.cuh"

extern "C" {

int lifrec_f32(const float* cur, const float* w, const float* tau,
               const float* v0, const float* s0, float* spikes, float* vT,
               int T, int B, int N, float v_th, int warp, int unit,
               int smem_w, void* stream) {
  // no adaptation: no rho, a0 or a_T
  const ScanArgs p{cur, w,  tau,     nullptr, v0,   nullptr, s0, spikes,
                   vT,  nullptr, T, B, N,  v_th, 0.f};
  return launch_rec_scan<false>(p, warp != 0, unit, smem_w != 0,
                                (cudaStream_t)stream);
}

}  // extern "C"
