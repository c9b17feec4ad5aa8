// Fused recurrent leaky integrate-and-fire over time (DIFF + LOCACC(self) +
// threshold + SEND) for sm_90a: the scan of `rec_scan.cuh` with the fixed
// threshold v_th.
//
// Replaces: src/repro/kernels/lifrec/kernel.py::lifrec_pallas
//           (body `_lifrec_kernel`).
//
// Also exports the two queries of the recurrent scan that `lifrec` and
// `alifrec` share: the most neurons a batch row may hold, and whether an
// (N, N) W_rec is kept in shared memory.

#include "rec_scan.cuh"

extern "C" {

int rec_scan_max_n() { return REC_MAX_N; }

// 1 when W_rec (N, N) is held in shared memory, 0 when it is read through
// L2, a negative CUDA error code when the device cannot be queried.
int rec_scan_w_in_smem(int N) {
  int bytes = 0;
  bool smem_w = false;
  const int err = plan_smem(N, &bytes, &smem_w);
  return err ? -err : (int)smem_w;
}

int lifrec_f32(const float* cur, const float* w, const float* tau,
               const float* v0, const float* s0, float* spikes, float* vT,
               int T, int B, int N, float v_th, void* stream) {
  // no adaptation: no rho, a0 or a_T
  const ScanArgs p{cur, w,  tau,     nullptr, v0,   nullptr, s0, spikes,
                   vT,  nullptr, T, B, N,  v_th, 0.f};
  return launch_rec_scan<false>(p, (cudaStream_t)stream);
}

}  // extern "C"
