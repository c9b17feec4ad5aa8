// Fused recurrent leaky integrate-and-fire over time (DIFF + LOCACC(self) +
// threshold + SEND) for sm_90a: the scan of `rec_scan.cuh` with the fixed
// threshold v_th.
//
// Replaces: src/repro/kernels/lifrec/kernel.py::lifrec_pallas
//           (body `_lifrec_kernel`).
//
// Also exports the query of the recurrent scan that `lifrec` and `alifrec`
// share: whether the block route keeps an (N, N) W_rec in shared memory.

#include "rec_scan.cuh"

extern "C" {

// On the block route: 1 when W_rec (N, N) is held in shared memory, 0 when
// it is read through L2, a negative CUDA error code when the device cannot
// be queried. (The warp route always holds it in shared memory.)
int rec_scan_w_in_smem(int N) {
  int bytes = 0;
  bool smem_w = false;
  const int err = plan_smem(N, &bytes, &smem_w);
  return err ? -err : (int)smem_w;
}

int lifrec_f32(const float* cur, const float* w, const float* tau,
               const float* v0, const float* s0, float* spikes, float* vT,
               int T, int B, int N, float v_th, int warp, void* stream) {
  // no adaptation: no rho, a0 or a_T
  const ScanArgs p{cur, w,  tau,     nullptr, v0,   nullptr, s0, spikes,
                   vT,  nullptr, T, B, N,  v_th, 0.f};
  return launch_rec_scan<false>(p, warp != 0, (cudaStream_t)stream);
}

}  // extern "C"
