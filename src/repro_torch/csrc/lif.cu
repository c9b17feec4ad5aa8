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
// What bounds it on an H100: the bytes. A handful of FLOP per element
// against 8 bytes per element (current in, spike out). The reset makes the
// recurrence non-associative, so time stays serial. The TPU kernel keeps a
// (ct, bb, bn) current block in VMEM and carries v across a sequential
// grid; here one thread owns one (b, n) lane with v in a register, the
// B * N lanes run in parallel, loads and stores are coalesced along n, and
// the currents of 8 steps are loaded before the 8 dependent updates.
//
// Rounding: __fadd_rn(__fmul_rn(tau, v), I) is a rounded product then a
// rounded sum, exactly what the plain PyTorch version computes. A fused
// multiply-add would differ by one ulp now and then, and at the threshold
// one ulp flips a spike.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

__device__ __forceinline__ float lif_step(float tau, float& v, float cur,
                                          float v_th, int subtract) {
  v = __fadd_rn(__fmul_rn(tau, v), cur);
  const float s = (v >= v_th) ? 1.f : 0.f;
  v = subtract ? __fsub_rn(v, __fmul_rn(v_th, s))
               : __fmul_rn(v, __fsub_rn(1.f, s));
  return s;
}

__global__ void __launch_bounds__(THREADS)
lif_kernel(const float* __restrict__ cur, const float* __restrict__ tau,
           const float* __restrict__ v0, float* __restrict__ spikes,
           float* __restrict__ vT, int T, int B, int N, float v_th,
           int subtract) {
  const int64_t lanes = (int64_t)B * N;
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= lanes) return;
  const float tn = tau[idx % N];
  const float* cp = cur + idx;
  float* sp = spikes + idx;
  float v = v0[idx];

  int t = 0;
  for (; t + UNROLL <= T; t += UNROLL) {
    float cv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) cv[u] = cp[(int64_t)(t + u) * lanes];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u)
      sp[(int64_t)(t + u) * lanes] = lif_step(tn, v, cv[u], v_th, subtract);
  }
  for (; t < T; ++t)
    sp[(int64_t)t * lanes] =
        lif_step(tn, v, cp[(int64_t)t * lanes], v_th, subtract);
  vT[idx] = v;
}

}  // namespace

extern "C" {

int lif_f32(const float* cur, const float* tau, const float* v0,
            float* spikes, float* vT, int T, int B, int N, float v_th,
            int subtract, void* stream) {
  const int64_t lanes = (int64_t)B * N;
  const int blocks = (int)((lanes + THREADS - 1) / THREADS);
  lif_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      cur, tau, v0, spikes, vT, T, B, N, v_th, subtract);
  return (int)cudaGetLastError();
}

}  // extern "C"
