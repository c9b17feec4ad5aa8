// Diagonal linear recurrence (the DIFF instruction) for sm_90a.
//
// Replaces: src/repro/kernels/linrec/kernel.py::linrec_pallas
//           (body `_linrec_kernel`).
//
// Computes y_t = a_t * y_{t-1} + x_t over the leading time axis of a
// (T, B, D) tensor, from h0 (B, D); writes y (T, B, D) and h_T (B, D).
//
// What bounds it on an H100: the bytes. It does 2 FLOP per element and
// moves at least 8 bytes per element (x in, y out), far below the fp32
// ridge. The TPU kernel runs a Hillis-Steele scan inside each time chunk
// because a TPU grid is sequential and the scan is its only parallelism.
// Here the B * D lanes are the parallelism: one thread owns one (b, d)
// lane, holds its state in a register and walks T serially. Loads and
// stores are coalesced along d. The x and a loads of 8 steps are issued
// before the 8 dependent updates, so the serial chain does not wait on
// device memory once per step.
//
// The decay `a` is read through explicit element strides, so a per-neuron
// decay broadcast over T and B (stride 0) is read as the small tensor it
// is and never materialised at (T, B, D).
//
// Rounding: each step is __fadd_rn(__fmul_rn(a, h), x), a rounded product
// and then a rounded sum, exactly what the plain PyTorch version
// (`a[t] * h + x[t]`, two ops) computes. nvcc would otherwise contract it
// into one FMA and the kernel would differ from its plain version in the
// last bit.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 8;

__global__ void __launch_bounds__(THREADS)
linrec_kernel(const float* __restrict__ a, int64_t sa_t, int64_t sa_b,
              int64_t sa_d, const float* __restrict__ x,
              const float* __restrict__ h0, float* __restrict__ y,
              float* __restrict__ hT, int T, int B, int D) {
  const int64_t lanes = (int64_t)B * D;
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= lanes) return;
  const int64_t b = idx / D, d = idx % D;
  const float* ap = a + b * sa_b + d * sa_d;
  const float* xp = x + idx;
  float* yp = y + idx;
  float h = h0[idx];

  int t = 0;
  for (; t + UNROLL <= T; t += UNROLL) {
    float av[UNROLL], xv[UNROLL];
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      av[u] = ap[(int64_t)(t + u) * sa_t];
      xv[u] = xp[(int64_t)(t + u) * lanes];
    }
#pragma unroll
    for (int u = 0; u < UNROLL; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), xv[u]);
      yp[(int64_t)(t + u) * lanes] = h;
    }
  }
  for (; t < T; ++t) {
    h = __fadd_rn(__fmul_rn(ap[(int64_t)t * sa_t], h), xp[(int64_t)t * lanes]);
    yp[(int64_t)t * lanes] = h;
  }
  hT[idx] = h;
}

}  // namespace

extern "C" {

int linrec_f32(const float* a, int64_t sa_t, int64_t sa_b, int64_t sa_d,
               const float* x, const float* h0, float* y, float* hT, int T,
               int B, int D, void* stream) {
  const int64_t lanes = (int64_t)B * D;
  const int blocks = (int)((lanes + THREADS - 1) / THREADS);
  linrec_kernel<<<blocks, THREADS, 0, (cudaStream_t)stream>>>(
      a, sa_t, sa_b, sa_d, x, h0, y, hT, T, B, D);
  return (int)cudaGetLastError();
}

}  // extern "C"
