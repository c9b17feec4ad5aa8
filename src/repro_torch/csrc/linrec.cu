// Diagonal linear recurrence (the DIFF instruction) for sm_90a.
//
// Replaces: src/repro/kernels/linrec/kernel.py::linrec_pallas
//           (body `_linrec_kernel`).
//
// Computes y_t = a_t * y_{t-1} + x_t over the leading time axis of a
// (T, B, D) tensor, from h0 (B, D); writes y (T, B, D) and h_T (B, D).
//
// What bounds it on an H100. It does 2 FLOP per element and moves at
// least 8 bytes per element (x in, y out), far below the fp32 ridge, so
// its bound is the bytes. But its real calls are small: the SHD window's
// DH-LIF branches are 16384 lanes of 32 steps (2 MB), a learning run's
// trace scans 2048 and 1024 lanes of 300 steps, a readout 20 or 6 lanes a
// row. There the time is the serial chain of each lane (T dependent
// updates) and the memory round trips it waits on. The TPU kernel runs a
// Hillis-Steele scan inside each time chunk because a TPU grid is
// sequential and the scan is its only parallelism. Here the B * D lanes
// are the parallelism: one thread owns one (b, d) lane, holds its state in
// a register and walks T serially.
//
// Design. The thread's x (and a, where a has a time stride) reach it through
// `lane_scan.cuh`'s ring: chunks of LS_CHUNK steps copied by cp.async into
// shared memory, LS_STAGES - 1 of them in flight while the chain runs over the
// oldest, so in steady state a step costs its dependent product and sum, a
// shared load, a store that does not block and a copy, issued in the chain's
// gaps. A warp owns 32 adjacent lanes, so each step is one coalesced 128-byte
// store a warp and one 128-byte copy, or a quarter of a 512-byte one where the
// rows are whole warps (x then goes 16 bytes a thread, four steps a copy). The
// wrapper sizes the CTA from the lanes (one to four warps,
// `kernels/common.py::lane_plan`), so that a few thousand lanes spread over as
// many SMs as they have warps and 16384 over all 132.
//
// The decay `a` is read through explicit element strides, so a per-neuron
// decay broadcast over T and B (stride 0) is read as the small tensor it
// is and never materialised at (T, B, D). With a time stride of 0 it stays
// in a register; with another it is a second plane of the ring.
//
// Rounding: each step is __fadd_rn(__fmul_rn(a, h), x), a rounded product
// and then a rounded sum in ascending t, exactly what the plain PyTorch
// version (`a[t] * h + x[t]`, two ops) computes. nvcc would otherwise
// contract it into one FMA and the kernel would differ from its plain
// version in the last bit. No chunked or parallel scan: that would change
// the rounding.
//
// The backward (B2) is `linrec_bwd.cu`'s kernel.

#include <cuda_runtime.h>
#include <cstdint>

#include "lane_scan.cuh"

namespace {

template <bool A_PLANE, int THREADS, bool VEC>
__global__ void __launch_bounds__(THREADS)
linrec_kernel(const float* __restrict__ a, int64_t sa_t, int64_t sa_b,
              int64_t sa_d, const float* __restrict__ x,
              const float* __restrict__ h0, float* __restrict__ y,
              float* __restrict__ hT, int T, int B, int D) {
  extern __shared__ __align__(16) float ring_smem[];
  constexpr int NP = A_PLANE ? 2 : 1;       // x, and a where it varies in t
  const int64_t lanes = (int64_t)B * D;
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= lanes) return;                 // no barrier below: leave
  const int64_t b = idx / D, d = idx % D;
  const float* ap = a + b * sa_b + d * sa_d;
  const float* base[NP];
  int64_t stride[NP];
  base[0] = x + idx;
  stride[0] = lanes;
  if constexpr (A_PLANE) {
    base[NP - 1] = ap;
    stride[NP - 1] = sa_t;
  }
  LaneRing<NP, THREADS, VEC> ring(ring_smem, base, stride, T);
  const float a0 = A_PLANE ? 0.f : *ap;
  float* yp = y + idx;
  float h = h0[idx];
  lane_scan(ring, [&](const auto& in, int u) {
    h = __fadd_rn(__fmul_rn(A_PLANE ? in[NP - 1][u] : a0, h), in[0][u]);
    *yp = h;
    yp += lanes;
  });
  hT[idx] = h;
}

}  // namespace

extern "C" {

// warps: warps a CTA (1, 2 or 4); stages: the ring's stages, exactly
// lane_ring_stages(T) (`kernels/common.py::lane_plan` computes both).
int linrec_f32(const float* a, int64_t sa_t, int64_t sa_b, int64_t sa_d,
               const float* x, const float* h0, float* y, float* hT, int T,
               int B, int D, int warps, int stages, void* stream) {
  if (T < 1 || B < 1 || D < 1 || stages != lane_ring_stages(T))
    return (int)cudaErrorInvalidValue;
  const int64_t lanes = (int64_t)B * D;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = lane_vec(x, lanes);
  return with_lane_layout(warps, vec, [&](auto threads, auto vec_) {
    constexpr int TH = decltype(threads)::value;
    constexpr bool V = decltype(vec_)::value;
    return sa_t != 0
               ? launch_lane_scan<TH, 2>(linrec_kernel<true, TH, V>, lanes,
                                         stages, s, a, sa_t, sa_b, sa_d, x,
                                         h0, y, hT, T, B, D)
               : launch_lane_scan<TH, 1>(linrec_kernel<false, TH, V>, lanes,
                                         stages, s, a, sa_t, sa_b, sa_d, x,
                                         h0, y, hT, T, B, D);
  });
}

}  // extern "C"
