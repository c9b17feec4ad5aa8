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
// The backward kernel (B2, `linrec_bwd_f32`) is the reverse-time adjoint
// of the JAX package's custom VJP (`repro/kernels/linrec/ops.py::_bwd`):
//   gy_{T-1} += g_hT;  gx_t = a_{t+1} gx_{t+1} + gy_t (a_T = 0, from 0);
//   ga_t = gx_t y_{t-1} (y_{-1} = h0);  gh0 = gx_0 a_0.
// One thread a lane again, walking t = T-1 ... 0 and writing gx, ga and
// gh0 in the same walk; `a` comes by its strides as above. The steps are
// staged by the forward's cp.async ring (`lane_scan.cuh`) walking the
// series reversed: each plane's base is its step T - 1 and its stride
// negative, so the ring's first chunk is the last LS_CHUNK steps and the
// partial one holds t = 0; a VEC copy is four adjacent lanes of one step,
// aligned as that step is, whatever the direction.
// The same rounded product and sum a step, so it equals `linrec_bwd_ref`
// bit for bit, and its gx equals the forward kernel run on the
// time-reversed, one-shifted decay.

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

// The reverse walk: the ring's planes are Gy, then a (where it has a time
// stride), then y (where g_a is asked for), each based at t = T - 1 with a
// negative stride. y_t arrives at step t, one step after gx_{t+1}: g_a_{t+1}
// = gx_{t+1} y_t is written then, and g_a_0 = gx_0 h0 after the walk.
template <bool A_PLANE, bool GA, int THREADS, bool VEC>
__global__ void __launch_bounds__(THREADS)
linrec_bwd_kernel(const float* __restrict__ a, int64_t sa_t, int64_t sa_b,
                  int64_t sa_d, const float* __restrict__ y,
                  const float* __restrict__ h0, const float* __restrict__ gy,
                  const float* __restrict__ ghT, float* __restrict__ gx,
                  float* __restrict__ ga, float* __restrict__ gh0, int T,
                  int B, int D) {
  extern __shared__ __align__(16) float ring_smem[];
  constexpr int PA = 1, PY = A_PLANE ? 2 : 1;
  constexpr int NP = 1 + (A_PLANE ? 1 : 0) + (GA ? 1 : 0);
  const int64_t lanes = (int64_t)B * D;
  const int64_t idx = (int64_t)blockIdx.x * THREADS + threadIdx.x;
  if (idx >= lanes) return;                 // no barrier below: leave
  const int64_t b = idx / D, d = idx % D;
  const float* ap = a + b * sa_b + d * sa_d;
  const int64_t last = (int64_t)(T - 1) * lanes + idx;
  const float* base[NP];
  int64_t stride[NP];
  base[0] = gy + last;
  stride[0] = -lanes;
  if constexpr (A_PLANE) {
    base[PA] = ap + (int64_t)(T - 1) * sa_t;
    stride[PA] = -sa_t;
  }
  if constexpr (GA) {
    base[PY] = y + last;
    stride[PY] = -lanes;
  }
  LaneRing<NP, THREADS, VEC> ring(ring_smem, base, stride, T);
  const float a_const = A_PLANE ? 0.f : *ap;
  const float g_last = ghT[idx];
  float g = 0.f, a_next = 0.f;
  bool first = true;
  int64_t gi = last;                        // gx_t's element
  lane_scan(ring, [&](const auto& in, int k) {
    if constexpr (GA) {
      if (!first) ga[gi + lanes] = __fmul_rn(g, in[PY][k]);
    }
    const float gyt = first ? __fadd_rn(in[0][k], g_last) : in[0][k];
    first = false;
    g = __fadd_rn(__fmul_rn(a_next, g), gyt);
    gx[gi] = g;
    gi -= lanes;
    if constexpr (A_PLANE) {
      a_next = in[PA][k];
    } else {
      a_next = a_const;
    }
  });
  if constexpr (GA) ga[idx] = __fmul_rn(g, h0[idx]);
  if (gh0 != nullptr) gh0[idx] = __fmul_rn(g, a_next);
}

}  // namespace

extern "C" {

// The backward of linrec_f32 (see above): gx (T, B, D); ga (T, B, D) where
// not null (then y and h0 are read), gh0 (B, D) where not null. stages as
// linrec_f32's (`lane_plan`); CTAs of one warp.
int linrec_bwd_f32(const float* a, int64_t sa_t, int64_t sa_b, int64_t sa_d,
                   const float* y, const float* h0, const float* gy,
                   const float* ghT, float* gx, float* ga, float* gh0, int T,
                   int B, int D, int stages, void* stream) {
  if (T < 1 || B < 1 || D < 1 || stages != lane_ring_stages(T))
    return (int)cudaErrorInvalidValue;
  const int64_t lanes = (int64_t)B * D;
  const cudaStream_t s = (cudaStream_t)stream;
  const bool vec = lane_vec(gy, lanes);
  return with_lane_layout(1, vec, [&](auto threads, auto vec_) {
    constexpr int TH = decltype(threads)::value;
    constexpr bool V = decltype(vec_)::value;
    auto go = [&](auto kernel, auto planes) {
      constexpr int NP = decltype(planes)::value;
      return launch_lane_scan<TH, NP>(kernel, lanes, stages, s, a, sa_t, sa_b,
                                      sa_d, y, h0, gy, ghT, gx, ga, gh0, T, B,
                                      D);
    };
    using P1 = std::integral_constant<int, 1>;
    using P2 = std::integral_constant<int, 2>;
    using P3 = std::integral_constant<int, 3>;
    if (sa_t != 0)
      return ga ? go(linrec_bwd_kernel<true, true, TH, V>, P3{})
                : go(linrec_bwd_kernel<true, false, TH, V>, P2{});
    return ga ? go(linrec_bwd_kernel<false, true, TH, V>, P2{})
              : go(linrec_bwd_kernel<false, false, TH, V>, P1{});
  });
}

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
