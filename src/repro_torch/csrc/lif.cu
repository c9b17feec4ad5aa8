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
// The backward (B1, `lif_bwd_f32`) is `lif_bwd.cu`.

#include <cuda_runtime.h>
#include <cstdint>

#include "lane_scan.cuh"

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

}  // namespace

extern "C" {

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
