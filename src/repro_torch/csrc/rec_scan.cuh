// The self-recurrent time scan shared by `lifrec.cu` (LIF, ADAPT = false)
// and `alifrec.cu` (adaptive-threshold LIF, ADAPT = true), for sm_90a.
//
// Per batch row b, neuron j and step t:
//   u  = tau[j] * v + I_t + sum over i with s_{t-1}[i] = 1 of W[i, j]
//   th = v_th            (LIF)
//   th = v_th + beta * a (ALIF);  s_t = [u >= th];  v = u * (1 - s_t)
//   a  = rho[j] * a + s_t (ALIF only)
// Writes the spikes (T, B, N), v_T and, for ALIF, a_T (B, N); s0 (B, N)
// holds the 0/1 spikes of the step before the first.
//
// What bounds it on an H100: neither bytes nor operations but the serial
// chain. Every lane of a batch row needs every lane's previous spike, so
// each step ends in a barrier across the row; a window of T steps is T
// dependent rounds. The TPU kernels keep the whole (N, N) W_rec in VMEM
// and feed s @ W to the MXU each step. Here one block owns one batch row
// (rows are independent, so a row's result never depends on how sessions
// were packed: no split across blocks, no atomics), one thread owns one
// neuron (N <= 1024), and W_rec sits in shared memory when it fits (N up
// to 241 in fp32, with the 227 KB opt-in), else it is read through L2.
// Each step the row's spikes become a bit mask in shared memory (one warp
// ballot per 32 lanes), and every thread adds W[i, j] for the set bits i
// in ascending order: the event-driven recurrence, whose work is
// nnz(s_{t-1}) * N and whose loop is uniform across the block (every
// thread reads the same mask). The mask is double-buffered, so one
// __syncthreads per step suffices; the next step's current is loaded
// before this step's sum.
//
// Rounding: each add and product is __fadd_rn/__fmul_rn/__fsub_rn in the
// plain versions' order, u = ((tau * v) + I) + rec with rec summed from 0
// over ascending i, th = v_th + (beta * a), a = (rho * a) + s. nvcc cannot
// contract them into FMAs, so the kernels equal `kernels/lifrec/ref.py`
// and `kernels/alifrec/ref.py` bit for bit.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int REC_MAX_N = 1024;  // one thread per neuron of a batch row
constexpr unsigned FULL = 0xffffffffu;

struct ScanArgs {
  const float* cur;  // (T, B, N)
  const float* w;    // (N, N); recurrent only
  const float* tau;  // (N,)
  const float* rho;  // (N,); ALIF only
  const float* v0;   // (B, N)
  const float* a0;   // (B, N); ALIF only
  const float* s0;   // (B, N), 0/1; recurrent only
  float* spikes;     // (T, B, N)
  float* vT;         // (B, N)
  float* aT;         // (B, N); ALIF only
  int T, B, N;
  float v_th, beta;
};

// One step of the neuron; u already holds tau * v + I (+ rec).
template <bool ADAPT>
__device__ __forceinline__ float fire(float u, float& v, float& a, float rho,
                                      float v_th, float beta) {
  const float th = ADAPT ? __fadd_rn(v_th, __fmul_rn(beta, a)) : v_th;
  const float s = (u >= th) ? 1.f : 0.f;
  v = __fmul_rn(u, __fsub_rn(1.f, s));
  if (ADAPT) a = __fadd_rn(__fmul_rn(rho, a), s);
  return s;
}

template <bool ADAPT, bool SMEM>
__global__ void __launch_bounds__(REC_MAX_N) rec_scan_kernel(
    const ScanArgs p) {
  extern __shared__ uint32_t smem[];
  const int N = p.N, T = p.T;
  const int words = (N + 31) / 32;  // = warps of the block
  uint32_t* mask = smem;            // [2][words]
  const float* W = p.w;
  if (SMEM) {
    float* ws = reinterpret_cast<float*>(smem + 2 * words);
    for (int e = threadIdx.x; e < N * N; e += blockDim.x) ws[e] = p.w[e];
    W = ws;
  }
  const int j = threadIdx.x;
  const bool in = j < N;
  const int warp = j / 32, lane = j % 32;
  const int64_t row = (int64_t)blockIdx.x * N;
  const int64_t stride_t = (int64_t)p.B * N;

  float v = in ? p.v0[row + j] : 0.f;
  float a = (ADAPT && in) ? p.a0[row + j] : 0.f;
  const float tn = in ? p.tau[j] : 0.f;
  const float rn = (ADAPT && in) ? p.rho[j] : 0.f;
  float c_next = (in && T > 0) ? p.cur[row + j] : 0.f;
  const unsigned bits0 = __ballot_sync(FULL, in && p.s0[row + j] != 0.f);
  if (lane == 0) mask[warp] = bits0;
  __syncthreads();

  int buf = 0;
  for (int t = 0; t < T; ++t) {
    const float c = c_next;
    if (in && t + 1 < T) c_next = p.cur[(t + 1) * stride_t + row + j];
    float rec = 0.f;
    const uint32_t* m = mask + buf * words;
    for (int wi = 0; wi < words; ++wi)
      for (uint32_t bits = m[wi]; bits; bits &= bits - 1)
        if (in)
          rec = __fadd_rn(rec, W[(int64_t)(wi * 32 + __ffs(bits) - 1) * N + j]);
    const float u = __fadd_rn(__fadd_rn(__fmul_rn(tn, v), c), rec);
    const float s = fire<ADAPT>(u, v, a, rn, p.v_th, p.beta);
    if (in) p.spikes[t * stride_t + row + j] = s;
    const unsigned bits = __ballot_sync(FULL, in && s != 0.f);
    if (lane == 0) mask[(buf ^ 1) * words + warp] = bits;
    __syncthreads();
    buf ^= 1;
  }
  if (in) {
    p.vT[row + j] = v;
    if (ADAPT) p.aT[row + j] = a;
  }
}

// Dynamic shared memory of a block: the two spike masks, plus W_rec when
// it fits under the device's opt-in maximum (then `smem_w` is set).
// Returns a CUDA error code, 0 on success.
int plan_smem(int N, int* bytes, bool* smem_w) {
  int dev = 0, optin = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess)
    e = cudaDeviceGetAttribute(&optin,
                               cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (e != cudaSuccess) return (int)e;
  const size_t masks = 2 * sizeof(uint32_t) * ((N + 31) / 32);
  const size_t with_w = masks + sizeof(float) * (size_t)N * N;
  *smem_w = with_w <= (size_t)optin;
  *bytes = (int)(*smem_w ? with_w : masks);
  return 0;
}

// Launch the scan on B blocks of whole warps; returns a CUDA error code.
template <bool ADAPT>
int launch_rec_scan(const ScanArgs& p, cudaStream_t stream) {
  if (p.N > REC_MAX_N) return (int)cudaErrorInvalidValue;
  int smem = 0;
  bool smem_w = false;
  const int err = plan_smem(p.N, &smem, &smem_w);
  if (err) return err;
  const auto kern = smem_w ? rec_scan_kernel<ADAPT, true>
                           : rec_scan_kernel<ADAPT, false>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<p.B, (p.N + 31) / 32 * 32, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

}  // namespace
