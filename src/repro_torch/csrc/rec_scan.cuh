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
// were packed: no split across blocks, no atomics). A block has at most
// 1024 threads, so each thread owns NPT neurons of the row, j, j + blockDim,
// j + 2 blockDim, ... (NPT = 1 up to 1024 neurons, the smallest power of
// two that covers the row above; the launcher instantiates NPT up to 256,
// past the largest W_rec a card's memory holds), with their state in
// registers up to NPT = 8. W_rec sits in shared memory when it fits (N up
// to 241 in fp32, with the 227 KB opt-in), else it is read through L2.
// Each step the row's spikes become a bit mask over all N in shared memory
// (one warp ballot per 32 neurons), and every thread adds W[i, j] for the
// set bits i in ascending order to each neuron it owns: the event-driven
// recurrence, whose work is nnz(s_{t-1}) * N and whose loop is uniform
// across the block (every thread reads the same mask). The mask is
// double-buffered, so one __syncthreads per step suffices; the next step's
// current is loaded before this step's sum.
//
// Rounding: each add and product is __fadd_rn/__fmul_rn/__fsub_rn in the
// plain versions' order, u = ((tau * v) + I) + rec with rec summed from 0
// over ascending i, th = v_th + (beta * a), a = (rho * a) + s. nvcc cannot
// contract them into FMAs, and a neuron's arithmetic does not depend on
// which thread owns it, so the kernels equal `kernels/lifrec/ref.py` and
// `kernels/alifrec/ref.py` bit for bit at every N.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int REC_THREADS = 1024;  // most threads a block may have
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

// Thread x owns neurons x + r * blockDim.x, r < NPT. Warp w's 32 neurons
// of round r fill mask word r * (blockDim.x / 32) + w, which exists when
// the round's first neuron does.
template <bool ADAPT, bool SMEM, int NPT>
__global__ void __launch_bounds__(REC_THREADS) rec_scan_kernel(
    const ScanArgs p) {
  extern __shared__ uint32_t smem[];
  const int N = p.N, T = p.T;
  const int words = (N + 31) / 32;
  const int wpb = blockDim.x / 32;  // warps per block
  uint32_t* mask = smem;            // [2][words]
  const float* W = p.w;
  if (SMEM) {
    float* ws = reinterpret_cast<float*>(smem + 2 * words);
    for (int e = threadIdx.x; e < N * N; e += blockDim.x) ws[e] = p.w[e];
    W = ws;
  }
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int64_t row = (int64_t)blockIdx.x * N;
  const int64_t stride_t = (int64_t)p.B * N;

  // the loops over the owned neurons unroll up to 8 a thread, so their
  // state stays in registers; wider rows keep it in (cached) local memory
  int j[NPT];
  bool in[NPT];
  float v[NPT], a[NPT], tn[NPT], rn[NPT], c_next[NPT];
#pragma unroll(NPT <= 8 ? NPT : 1)
  for (int r = 0; r < NPT; ++r) {
    j[r] = r * (int)blockDim.x + (int)threadIdx.x;
    in[r] = j[r] < N;
    v[r] = in[r] ? p.v0[row + j[r]] : 0.f;
    a[r] = (ADAPT && in[r]) ? p.a0[row + j[r]] : 0.f;
    tn[r] = in[r] ? p.tau[j[r]] : 0.f;
    rn[r] = (ADAPT && in[r]) ? p.rho[j[r]] : 0.f;
    c_next[r] = (in[r] && T > 0) ? p.cur[row + j[r]] : 0.f;
  }
#pragma unroll(NPT <= 8 ? NPT : 1)
  for (int r = 0; r < NPT; ++r) {
    const unsigned bits0 =
        __ballot_sync(FULL, in[r] && p.s0[row + j[r]] != 0.f);
    if (lane == 0 && (r * wpb + warp) * 32 < N) mask[r * wpb + warp] = bits0;
  }
  __syncthreads();

  int buf = 0;
  for (int t = 0; t < T; ++t) {
    float c[NPT], rec[NPT];
#pragma unroll(NPT <= 8 ? NPT : 1)
    for (int r = 0; r < NPT; ++r) {
      c[r] = c_next[r];
      if (in[r] && t + 1 < T)
        c_next[r] = p.cur[(t + 1) * stride_t + row + j[r]];
      rec[r] = 0.f;
    }
    const uint32_t* m = mask + buf * words;
    for (int wi = 0; wi < words; ++wi)
      for (uint32_t bits = m[wi]; bits; bits &= bits - 1) {
        const float* wrow = W + (int64_t)(wi * 32 + __ffs(bits) - 1) * N;
#pragma unroll(NPT <= 8 ? NPT : 1)
        for (int r = 0; r < NPT; ++r)
          if (in[r]) rec[r] = __fadd_rn(rec[r], wrow[j[r]]);
      }
#pragma unroll(NPT <= 8 ? NPT : 1)
    for (int r = 0; r < NPT; ++r) {
      const float u =
          __fadd_rn(__fadd_rn(__fmul_rn(tn[r], v[r]), c[r]), rec[r]);
      const float s = fire<ADAPT>(u, v[r], a[r], rn[r], p.v_th, p.beta);
      if (in[r]) p.spikes[t * stride_t + row + j[r]] = s;
      const unsigned bits = __ballot_sync(FULL, in[r] && s != 0.f);
      if (lane == 0 && (r * wpb + warp) * 32 < N)
        mask[(buf ^ 1) * words + r * wpb + warp] = bits;
    }
    __syncthreads();
    buf ^= 1;
  }
#pragma unroll(NPT <= 8 ? NPT : 1)
  for (int r = 0; r < NPT; ++r)
    if (in[r]) {
      p.vT[row + j[r]] = v[r];
      if (ADAPT) p.aT[row + j[r]] = a[r];
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

// Launch kernel `kern` on B blocks of `threads` threads (whole warps).
template <typename K>
int launch_kernel(K kern, const ScanArgs& p, int threads, int smem,
                  cudaStream_t stream) {
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<p.B, threads, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// The instantiation that owns NPT neurons a thread, or the next wider one.
template <bool ADAPT, int NPT>
int launch_npt(const ScanArgs& p, int smem, cudaStream_t stream) {
  if constexpr (NPT < 256) {
    if ((int64_t)NPT * REC_THREADS < p.N)
      return launch_npt<ADAPT, 2 * NPT>(p, smem, stream);
  } else if ((int64_t)NPT * REC_THREADS < p.N) {
    return (int)cudaErrorInvalidValue;  // W_rec alone would be 275 GB
  }
  const int per = (p.N + NPT - 1) / NPT;
  return launch_kernel(rec_scan_kernel<ADAPT, false, NPT>, p,
                       (per + 31) / 32 * 32, smem, stream);
}

// Launch the scan on B blocks; returns a CUDA error code.
template <bool ADAPT>
int launch_rec_scan(const ScanArgs& p, cudaStream_t stream) {
  int smem = 0;
  bool smem_w = false;
  const int err = plan_smem(p.N, &smem, &smem_w);
  if (err) return err;
  if (smem_w)  // N <= 241: one neuron a thread
    return launch_kernel(rec_scan_kernel<ADAPT, true, 1>, p,
                         (p.N + 31) / 32 * 32, smem, stream);
  return launch_npt<ADAPT, 1>(p, smem, stream);
}

}  // namespace
