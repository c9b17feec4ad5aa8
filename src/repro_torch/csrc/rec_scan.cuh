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
// each step ends in an exchange across the row; a window of T steps is T
// dependent rounds, and a call's fixed cost (the launch, W_rec and the
// first currents reaching shared memory) is the rest. The TPU kernels keep
// the whole (N, N) W_rec in VMEM and feed s @ W to the MXU each step. Rows
// are independent, so a row's result never depends on how sessions were
// packed: no split across blocks, no atomics. Two routes, chosen from N by
// the wrappers (`kernels/common.py::rec_route`):
//
// The warp route, N <= 32 * REC_LANE_NEURONS (the ECG SRNN's 64). One warp
// owns one batch row, lane l the neurons l, l + 32, ... (R of them, the
// smallest power of two that covers the row), with their state in
// registers. A step's spikes become R ballot words that every lane holds
// in registers; the lanes list the set bits in ascending order in
// warp-private shared memory (each at its rank, a popc) and then add
// their W_rec rows four at a time. A step needs one __syncwarp and no
// block barrier. Up to REC_ROWS rows (warps) share a block and one copy of
// W_rec in shared memory, which the block loads once with cp.async while
// each warp stages its row's first TC steps of current the same way; from
// then on each warp waits only for its own copies (__syncwarp), staging
// the next TC steps while it scans these, every copy instruction moving
// 32 float4s (or floats) of the warp. A step's spikes overwrite its
// current in the stage, which the warp writes out the same way after its
// TC steps. The next step's current is read while this one is summed.
//
// The block route, wider rows. One block owns one batch row, so each
// thread owns NPT neurons of the row, j, j + blockDim, j + 2 blockDim, ...
// (NPT = 1 up to 1024 neurons, the smallest power of two that covers the
// row above; the launcher instantiates NPT up to 256, past the largest
// W_rec a card's memory holds), with their state in registers up to NPT =
// 8. W_rec sits in shared memory when it fits (N up to 241 in fp32, with
// the 227 KB opt-in), else it is read through L2. Each step the row's
// spikes become a bit mask over all N in shared memory (one warp ballot per
// 32 neurons); the mask is double-buffered, so one __syncthreads per step
// suffices; the next step's current is loaded before this step's sum.
//
// On both routes every thread adds W[i, j] for the set bits i in ascending
// order to each neuron it owns: the event-driven recurrence, whose work is
// nnz(s_{t-1}) * N and whose loop is uniform across the warp or block
// (every thread reads the same mask).
//
// Rounding: each add and product is __fadd_rn/__fmul_rn/__fsub_rn in the
// plain versions' order, u = ((tau * v) + I) + rec with rec summed from 0
// over ascending i, th = v_th + (beta * a), a = (rho * a) + s. nvcc cannot
// contract them into FMAs, and a neuron's arithmetic does not depend on
// which thread owns it or on the route, so the kernels equal
// `kernels/lifrec/ref.py` and `kernels/alifrec/ref.py` bit for bit at
// every N.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "async_copy.cuh"

#ifndef REC_LANE_NEURONS
#error "rec_scan.cuh needs -DREC_LANE_NEURONS (kernels/_build.py passes it)"
#endif

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

// ---------------------------------------------------------------------------
// The warp route
// ---------------------------------------------------------------------------

constexpr int LANE_N = REC_LANE_NEURONS;  // most neurons a lane owns
constexpr int WARP_MAX_N = 32 * LANE_N;   // widest row of the warp route
constexpr int REC_ROWS = 4;               // rows a block: one warp a scheduler
constexpr int TC = 16;                    // steps of current a stage holds
constexpr int LIST = WARP_MAX_N + 4;      // a step's set bits, read 4 at once
static_assert(LANE_N > 0 && (LANE_N & (LANE_N - 1)) == 0,
              "REC_LANE_NEURONS is a power of two");
static_assert(4 * (WARP_MAX_N * WARP_MAX_N +
                   REC_ROWS * 2 * (TC * WARP_MAX_N + LIST)) <= 227 * 1024,
              "W_rec, the stages and the lists of the widest rows fit");

// Floats of a staged step (16-byte rows) and of W_rec in shared memory,
// and the words of a block's shared memory: W_rec, then per warp two
// stages and two lists.
__host__ __device__ __forceinline__ int stage_row(int N) {
  return (N + 3) / 4 * 4;
}
__host__ __device__ __forceinline__ int w_floats(int N) {
  return (N * N + 3) / 4 * 4;
}
__host__ __device__ __forceinline__ int warp_words(int N, int rows) {
  return w_floats(N) + rows * 2 * (TC * stage_row(N) + LIST);
}

// Warp w of block x owns batch row x * (blockDim.x / 32) + w; lane l owns
// neurons l + 32 r, r < R, whose spikes fill ballot word r. Shared memory
// is indexed from `wsm` by word offsets: W_rec at 0, then each warp's two
// stages of TC steps, NS floats a step, then each warp's two lists.
template <bool ADAPT, int R>
__global__ void __launch_bounds__(32 * REC_ROWS) rec_warp_kernel(
    const ScanArgs p) {
  extern __shared__ __align__(16) float wsm[];
  const int N = p.N, T = p.T, B = p.B;
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int b = blockIdx.x * (blockDim.x / 32) + warp;
  const bool live = b < B;
  const int NS = stage_row(N);
  const int rows = blockDim.x / 32;
  const int ring = w_floats(N) + warp * 2 * TC * NS;  // this row's stages
  const int lists = w_floats(N) + rows * 2 * TC * NS + warp * 2 * LIST;
  const bool vec = N % 4 == 0 && (uintptr_t)p.w % 16 == 0 &&
                   (uintptr_t)p.cur % 16 == 0 && (uintptr_t)p.spikes % 16 == 0;
  const int64_t row = (int64_t)b * N;
  const int64_t stride_t = (int64_t)B * N;

  // W_rec, once, by every thread of the block
  const int nw = N * N;
  if (vec) {
    for (int e = 4 * threadIdx.x; e < nw; e += 4 * blockDim.x)
      cp_async16(smem_u32(wsm + e), p.w + e, true);
  } else {
    for (int e = threadIdx.x; e < nw; e += blockDim.x)
      cp_async4(smem_u32(wsm + e), p.w + e, true);
  }
  // A row of the stage is nu units (float4s, or floats when rows are not
  // 16-byte aligned); lane l walks the units l, l + 32, ... of a chunk's
  // rows, dq rows and du units on each time, so that every copy
  // instruction of the warp moves 32 units.
  const int nu = vec ? N / 4 : N, us = vec ? 4 : 1;
  const int dq = 32 / nu, du = 32 % nu;
  // the currents of steps ch * TC .. of this row into stage ch % 2
  auto issue = [&](int ch) {
    const int t0 = ch * TC;
    const int nt = live ? min(TC, T - t0) : 0;
    const uint32_t st = smem_u32(wsm + ring + (ch & 1) * TC * NS);
    for (int tt = lane / nu, e = lane % nu; tt < nt;) {
      const float* src = p.cur + (t0 + tt) * stride_t + row + us * e;
      const uint32_t dst = st + 4 * (tt * NS + us * e);
      if (vec)
        cp_async16(dst, src, true);
      else
        cp_async4(dst, src, true);
      tt += dq;
      if ((e += du) >= nu) e -= nu, ++tt;
    }
    cp_async_commit();
  };
  issue(0);                         // one group with W_rec
  issue(1);

  int j[R];
  bool in[R];
  float v[R], a[R], tn[R], rn[R];
  uint32_t mask[R];                 // the previous step's spikes, all lanes
#pragma unroll
  for (int r = 0; r < R; ++r) {
    j[r] = lane + 32 * r;
    in[r] = live && j[r] < N;
    v[r] = in[r] ? p.v0[row + j[r]] : 0.f;
    a[r] = (ADAPT && in[r]) ? p.a0[row + j[r]] : 0.f;
    tn[r] = in[r] ? p.tau[j[r]] : 0.f;
    rn[r] = (ADAPT && in[r]) ? p.rho[j[r]] : 0.f;
    mask[r] = __ballot_sync(FULL, in[r] && p.s0[row + j[r]] != 0.f);
  }
  cp_async_wait<1>();
  __syncthreads();                  // W_rec and every row's first stage
  if (!live) return;

  // the step's set bits as a list of rows of W_rec, double-buffered
  int* list = reinterpret_cast<int*>(wsm + lists);
  const uint32_t below = (1u << lane) - 1;   // the lanes under this one
  const int chunks = (T + TC - 1) / TC;
  for (int ch = 0; ch < chunks; ++ch) {
    if (ch > 0) {
      cp_async_wait<1>();           // this lane's copies of stage ch
      __syncwarp();                 // and the warp's
    }
    const int st = ring + (ch & 1) * TC * NS;
    const int t0 = ch * TC, nt = min(TC, T - t0);
    float c[R];                     // the step's current, read a step ahead
#pragma unroll
    for (int r = 0; r < R; ++r) c[r] = in[r] ? wsm[st + j[r]] : 0.f;
    for (int tt = 0; tt < nt; ++tt) {
      float pre[R], rec[R];         // tau * v + I, before the recurrence
#pragma unroll
      for (int r = 0; r < R; ++r) {
        pre[r] = __fadd_rn(__fmul_rn(tn[r], v[r]), c[r]);
        rec[r] = 0.f;
        if (tt + 1 < nt && in[r]) c[r] = wsm[st + (tt + 1) * NS + j[r]];
      }
      // FINDIDX: lane l of word w lists row 32 w + l at its rank among the
      // set bits, so the list ascends; then LOCACC adds the listed rows in
      // order, reading four rows at a time
      int* ls = list + (tt & 1) * LIST;
      int k = 0;
#pragma unroll
      for (int wi = 0; wi < R; ++wi) {
        if (mask[wi] >> lane & 1)
          ls[k + __popc(mask[wi] & below)] = wi * 32 + lane;
        k += __popc(mask[wi]);
      }
      // every step passes one __syncwarp between its list's writes and
      // reads, and after its reads, before the same list is written again
      __syncwarp();
      for (int q = 0; q < k; q += 4) {
        const int4 iv = *reinterpret_cast<const int4*>(ls + q);
        const int i4[4] = {iv.x, iv.y, iv.z, iv.w};
        float x[4][R];
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int r = 0; r < R; ++r)
            x[e][r] = (q + e < k && in[r]) ? wsm[i4[e] * N + j[r]] : 0.f;
#pragma unroll
        for (int e = 0; e < 4; ++e)
#pragma unroll
          for (int r = 0; r < R; ++r)
            if (q + e < k) rec[r] = __fadd_rn(rec[r], x[e][r]);
      }
#pragma unroll
      for (int r = 0; r < R; ++r) {
        const float u = __fadd_rn(pre[r], rec[r]);
        const float s = fire<ADAPT>(u, v[r], a[r], rn[r], p.v_th, p.beta);
        if (in[r]) wsm[st + tt * NS + j[r]] = s;  // in its current's place
        mask[r] = __ballot_sync(FULL, in[r] && s != 0.f);
      }
    }
    __syncwarp();                   // every lane's spikes of the stage
    for (int tt = lane / nu, e = lane % nu; tt < nt;) {
      float* dst = p.spikes + (t0 + tt) * stride_t + row + us * e;
      const float* src = wsm + st + tt * NS + us * e;
      if (vec)
        *reinterpret_cast<float4*>(dst) = *reinterpret_cast<const float4*>(src);
      else
        *dst = *src;
      tt += dq;
      if ((e += du) >= nu) e -= nu, ++tt;
    }
    __syncwarp();                   // read out before it is refilled
    issue(ch + 2);
  }
  cp_async_wait<0>();
#pragma unroll
  for (int r = 0; r < R; ++r)
    if (in[r]) {
      p.vT[row + j[r]] = v[r];
      if (ADAPT) p.aT[row + j[r]] = a[r];
    }
}

// The instantiation of R neurons a lane that `kernels/common.py::rec_plan`
// chose (the least that covers the row); any other R is refused.
template <bool ADAPT, int R>
int launch_warp(const ScanArgs& p, int unit, cudaStream_t stream) {
  if constexpr (R < LANE_N) {
    if (R < unit) return launch_warp<ADAPT, 2 * R>(p, unit, stream);
  }
  if (R != unit || 32 * R < p.N || (R > 1 && 16 * R >= p.N))
    return (int)cudaErrorInvalidValue;  // not the plan's instantiation
  const int rows = p.B < REC_ROWS ? p.B : REC_ROWS;
  const int smem = (int)sizeof(float) * warp_words(p.N, rows);
  auto kern = rec_warp_kernel<ADAPT, R>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<(p.B + rows - 1) / rows, 32 * rows, smem, stream>>>(p);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// The block route
// ---------------------------------------------------------------------------

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

// Dynamic shared memory of a block: the two spike masks, plus W_rec where
// `kernels/common.py::rec_plan` keeps it there (`smem_w`: it fits under
// the device's opt-in maximum, as the plan reads it).
inline int block_smem(int N, bool smem_w) {
  const size_t masks = 2 * sizeof(uint32_t) * ((N + 31) / 32);
  return (int)(smem_w ? masks + sizeof(float) * (size_t)N * N : masks);
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

// The instantiation of NPT neurons a thread that the plan chose (the least
// whose REC_THREADS threads cover the row); any other NPT is refused.
template <bool ADAPT, int NPT>
int launch_npt(const ScanArgs& p, int unit, int smem, cudaStream_t stream) {
  if constexpr (NPT < 256) {
    if (NPT < unit) return launch_npt<ADAPT, 2 * NPT>(p, unit, smem, stream);
  }
  if (NPT != unit || (int64_t)NPT * REC_THREADS < p.N ||
      (NPT > 1 && (int64_t)NPT * REC_THREADS / 2 >= p.N))
    return (int)cudaErrorInvalidValue;
  const int per = (p.N + NPT - 1) / NPT;
  return launch_kernel(rec_scan_kernel<ADAPT, false, NPT>, p,
                       (per + 31) / 32 * 32, smem, stream);
}

// Launch the scan as `kernels/common.py::rec_plan` planned it: on the warp
// route (`warp` set, N <= WARP_MAX_N) with `unit` neurons a lane, or on B
// blocks with `unit` neurons a thread, W_rec in shared memory where
// `smem_w` is set (then one neuron a thread); returns a CUDA error code.
template <bool ADAPT>
int launch_rec_scan(const ScanArgs& p, bool warp, int unit, bool smem_w,
                    cudaStream_t stream) {
  if (p.T < 1 || p.B < 1 || p.N < 1 || unit < 1)
    return (int)cudaErrorInvalidValue;
  if (warp) return launch_warp<ADAPT, 1>(p, unit, stream);
  const int smem = block_smem(p.N, smem_w);
  if (smem_w) {
    if (unit != 1 || p.N > REC_THREADS) return (int)cudaErrorInvalidValue;
    return launch_kernel(rec_scan_kernel<ADAPT, true, 1>, p,
                         (p.N + 31) / 32 * 32, smem, stream);
  }
  return launch_npt<ADAPT, 1>(p, unit, smem, stream);
}

}  // namespace
