// On-chip learning with a session axis, sm_90a: a learning serve window's
// STDP weight write, one weight a session at batch 1.
//
// Replaces: src/repro/kernels/stdp/kernel.py::stdp_seq_pallas (body
//           `_stdp_seq_kernel`) under the JAX serve engine's per-session
//           `vmap` (src/repro/serve/engine.py, `vmap_learn`): kernel 7
//           with a session axis.
//
// Computes, for S sessions each with its own weight w (S, M, N) and its
// rows of the flat term planes P (K, T*S, M), Q (K, T*S, N) (row t S + s
// of each plane for session s at step t), K <= 4, all fp32:
//   w[s] = clip(w[s] + dw, w_min, w_max),
//   dw = sum_k amp_k * P_k[t S + s]^T Q_k[t S + s]     for t = 0 .. T-1,
// into a fresh output (never the input w).
//
// What bounds it on an H100. At serve_plastic's window (K = 2, T = 32,
// S = 64, 256 x 128) the call moves 23.1 MB (6.9 us at 3.35 TB/s): every
// weight in and out once, the planes once. The plain order's arithmetic
// is S M N T (4K + 3) = 738 M fp32 operations, 22 us on 132 SMs x 128
// lanes at 1980 MHz; this kernel issues (3K + 3) a weight a step (below),
// 604 M, 18 us. So it is issue-bound: the design keeps every lane on a
// weight's arithmetic and nothing else.
//
// Design. At batch 1 a step's outer product has one row: there is no sum
// over batch rows to share between threads, so a thread owns weights and
// runs their whole window in registers. A CTA of 128 threads (16 along N
// x 8 along M) owns a TM x TN tile of one session's weight, each thread a
// UR x UC micro-tile: rows m0 + UR ty .. + UR - 1, and UC / 4 groups of 4
// adjacent columns, n0 + 4 tx + 64 c (so each warp's float4 loads and
// stores of w are contiguous), or the one column n0 + tx (UC = 1). The
// grid is (N / TN, M / TM, S); `kernels/stdp/ops.py::stdp_session_tile`
// picks the micro-tile: 4 x 8 (a 32 x 128 tile, 512 CTAs at S = 64: one
// wave of about 4 an SM), shrunk while the grid holds fewer CTAs than the
// card has SMs (S = 7: 2 x 4, 224 CTAs; S = 1: 1 x 1, 256 CTAs). The
// session's P and Q rows for the tile's rows and columns reach shared
// memory by cp.async, in chunks of 16 / K steps (16 (step, term) rows of
// TM + TN floats a stage) through a ring, so shared memory does not grow
// with T and later chunks arrive while one is used: 3 stages for the
// large tiles (two chunks in flight beside three other CTAs an SM), 5 for
// the small ones, whose few CTAs are latency-bound, so a 32-step pair
// window's rows are all asked for at once. One __syncthreads a chunk (the
// rows are copied by all threads and read by all); none between steps.
// Per step and term a thread reads its UR P values and UC Q values from
// shared memory (broadcast across the warp's threads of one row or
// column) and updates every weight of its micro-tile: 4 x 8 weights for 3
// vector loads a term. K is a template parameter (1 to 4), so the terms
// unroll and their amplitudes sit in registers; the step loop unrolls by
// two, so the next step's dw is computed beside this step's clip chain,
// and for the small tiles (at most 8 weights a thread) by a whole chunk.
//
// Rounding: __fmul_rn/__fadd_rn in the plain version's order
// (`kernels/stdp/ref.py::stdp_seq_ref` at batch 1): per step
//   dw = +0; for k ascending: dw = dw + amp_k * s_k, s_k = 0 + p_k q_k;
//   w = clip(w + dw) = fminf(fmaxf(w + dw, w_min), w_max),
// which nvcc cannot contract into FMAs. One operation of that order is
// dropped: s_k = 0 + p_k q_k is taken as s_k = p_k q_k. Proof that every
// bit of the result stays, -0 included (for non-NaN values):
//   1. +0 + x == x for every x but x = -0 (then +0). So s_k may differ
//      only in the sign of a zero, and then amp_k * s_k also only in the
//      sign of a zero (a product with a zero factor is a zero).
//   2. dw is never -0: it starts +0, and a rounded sum is -0 only when
//      both addends are -0.
//   3. So dw + amp_k * s_k is the same either way: if dw != 0 it is dw,
//      and if dw == +0 it is +0 + (+-0) == +0.
// The first term's sum (+0 + amp_0 s_0) is kept: dropping it would make
// dw -0 where amp_0 s_0 is -0, and w + dw differs for w = -0. So a step
// issues 3K + 3 operations a weight, and each session's weight is, bit
// for bit, `stdp_seq_sessions_ref` and the unbatched `stdp_seq` kernel
// (`csrc/stdp.cu`) at batch 1 on its rows alone: a weight depends on
// nothing but its session's rows (no split over steps, no atomics).
//
// Ragged edges (M, N not multiples of the tile) are masked in the loads
// and the store; rows and planes not 16-byte aligned (M or N not a
// multiple of 4) take 4-byte copies and scalar weight loads.

#include <cuda_runtime.h>
#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int NT = 128;           // threads a CTA
constexpr int TX = 16, TY = 8;    // threads along N, along M
constexpr int MAX_TERMS = 4;
constexpr int RING_ROWS = 16;     // (step, term) rows a stage: 16 / K steps

struct Args {
  const float* P;     // (K, T*S, M)
  const float* Q;     // (K, T*S, N)
  const float* w_in;  // (S, M, N)
  float* w_out;
  float amp[MAX_TERMS];
  int T, M, N, S;
  float w_min, w_max;
  bool vec;           // M, N multiples of 4 and the bases 16-byte aligned
};

__device__ __forceinline__ float clip(float w, float w_min, float w_max) {
  return fminf(fmaxf(w, w_min), w_max);
}

// UR rows x UC columns a thread, a (TY UR) x (TX UC) tile; K terms. The
// thread's columns: UC / 4 groups of 4 adjacent ones, 4 TX apart (UC = 4
// or 8), or one (UC = 1).
template <int UR, int UC, int K>
__global__ void __launch_bounds__(NT, 4)
stdp_sessions_kernel(const Args a) {
  static_assert(UC == 1 || UC == 4 || UC == 8, "micro-tile columns");
  constexpr int CV = UC / 4;            // groups of 4 columns
  constexpr int TM = TY * UR, TN = TX * UC;
  constexpr int ROW = TM + TN;          // floats of one (step, term) row
  constexpr int CH = RING_ROWS / K;     // steps a chunk
  // the small tiles (few CTAs, an SM each: latency-bound) keep four
  // chunks in flight, so a 32-step window's rows are all asked for at
  // once; the large ones two, beside three other CTAs an SM
  constexpr int STAGES = ROW <= 80 ? 5 : 3;
  __shared__ __align__(16) float ring[STAGES][RING_ROWS * ROW];
  const int T = a.T, M = a.M, N = a.N, S = a.S;
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int s = blockIdx.z;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int64_t wz = (int64_t)s * M * N;
  const int chunks = (T + CH - 1) / CH;

  // chunk c's rows into stage c % STAGES: row j K + k holds P_k's TM
  // columns from m0, then Q_k's TN columns from n0, of step c CH + j
  auto issue = [&](int c) {
    if (c < chunks) {
      float* st = ring[c % STAGES];
      const int t0 = c * CH, rows = min(CH, T - t0) * K;
      if (a.vec) {
        constexpr int V = ROW / 4;      // float4s a row
        for (int v = tid; v < rows * V; v += NT) {
          const int r = v / V, x = v - r * V;
          const int j = r / K, k = r - j * K;
          const int64_t row = (int64_t)k * T * S + (int64_t)(t0 + j) * S + s;
          const bool isP = x < TM / 4;
          const int col = isP ? m0 + 4 * x : n0 + 4 * (x - TM / 4);
          const int width = isP ? M : N;
          const float* plane = isP ? a.P : a.Q;
          const bool in = col < width;
          cp_async16(smem_u32(st + r * ROW + 4 * x),
                     in ? plane + row * width + col : plane, in);
        }
      } else {
        for (int v = tid; v < rows * ROW; v += NT) {
          const int r = v / ROW, x = v - r * ROW;
          const int j = r / K, k = r - j * K;
          const int64_t row = (int64_t)k * T * S + (int64_t)(t0 + j) * S + s;
          const bool isP = x < TM;
          const int col = isP ? m0 + x : n0 + x - TM;
          const int width = isP ? M : N;
          const float* plane = isP ? a.P : a.Q;
          const bool in = col < width;
          cp_async4(smem_u32(st + v), in ? plane + row * width + col : plane,
                    in);
        }
      }
    }
    cp_async_commit();                  // empty past the end: counts stay
  };
  for (int c = 0; c < STAGES - 1; ++c) issue(c);

  // the thread's weights, in flight beside the first chunks' copies
  float w[UR][UC];
#pragma unroll
  for (int r = 0; r < UR; ++r) {
    const int i = m0 + UR * ty + r;
    if constexpr (UC == 1) {
      const int j = n0 + tx;
      w[r][0] = i < M && j < N ? __ldg(a.w_in + wz + (int64_t)i * N + j)
                               : 0.f;
    }
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      const int j = n0 + 4 * tx + 4 * TX * c;
      const float* p = a.w_in + wz + (int64_t)i * N + j;
      if (a.vec) {
        const float4 v = i < M && j < N
                             ? __ldg(reinterpret_cast<const float4*>(p))
                             : make_float4(0.f, 0.f, 0.f, 0.f);
        w[r][4 * c] = v.x, w[r][4 * c + 1] = v.y;
        w[r][4 * c + 2] = v.z, w[r][4 * c + 3] = v.w;
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          w[r][4 * c + e] = i < M && j + e < N ? __ldg(p + e) : 0.f;
      }
    }
  }

  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<STAGES - 2>();        // this thread's copies of chunk ch
    __syncthreads();                    // everyone's; and chunk ch - 1 read
    issue(ch + STAGES - 1);             // into the stage read at ch - 1
    const float* st = ring[ch % STAGES];
    const int steps = min(CH, T - ch * CH);
    auto step = [&](int j) {
      float dw[UR][UC];
#pragma unroll
      for (int r = 0; r < UR; ++r)
#pragma unroll
        for (int c = 0; c < UC; ++c) dw[r][c] = 0.f;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const float* row = st + (j * K + k) * ROW;
        float p[UR], q[UC];
        if constexpr (UR == 4) {
          const float4 v = *reinterpret_cast<const float4*>(row + 4 * ty);
          p[0] = v.x, p[1] = v.y, p[2] = v.z, p[3] = v.w;
        } else if constexpr (UR == 2) {
          const float2 v = *reinterpret_cast<const float2*>(row + 2 * ty);
          p[0] = v.x, p[1] = v.y;
        } else {
          p[0] = row[ty];
        }
        if constexpr (UC == 1) q[0] = row[TM + tx];
#pragma unroll
        for (int c = 0; c < CV; ++c) {
          const float4 v = *reinterpret_cast<const float4*>(
              row + TM + 4 * tx + 4 * TX * c);
          q[4 * c] = v.x, q[4 * c + 1] = v.y;
          q[4 * c + 2] = v.z, q[4 * c + 3] = v.w;
        }
        const float amp = a.amp[k];
#pragma unroll
        for (int r = 0; r < UR; ++r)
#pragma unroll
          for (int c = 0; c < UC; ++c)
            dw[r][c] = __fadd_rn(dw[r][c],
                                 __fmul_rn(amp, __fmul_rn(p[r], q[c])));
      }
#pragma unroll
      for (int r = 0; r < UR; ++r)
#pragma unroll
        for (int c = 0; c < UC; ++c)
          w[r][c] = clip(__fadd_rn(w[r][c], dw[r][c]), a.w_min, a.w_max);
    };
    if constexpr (UR * UC <= 8) {
      // the small tiles' few CTAs are latency-bound: a whole chunk
      // unrolled lets every step's loads and dw run ahead of the clip
      // chain (the large tiles, at 4 CTAs an SM, are issue-bound, and
      // slower so)
      if (steps == CH) {
#pragma unroll
        for (int j = 0; j < CH; ++j) step(j);
        continue;
      }
    }
#pragma unroll 2
    for (int j = 0; j < steps; ++j) step(j);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < UR; ++r) {
    const int i = m0 + UR * ty + r;
    if (i >= M) continue;
    if constexpr (UC == 1) {
      if (n0 + tx < N) a.w_out[wz + (int64_t)i * N + n0 + tx] = w[r][0];
    }
#pragma unroll
    for (int c = 0; c < CV; ++c) {
      const int j = n0 + 4 * tx + 4 * TX * c;
      float* p = a.w_out + wz + (int64_t)i * N + j;
      if (a.vec) {
        if (j < N)
          *reinterpret_cast<float4*>(p) = make_float4(
              w[r][4 * c], w[r][4 * c + 1], w[r][4 * c + 2], w[r][4 * c + 3]);
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (j + e < N) p[e] = w[r][4 * c + e];
      }
    }
  }
}

template <int UR, int UC, int K>
int launch(const Args& a, cudaStream_t stream) {
  constexpr int TM = TY * UR, TN = TX * UC;
  const dim3 grid((a.N + TN - 1) / TN, (a.M + TM - 1) / TM, a.S);
  if (grid.y > 65535) return (int)cudaErrorInvalidValue;
  stdp_sessions_kernel<UR, UC, K><<<grid, NT, 0, stream>>>(a);
  return (int)cudaGetLastError();
}

template <int UR, int UC>
int launch_k(const Args& a, int K, cudaStream_t stream) {
  switch (K) {
    case 1: return launch<UR, UC, 1>(a, stream);
    case 2: return launch<UR, UC, 2>(a, stream);
    case 3: return launch<UR, UC, 3>(a, stream);
    default: return launch<UR, UC, 4>(a, stream);
  }
}

}  // namespace

extern "C" {

// amps: K floats (host memory). w (S, M, N), P (K, T*S, M), Q (K, T*S, N),
// contiguous; session s takes row t S + s of each plane at step t. The
// CTA's tile (tm, tn) as kernels/stdp/ops.py::stdp_session_tile picks it,
// 8 UR rows x 16 UC columns: (32, 128), (16, 128), (16, 64), (8, 64) or
// (8, 16); anything else is refused.
int stdp_seq_sessions_f32(const float* P, const float* Q, const float* w,
                          float* out, const float* amps, int K, int T, int M,
                          int N, int S, int tm, int tn, float w_min,
                          float w_max, void* stream) {
  const int tile = tm * 1000 + tn;
  if (K < 1 || K > MAX_TERMS || T < 0 || M < 1 || N < 1 || S < 1 ||
      S > 65535 ||
      (tile != 32128 && tile != 16128 && tile != 16064 && tile != 8064 &&
       tile != 8016))
    return (int)cudaErrorInvalidValue;
  Args a{};
  a.P = P;
  a.Q = Q;
  a.w_in = w;
  a.w_out = out;
  for (int k = 0; k < K; ++k) a.amp[k] = amps[k];
  a.T = T, a.M = M, a.N = N, a.S = S;
  a.w_min = w_min, a.w_max = w_max;
  a.vec = M % 4 == 0 && N % 4 == 0 && (uintptr_t)P % 16 == 0 &&
          (uintptr_t)Q % 16 == 0 && (uintptr_t)w % 16 == 0 &&
          (uintptr_t)out % 16 == 0;
  cudaStream_t st = (cudaStream_t)stream;
  switch (tile) {
    case 8016: return launch_k<1, 1>(a, K, st);
    case 8064: return launch_k<1, 4>(a, K, st);
    case 16064: return launch_k<2, 4>(a, K, st);
    case 16128: return launch_k<2, 8>(a, K, st);
    default: return launch_k<4, 8>(a, K, st);
  }
}

}  // extern "C"
