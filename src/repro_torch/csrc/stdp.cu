// On-chip learning: signed outer-product weight updates over serial steps,
// clipped every step (the FIRE-stage weight write), for sm_90a.
//
// Replaces: src/repro/kernels/stdp/kernel.py::stdp_seq_pallas
//           (body `_stdp_seq_kernel`) and ::stdp_pallas
//           (body `_stdp_kernel`).
//
// stdp_seq: P (K, T*B, M), Q (K, T*B, N), w (M, N), all fp32, K <= 4. For
// t = 0 .. T-1:
//   w = clip(w + sum_k amp_k * P_k[t]^T Q_k[t], w_min, w_max)
// each P_k[t]^T Q_k[t] a sum over the step's B batch rows.
// stdp: one pair-STDP step over B events, x_pre, s_pre (B, M) and s_post,
// x_post (B, N) in fp32 or bf16 (upcast exactly), w (M, N) fp32:
//   w' = clip((w + a_plus * x_pre^T s_post) - a_minus * s_pre^T x_post)
// Both write a fresh (M, N) output and never the input w.
//
// What bounds it on an H100: the serial chain, not bytes or operations.
// The clip makes the steps non-associative, so a weight takes its T
// updates one after another, and at the bench shapes (256 x 128 weights,
// T = 300, B = 8) the card moves ~8 MB and does ~40 MFLOP, a few
// microseconds of either. The TPU kernel keeps a (bm, bn) weight tile in
// VMEM for the whole window and runs each step's contraction on the MXU.
// Here one block owns a 16 x 16 weight tile (256 x 128 gives 128 blocks
// for 132 SMs; a 64 x 64 tile would give 8), each thread one weight in a
// register for the whole window: one read and one write of w. The block
// walks the window's rows (t, k, b) in that order, staging CHUNK of them
// at a time in shared memory (each row: the tile's 16 columns of P_k and
// of Q_k at step t, batch row b), and every thread adds p[b, i] * q[b, j]
// of each row into its term sum. The next round's rows are loaded into
// registers while this round's are summed, and the sum runs over the
// rows of one term's batch without a branch per row. No split over steps
// or batch rows and no atomics: a weight's result never depends on the
// grid.
//
// Rounding: each product and sum is __fmul_rn/__fadd_rn/__fsub_rn in the
// plain versions' order (`kernels/stdp/ref.py`): s_k summed from 0 over b
// ascending, dw summed from 0 over k ascending as dw + amp_k * s_k, then
// w + dw; the single step as (w + a_plus * pot) - a_minus * dep. The clip
// is fminf(fmaxf(x, w_min), w_max). nvcc cannot contract them into FMAs,
// so the kernels equal their plain versions bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int TILE = 16;                // weight tile edge
constexpr int THREADS = TILE * TILE;    // one thread per weight
constexpr int CHUNK = 256;              // rows staged per round
constexpr int ROW_STEP = THREADS / (2 * TILE);  // rows a pass of loads covers
constexpr int LOADS = CHUNK / ROW_STEP;         // loads per thread a round
static_assert(CHUNK == THREADS, "one thread finds each row of a round");
constexpr int MAX_TERMS = 4;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename Tin>
struct Planes {
  const Tin* p[MAX_TERMS];  // K pre-side planes, rows of M
  const Tin* q[MAX_TERMS];  // K post-side planes, rows of N
  float amp[MAX_TERMS];
};

template <typename X>
__device__ __forceinline__ X pick(const X (&a)[MAX_TERMS], int k) {
  return k == 0 ? a[0] : k == 1 ? a[1] : k == 2 ? a[2] : a[3];
}

// PAIR: the single pair-STDP step, K = 2, T = 1, w + amp0 * s0 - amp1 * s1.
// Otherwise the multi-step form, w + sum_k amp_k * s_k.
template <typename Tin, bool PAIR>
__global__ void __launch_bounds__(THREADS)
stdp_kernel(const Planes<Tin> pl, const float* __restrict__ w_in,
            float* __restrict__ w_out, int K, int T, int B, int M, int N,
            float w_min, float w_max) {
  __shared__ float sp[CHUNK * TILE];
  __shared__ float sq[CHUNK * TILE];
  const int tx = threadIdx.x % TILE, ty = threadIdx.x / TILE;
  const int m0 = blockIdx.y * TILE, n0 = blockIdx.x * TILE;
  const int i = m0 + ty, j = n0 + tx;
  const bool in = i < M && j < N;
  float w = in ? w_in[(int64_t)i * N + j] : 0.f;
  // closes term kk of the current step with its sum over the batch rows
  float dw = 0.f;
  auto close_term = [&](int kk, float sum) {
    const float a = pick(pl.amp, kk);
    if (PAIR)
      w = kk == 0 ? __fadd_rn(w, __fmul_rn(a, sum))
                  : __fsub_rn(w, __fmul_rn(a, sum));
    else
      dw = __fadd_rn(dw, __fmul_rn(a, sum));
  };
  auto close_step = [&]() {
    if (!PAIR) w = __fadd_rn(w, dw);
    w = fminf(fmaxf(w, w_min), w_max);
    dw = 0.f;
  };
  if (B == 0) {                // steps with no batch rows still clip
    for (int t = 0; t < T; ++t) {
      for (int kk = 0; kk < K; ++kk) close_term(kk, 0.f);
      close_step();
    }
  }

  const int kb = K * B;        // rows of one step
  const int64_t rows = (int64_t)T * kb;
  // Staging: thread x finds where row x of the next round starts in P_k
  // and in Q_k (its step, term and batch row: one division each), and the
  // block keeps these row pointers in shared memory. Thread x then loads
  // column x % 32 (the tile's 16 columns of P_k, then of Q_k) of rows
  // x / 32 + 8u, u < LOADS, into registers, which are in flight while this
  // round's rows are summed and go to shared memory after.
  __shared__ const Tin* rp[CHUNK];
  __shared__ const Tin* rq[CHUNK];
  const int c = threadIdx.x % (2 * TILE), r0 = threadIdx.x / (2 * TILE);
  float buf[LOADS];
  auto index_rows = [&](int64_t t0, int q0, int nr) {
    const int x = threadIdx.x;
    if (x < nr) {
      const int q = q0 + x;
      const int64_t trow = (t0 + q / kb) * B + q % kb % B;
      const int kk = q % kb / B;
      rp[x] = pick(pl.p, kk) + trow * M + m0;
      rq[x] = pick(pl.q, kk) + trow * N + n0;
    }
  };
  auto load = [&](int nr) {
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int r = r0 + ROW_STEP * u;
      float v = 0.f;
      if (r < nr) {
        if (c < TILE) {
          if (m0 + c < M) v = to_f32(rp[r][c]);
        } else if (n0 + c - TILE < N) {
          v = to_f32(rq[r][c - TILE]);
        }
      }
      buf[u] = v;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int u = 0; u < LOADS; ++u) {
      const int r = r0 + ROW_STEP * u;
      if (c < TILE)
        sp[r * TILE + c] = buf[u];
      else
        sq[r * TILE + c - TILE] = buf[u];
    }
  };

  int64_t t0 = 0;              // the round's first row: step t0, place q0
  int q0 = 0;                  //   (q0 = k * B + b) within it
  int b = 0, k = 0;            // the next row's place, for the sums
  float s = 0.f;
  if (rows > 0) {
    const int nr = (int)(rows < CHUNK ? rows : CHUNK);
    index_rows(0, 0, nr);
    __syncthreads();
    load(nr);
    store();
    __syncthreads();
  }
  for (int64_t base = 0; base < rows; base += CHUNK) {
    const int nr = (int)(rows - base < CHUNK ? rows - base : CHUNK);
    const int64_t t1 = t0 + (q0 + nr) / kb;
    const int q1 = (q0 + nr) % kb;
    const int64_t rest = rows - base - nr;
    const int nr1 = (int)(rest < CHUNK ? rest : CHUNK);
    if (rest > 0) {            // the last loads have read the row pointers
      index_rows(t1, q1, nr1);
      __syncthreads();
      load(nr1);
    }
    for (int r = 0; r < nr;) {
      // the rows up to the end of this term's batch, or of the round
      const int seg = B - b < nr - r ? B - b : nr - r;
#pragma unroll 4
      for (int e = r; e < r + seg; ++e)
        s = __fadd_rn(s, __fmul_rn(sp[e * TILE + ty], sq[e * TILE + tx]));
      r += seg;
      b += seg;
      if (b < B) continue;
      b = 0;
      close_term(k, s);
      s = 0.f;
      if (++k < K) continue;
      k = 0;
      close_step();
    }
    t0 = t1;
    q0 = q1;
    if (rest > 0) {
      __syncthreads();         // this round's rows are consumed
      store();
      __syncthreads();
    }
  }
  if (in) w_out[(int64_t)i * N + j] = w;
}

template <typename Tin, bool PAIR>
int launch(const Planes<Tin>& pl, const float* w_in, float* w_out, int K,
           int T, int B, int M, int N, float w_min, float w_max,
           cudaStream_t stream) {
  if (K < 1 || K > MAX_TERMS || (PAIR && (K != 2 || T != 1)))
    return (int)cudaErrorInvalidValue;
  const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  stdp_kernel<Tin, PAIR><<<grid, THREADS, 0, stream>>>(
      pl, w_in, w_out, K, T, B, M, N, w_min, w_max);
  return (int)cudaGetLastError();
}

template <typename Tin>
int stdp_pair(const void* x_pre, const void* s_post, const void* s_pre,
              const void* x_post, const float* w, float* out, int B, int M,
              int N, float a_plus, float a_minus, float w_min, float w_max,
              void* stream) {
  Planes<Tin> pl{};
  pl.p[0] = static_cast<const Tin*>(x_pre);
  pl.q[0] = static_cast<const Tin*>(s_post);
  pl.p[1] = static_cast<const Tin*>(s_pre);
  pl.q[1] = static_cast<const Tin*>(x_post);
  pl.amp[0] = a_plus;
  pl.amp[1] = a_minus;
  return launch<Tin, true>(pl, w, out, 2, 1, B, M, N, w_min, w_max,
                           (cudaStream_t)stream);
}

}  // namespace

extern "C" {

// amps: K floats (host memory).
int stdp_seq_f32(const float* P, const float* Q, const float* w, float* out,
                 const float* amps, int K, int T, int B, int M, int N,
                 float w_min, float w_max, void* stream) {
  if (K < 1 || K > MAX_TERMS) return (int)cudaErrorInvalidValue;
  Planes<float> pl{};
  const int64_t tb = (int64_t)T * B;
  for (int k = 0; k < K; ++k) {
    pl.p[k] = P + k * tb * M;
    pl.q[k] = Q + k * tb * N;
    pl.amp[k] = amps[k];
  }
  return launch<float, false>(pl, w, out, K, T, B, M, N, w_min, w_max,
                              (cudaStream_t)stream);
}

int stdp_f32(const float* x_pre, const float* s_post, const float* s_pre,
             const float* x_post, const float* w, float* out, int B, int M,
             int N, float a_plus, float a_minus, float w_min, float w_max,
             void* stream) {
  return stdp_pair<float>(x_pre, s_post, s_pre, x_post, w, out, B, M, N,
                          a_plus, a_minus, w_min, w_max, stream);
}

int stdp_bf16(const void* x_pre, const void* s_post, const void* s_pre,
              const void* x_post, const float* w, float* out, int B, int M,
              int N, float a_plus, float a_minus, float w_min, float w_max,
              void* stream) {
  return stdp_pair<__nv_bfloat16>(x_pre, s_post, s_pre, x_post, w, out, B,
                                  M, N, a_plus, a_minus, w_min, w_max,
                                  stream);
}

}  // extern "C"
