// On-chip learning: signed outer-product weight updates over serial steps,
// clipped every step (the FIRE-stage weight write), for sm_90a.
//
// Replaces: src/repro/kernels/stdp/kernel.py::stdp_seq_pallas
//           (body `_stdp_seq_kernel`) and ::stdp_pallas
//           (body `_stdp_kernel`).
//
// stdp_seq: P (K, T*B, M), Q (K, T*B, N), w (M, N), all fp32, K <= 4. For
// t = 0 .. T-1:
//   w = clip(w + dw_t, w_min, w_max),  dw_t = sum_k amp_k * P_k[t]^T Q_k[t]
// each P_k[t]^T Q_k[t] a sum over the step's B batch rows.
// stdp: one pair-STDP step over B events, x_pre, s_pre (B, M) and s_post,
// x_post (B, N) in fp32 or bf16 (upcast exactly), w (M, N) fp32:
//   w' = clip((w + a_plus * x_pre^T s_post) - a_minus * s_pre^T x_post)
// Both write a fresh (M, N) output and never the input w.
//
// What bounds them on an H100. The clip makes the steps non-associative:
// a weight takes its T updates one after another. But only the clip is
// serial; every dw_t depends on the planes alone. At the plastic_ff shapes
// (256 x 128 weights, T = 300, B = 8, K = 2) the card moves 7.4 MB (2.2 us)
// and the products are 157 M multiply-adds, each a rounded product and a
// rounded sum (two fp32 issues; ~10 us at the issue rate of 132 SMs):
// issue-bound work around a short serial chain.
//
// stdp_seq's design. A CTA owns a TM x TN = 16 x 8 weight tile (256 CTAs at
// 256 x 128, two an SM: four warps a scheduler) and walks the window in
// groups of G = STDP_SEQ_GROUP steps, in two phases:
//   1. dw of every (weight, step) of the group, in parallel across both:
//      thread (g, u) sums step g's rows for a 4 x 4 micro-tile u of
//      weights, 16 independent chains, reading a float4 of P and one of Q
//      from shared memory per batch row; it writes its 16 dw to shared
//      memory.
//   2. after one barrier, the thread that owns weight (i, j) runs the
//      serial chain w = clip(w + dw_t) over the group's steps (3 dependent
//      operations a step) in a register.
// The planes reach shared memory by cp.async into a ring of STAGES stages,
// each holding RC rows of every step of the group (the tile's 16 columns
// of P_k and 8 of Q_k), so the next stage's rows arrive while this one is
// summed. A step's rows are copied and read by the same eight threads of
// one warp, so the ring needs only __syncwarp; the two phases meet at one
// __syncthreads a group (the dw are double-buffered, so a group's phase 1
// runs while the previous group's chains finish). No split over steps or
// batch rows and no atomics: a weight's result never depends on the grid.
//
// The single step (`stdp`): one block owns a 16 x 16 tile, a thread one
// weight; the block stages CHUNK rows (k, b) at a time in shared memory,
// loading the next round into registers while this one is summed.
//
// Rounding: each product and sum is __fmul_rn/__fadd_rn/__fsub_rn in the
// plain versions' order (`kernels/stdp/ref.py`): s_k summed from 0 over b
// ascending, dw summed from 0 over k ascending as dw + amp_k * s_k, then
// w + dw; the single step as (w + a_plus * pot) - a_minus * dep. The clip
// is fminf(fmaxf(x, w_min), w_max). nvcc cannot contract them into FMAs,
// and the split into phases changes no operation, so the kernels equal
// their plain versions bit for bit.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

#include "async_copy.cuh"

#ifndef STDP_SEQ_GROUP
#error "stdp.cu needs -DSTDP_SEQ_GROUP (kernels/_build.py passes it)"
#endif

namespace {

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

__device__ __forceinline__ float clip(float w, float w_min, float w_max) {
  return fminf(fmaxf(w, w_min), w_max);
}

// ---------------------------------------------------------------------------
// stdp: the single pair step
// ---------------------------------------------------------------------------

constexpr int TILE = 16;                // weight tile edge
constexpr int THREADS = TILE * TILE;    // one thread per weight
constexpr int CHUNK = 256;              // rows staged per round
constexpr int ROW_STEP = THREADS / (2 * TILE);  // rows a pass of loads covers
constexpr int LOADS = CHUNK / ROW_STEP;         // loads per thread a round
static_assert(CHUNK == THREADS, "one thread finds each row of a round");

// K = 2, T = 1: w + amp0 * s0 - amp1 * s1, then the clip.
template <typename Tin>
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
  // closes term kk of the step with its sum over the batch rows
  auto close_term = [&](int kk, float sum) {
    const float a = pick(pl.amp, kk);
    w = kk == 0 ? __fadd_rn(w, __fmul_rn(a, sum))
                : __fsub_rn(w, __fmul_rn(a, sum));
  };
  auto close_step = [&]() { w = clip(w, w_min, w_max); };
  if (B == 0) {                // a step with no batch rows still clips
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
  const dim3 grid((N + TILE - 1) / TILE, (M + TILE - 1) / TILE);
  stdp_kernel<Tin><<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      pl, w, out, 2, 1, B, M, N, w_min, w_max);
  return (int)cudaGetLastError();
}

// ---------------------------------------------------------------------------
// stdp_seq: dw of a group of steps in parallel, then the clip chain
// ---------------------------------------------------------------------------

constexpr int G = STDP_SEQ_GROUP;       // steps a group
constexpr int TM = 16, TN = 8;          // weight tile: rows of M x columns of N
constexpr int UT = 4;                   // a thread's micro-tile: UT x UT
constexpr int MICRO = (TM / UT) * (TN / UT);  // micro-tiles of a tile (8)
constexpr int SEQ_THREADS = MICRO * G;  // one thread a (step, micro-tile)
constexpr int PV = TM / 4, QV = TN / 4; // float4s of a P row and a Q row
constexpr int RC = 8;                   // rows of each step a stage holds
constexpr int STAGES = 3;
// one step's rows in a stage, padded so that the four steps a warp reads
// fall on distinct banks: P rows at 16 words mod 32 apart, Q rows at 8
constexpr int PS = RC * TM + 16;
constexpr int QS = RC * TN + 8;
constexpr int STAGE = G * (PS + QS);    // floats of a stage
// dw of a group: [step][r][micro-tile][c], so that the stores of the
// eight micro-tiles of a step fill the 32 banks, and owner x of phase 2
// reads word x of each step. Two of them: a group's dw are written while
// the previous group's clip chains may still read theirs.
constexpr int DWS = TM * TN;
constexpr int SEQ_SMEM = (STAGES * STAGE + 2 * G * DWS) * (int)sizeof(float);
static_assert(MICRO <= 8 && PV + QV <= 8, "a step's loads take 8 threads");
static_assert(SEQ_THREADS <= 1024 && TM * TN <= SEQ_THREADS, "block shape");

struct SeqArgs {
  const float* P;   // (K, T*B, M): the planes back to back
  const float* Q;   // (K, T*B, N)
  float amp[MAX_TERMS];
  const float* w_in;
  float* w_out;
  int K, T, B, M, N;
  float w_min, w_max;
  bool vec;         // rows of P and Q are 16-byte aligned: float4 copies
};

__global__ void __launch_bounds__(SEQ_THREADS, 2)
stdp_seq_kernel(const SeqArgs a) {
  extern __shared__ __align__(16) float seq_smem[];
  const int K = a.K, T = a.T, B = a.B, M = a.M, N = a.N;
  const int m0 = blockIdx.y * TM, n0 = blockIdx.x * TN;
  const int tid = threadIdx.x;
  // phase 1 and the copies: step g of the group, micro-tile (or vector) u
  const int g = tid / MICRO, u = tid % MICRO;
  const int mi = u / (TN / UT), nj = u % (TN / UT);
  // phase 2: the weight this thread owns, (r, micro-tile, c) = tid
  const int mt2 = tid / UT % MICRO;
  const int i2 = m0 + UT * (mt2 / (TN / UT)) + tid / (UT * MICRO);
  const int j2 = n0 + UT * (mt2 % (TN / UT)) + tid % UT;
  const bool own = tid < TM * TN && i2 < M && j2 < N;
  float w = own ? a.w_in[(int64_t)i2 * N + j2] : 0.f;

  const int KB = K * B;                 // rows of one step, (k, b) order
  if (KB == 0) {                        // steps with no batch rows still clip
    float dw = 0.f;
    for (int k = 0; k < K; ++k)
      dw = __fadd_rn(dw, __fmul_rn(pick(a.amp, k), 0.f));
    for (int t = 0; t < T; ++t) w = clip(__fadd_rn(w, dw), a.w_min, a.w_max);
    if (own) a.w_out[(int64_t)i2 * N + j2] = w;
    return;
  }
  const int nsub = (KB + RC - 1) / RC;  // stages of one group
  const int groups = (T + G - 1) / G;
  const int chunks = groups * nsub;

  // The copies of chunk c (group c / nsub, rows sub * RC .. of each step):
  // thread (g, u) copies step g's rows, vector u < PV of P_k's tile
  // columns or u - PV < QV of Q_k's; the others copy nothing. Within a
  // plane the next batch row is `width` floats on; the next plane's first
  // row of the step is `jump` on from the last.
  const bool isP = u < PV;
  const bool copies = u < PV + QV;
  const int col = isP ? m0 + 4 * u : n0 + 4 * (u - PV);
  const int width = isP ? M : N;
  const int valid = min(max(width - col, 0), 4);
  const float* plane = isP ? a.P : a.Q;
  const int64_t jump = ((int64_t)(T - 1) * B + 1) * width;
  const int rowlen = isP ? TM : TN;
  const int dst0 = isP ? g * PS + 4 * u : G * PS + g * QS + 4 * (u - PV);
  int issued = 0, ist = 0;              // chunks issued, the next one's stage
  int lgi = 0, lsub = 0;                // its group and stage of the group
  auto issue = [&]() {
    const int t = lgi * G + g;
    if (issued < chunks && copies && t < T) {
      const uint32_t dst = smem_u32(seq_smem + ist * STAGE + dst0);
      const int q = lsub * RC, qe = min(q + RC, KB);
      int k = q / B, b = q - k * B;
      const float* src = plane + ((int64_t)(k * T + t) * B + b) * width + col;
      for (int r = 0; r < qe - q; ++r) {
        const uint32_t d = dst + 4 * r * rowlen;
        if (a.vec) {
          cp_async16(d, valid ? src : plane, valid > 0);
        } else {
#pragma unroll
          for (int e = 0; e < 4; ++e)
            cp_async4(d + 4 * e, e < valid ? src + e : plane, e < valid);
        }
        if (++b == B) {
          b = 0;
          src += jump;
        } else {
          src += width;
        }
      }
    }
    cp_async_commit();                  // empty past the end: counts stay
    ++issued;
    ist = ist == STAGES - 1 ? 0 : ist + 1;
    if (++lsub == nsub) lsub = 0, ++lgi;
  };
  for (int c = 0; c < STAGES - 1; ++c) issue();

  float s[UT][UT], dw[UT][UT];
#pragma unroll
  for (int r = 0; r < UT; ++r)
#pragma unroll
    for (int c = 0; c < UT; ++c) s[r][c] = dw[r][c] = 0.f;
  int k = 0, b = 0;                     // the next row's term and batch row
  int gi = 0, sub = 0, cst = 0;         // group, its stage, the ring's stage
  for (int ch = 0; ch < chunks; ++ch) {
    cp_async_wait<STAGES - 2>();        // this thread's copies of chunk ch
    __syncwarp();                       // and its step's seven other threads'
    issue();                            // into the stage read at ch - 1
    const int t = gi * G + g;
    const int nr = min(RC, KB - sub * RC);
    if (t < T) {
      const float* st = seq_smem + cst * STAGE;
      const float* sp = st + g * PS + UT * mi;
      const float* sq = st + G * PS + g * QS + UT * nj;
      for (int r = 0; r < nr;) {
        // the rows up to the end of this term's batch, or of the stage
        const int seg = min(B - b, nr - r);
#pragma unroll 2
        for (int e = r; e < r + seg; ++e) {
          const float4 p4 = *reinterpret_cast<const float4*>(sp + e * TM);
          const float4 q4 = *reinterpret_cast<const float4*>(sq + e * TN);
          const float pv[UT] = {p4.x, p4.y, p4.z, p4.w};
          const float qv[UT] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
          for (int rr = 0; rr < UT; ++rr)
#pragma unroll
            for (int c = 0; c < UT; ++c)
              s[rr][c] = __fadd_rn(s[rr][c], __fmul_rn(pv[rr], qv[c]));
        }
        r += seg;
        b += seg;
        if (b < B) continue;
        const float amp = pick(a.amp, k);
#pragma unroll
        for (int rr = 0; rr < UT; ++rr)
#pragma unroll
          for (int c = 0; c < UT; ++c) {
            dw[rr][c] = __fadd_rn(dw[rr][c], __fmul_rn(amp, s[rr][c]));
            s[rr][c] = 0.f;
          }
        b = 0;
        ++k;
      }
    }
    cst = cst == STAGES - 1 ? 0 : cst + 1;
    if (++sub < nsub) continue;
    // the group's last stage: every dw of the group is complete
    sub = 0;
    k = 0;
    float* dwb = seq_smem + STAGES * STAGE + (gi & 1) * G * DWS;
    if (t < T) {
#pragma unroll
      for (int rr = 0; rr < UT; ++rr) {
        *reinterpret_cast<float4*>(dwb + g * DWS + rr * MICRO * UT +
                                   u * UT) =
            make_float4(dw[rr][0], dw[rr][1], dw[rr][2], dw[rr][3]);
#pragma unroll
        for (int c = 0; c < UT; ++c) dw[rr][c] = 0.f;
      }
    }
    // one barrier a group: the other buffer is rewritten only after the
    // next group's barrier, which every owner passes after this chain
    __syncthreads();
    if (tid < TM * TN) {
      const int steps = min(G, T - gi * G);
#pragma unroll 8
      for (int gg = 0; gg < steps; ++gg)
        w = clip(__fadd_rn(w, dwb[gg * DWS + tid]), a.w_min, a.w_max);
    }
    ++gi;
  }
  cp_async_wait<0>();
  if (own) a.w_out[(int64_t)i2 * N + j2] = w;
}

int stdp_seq_launch(const SeqArgs& a, cudaStream_t stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      stdp_seq_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SEQ_SMEM);
  if (e != cudaSuccess) return (int)e;
  const dim3 grid((a.N + TN - 1) / TN, (a.M + TM - 1) / TM);
  stdp_seq_kernel<<<grid, SEQ_THREADS, SEQ_SMEM, stream>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// amps: K floats (host memory).
int stdp_seq_f32(const float* P, const float* Q, const float* w, float* out,
                 const float* amps, int K, int T, int B, int M, int N,
                 float w_min, float w_max, void* stream) {
  if (K < 1 || K > MAX_TERMS) return (int)cudaErrorInvalidValue;
  SeqArgs a{};
  a.P = P;
  a.Q = Q;
  for (int k = 0; k < K; ++k) a.amp[k] = amps[k];
  a.w_in = w;
  a.w_out = out;
  a.K = K, a.T = T, a.B = B, a.M = M, a.N = N;
  a.w_min = w_min, a.w_max = w_max;
  a.vec = M % 4 == 0 && N % 4 == 0 && (uintptr_t)P % 16 == 0 &&
          (uintptr_t)Q % 16 == 0;
  return stdp_seq_launch(a, (cudaStream_t)stream);
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
