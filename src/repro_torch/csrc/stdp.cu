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
// The single step (`stdp`). At `stdp_run`'s shape (B = 8, 256 x 128) it
// moves 0.29 MB (0.09 us at 3.35 TB/s) and is called once a step, so its
// time is a launch and the memory round trips its chain waits on. A
// thread owns PAIR_V = 2 adjacent weights of one row (128 CTAs of four
// warps at 256 x 128) and issues every load
// before the first use: its weights, the B values of x_pre[:, i] and
// s_pre[:, i] (one address across a warp) and the B rows of its columns of
// s_post and x_post, in rounds of PAIR_ROWS rows with the next round in
// flight while this one is summed. One round trip at B <= 8; no shared
// memory, no barrier. Pair loads only where the kernel finds the rows
// whole and aligned (`stdp_run` passes slices t * B * n elements into a
// train), else scalar loads; one branch picks the route for the whole
// step. bf16 values stay as loaded until they are used, so that no
// conversion waits on a load while later loads are still to be issued.
//
// Rounding: each product and sum is __fmul_rn/__fadd_rn/__fsub_rn in the
// plain versions' order (`kernels/stdp/ref.py`): s_k summed from 0 over b
// ascending, dw summed from 0 over k ascending as dw + amp_k * s_k, then
// w + dw; the single step as (w + a_plus * pot) - a_minus * dep. The clip
// is fminf(fmaxf(x, w_min), w_max). nvcc cannot contract them into FMAs,
// and the split into phases changes no operation, so the kernels equal
// their plain versions bit for bit.

#include <cuda_runtime.h>
#include <cstdint>

#include "async_copy.cuh"

#ifndef STDP_SEQ_GROUP
#error "stdp.cu needs -DSTDP_SEQ_GROUP (kernels/_build.py passes it)"
#endif

namespace {

constexpr int MAX_TERMS = 4;

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

constexpr int PAIR_V = 2;          // adjacent weights of one row a thread owns
constexpr int PAIR_THREADS = 128;  // four warps a CTA
constexpr int PAIR_ROWS = 8;       // batch rows one round of loads covers

// A trace or spike value as loaded. fp32 is used as it is; bf16 is kept as
// its bits (a pair of columns in one word where loaded as a pair) and
// upcast only where it is used, exactly: the bits of a bf16 are the high
// half of its fp32. So no instruction waits on a load before the last
// load is issued.
template <typename Tin>
struct Raw;
template <>
struct Raw<float> {
  using T = float;
  __device__ static float one(const float* p) { return __ldg(p); }
  __device__ static float f32(float r) { return r; }
  // columns j0, j0 + 1 of a row: one 8-byte load where VEC, else the n
  // valid ones one by one
  template <bool VEC>
  __device__ static void pair(float (&r)[PAIR_V], const float* p, int n) {
    if (VEC) {
      const float2 q = __ldg(reinterpret_cast<const float2*>(p));
      r[0] = q.x, r[1] = q.y;
    } else {
#pragma unroll
      for (int e = 0; e < PAIR_V; ++e) r[e] = e < n ? __ldg(p + e) : 0.f;
    }
  }
  template <bool VEC>
  __device__ static float col(const float (&r)[PAIR_V], int e) {
    return r[e];
  }
};
template <>
struct Raw<uint16_t> {
  using T = uint32_t;
  __device__ static uint32_t one(const uint16_t* p) { return __ldg(p); }
  __device__ static float f32(uint32_t r) { return __uint_as_float(r << 16); }
  // VEC: both columns in r[0] (column j0 in its low half)
  template <bool VEC>
  __device__ static void pair(uint32_t (&r)[PAIR_V], const uint16_t* p,
                              int n) {
    if (VEC) {
      r[0] = __ldg(reinterpret_cast<const unsigned*>(p));
    } else {
#pragma unroll
      for (int e = 0; e < PAIR_V; ++e) r[e] = e < n ? __ldg(p + e) : 0u;
    }
  }
  template <bool VEC>
  __device__ static float col(const uint32_t (&r)[PAIR_V], int e) {
    if (VEC)
      return __uint_as_float(e == 0 ? r[0] << 16 : r[0] & 0xffff0000u);
    return f32(r[e]);
  }
};
static_assert(PAIR_V == 2, "Raw<>::pair reads pairs");

template <typename Tin>
struct PairArgs {
  const Tin* x_pre;    // (B, M)
  const Tin* s_post;   // (B, N)
  const Tin* s_pre;    // (B, M)
  const Tin* x_post;   // (B, N)
  const float* w_in;   // (M, N)
  float* w_out;        // (M, N)
  int B, M, N;
  float a_plus, a_minus, w_min, w_max;
};

// One round's inputs of a thread, as loaded: PAIR_ROWS batch rows of its
// row i's pre-side values and of its columns' post-side values.
template <typename Tin>
struct PairRows {
  using R = typename Raw<Tin>::T;
  R x_pre[PAIR_ROWS], s_pre[PAIR_ROWS];
  R s_post[PAIR_ROWS][PAIR_V], x_post[PAIR_ROWS][PAIR_V];
};

// The thread's PAIR_V weights (i, j0 ..), n of them inside N. VEC: rows of
// whole pairs at aligned addresses, so each pair is one load.
template <typename Tin, bool VEC>
__device__ __forceinline__ void pair_step(const PairArgs<Tin>& a, int i,
                                          int j0, int n) {
  using Rw = Raw<Tin>;
  const int wo = i * a.N + j0;
  float w[PAIR_V];
  Raw<float>::pair<VEC>(w, a.w_in + wo, n);
  auto load = [&](PairRows<Tin>& r, int b0) {
#pragma unroll
    for (int k = 0; k < PAIR_ROWS; ++k) {
      const int b = b0 + k;
      if (b < a.B) {
        const int pre = b * a.M + i, post = b * a.N + j0;
        r.x_pre[k] = Rw::one(a.x_pre + pre);
        r.s_pre[k] = Rw::one(a.s_pre + pre);
        Rw::template pair<VEC>(r.s_post[k], a.s_post + post, n);
        Rw::template pair<VEC>(r.x_post[k], a.x_post + post, n);
      }
    }
  };
  float pot[PAIR_V], dep[PAIR_V];
#pragma unroll
  for (int v = 0; v < PAIR_V; ++v) pot[v] = dep[v] = 0.f;
  PairRows<Tin> cur, nxt;
  load(cur, 0);
  for (int b0 = 0; b0 < a.B; b0 += PAIR_ROWS) {
    if (b0 + PAIR_ROWS < a.B) load(nxt, b0 + PAIR_ROWS);
    const int rows = min(PAIR_ROWS, a.B - b0);
#pragma unroll
    for (int k = 0; k < PAIR_ROWS; ++k) {
      if (k < rows) {
        const float xp = Rw::f32(cur.x_pre[k]), sp = Rw::f32(cur.s_pre[k]);
#pragma unroll
        for (int v = 0; v < PAIR_V; ++v) {
          pot[v] = __fadd_rn(
              pot[v], __fmul_rn(xp, Rw::template col<VEC>(cur.s_post[k], v)));
          dep[v] = __fadd_rn(
              dep[v], __fmul_rn(sp, Rw::template col<VEC>(cur.x_post[k], v)));
        }
      }
    }
    cur = nxt;
  }
  float o[PAIR_V];
#pragma unroll
  for (int v = 0; v < PAIR_V; ++v)
    o[v] = clip(__fsub_rn(__fadd_rn(w[v], __fmul_rn(a.a_plus, pot[v])),
                          __fmul_rn(a.a_minus, dep[v])),
                a.w_min, a.w_max);
  float* op = a.w_out + wo;
  if (VEC) {
    *reinterpret_cast<float2*>(op) = make_float2(o[0], o[1]);
  } else {
#pragma unroll
    for (int v = 0; v < PAIR_V; ++v)
      if (v < n) op[v] = o[v];
  }
}

template <typename Tin>
__device__ __forceinline__ bool pair_aligned(const void* p) {
  return (uintptr_t)p % (PAIR_V * sizeof(Tin)) == 0;
}

// w' = clip((w + a_plus * x_pre^T s_post) - a_minus * s_pre^T x_post). A
// thread owns PAIR_V adjacent weights of one row (with N = 128 a warp owns
// half a row); it issues all its loads before the first use, rounds of
// PAIR_ROWS batch rows with the next round's loads in flight while this
// one is summed. No shared memory, no barrier. Offsets are 32-bit (the
// entry point refuses B * M, B * N or M * N past 2^31).
template <typename Tin>
__global__ void __launch_bounds__(PAIR_THREADS)
stdp_pair_kernel(const PairArgs<Tin> a) {
  const int nv = (a.N + PAIR_V - 1) / PAIR_V;   // pairs of a row
  const int g = blockIdx.x * PAIR_THREADS + threadIdx.x;
  const int i = g / nv;
  if (i >= a.M) return;
  const int j0 = (g - i * nv) * PAIR_V;
  const int n = min(PAIR_V, a.N - j0);           // its columns inside N
  // Rows of whole pairs at aligned addresses, checked here: `stdp_run`
  // hands in slices of a (T, B, n) spike train, t * B * n elements in.
  if (a.N % PAIR_V == 0 && pair_aligned<Tin>(a.s_post) &&
      pair_aligned<Tin>(a.x_post) && pair_aligned<float>(a.w_in) &&
      pair_aligned<float>(a.w_out))
    pair_step<Tin, true>(a, i, j0, n);
  else
    pair_step<Tin, false>(a, i, j0, n);
}

// `ctas`: `kernels/stdp/ops.py::stdp_pair_plan`'s grid, checked here.
template <typename Tin>
int stdp_pair(const void* x_pre, const void* s_post, const void* s_pre,
              const void* x_post, const float* w, float* out, int B, int M,
              int N, float a_plus, float a_minus, float w_min, float w_max,
              int ctas, void* stream) {
  const int64_t threads = (int64_t)M * ((N + PAIR_V - 1) / PAIR_V);
  if (B < 0 || M < 1 || N < 1 || (int64_t)M * N > INT32_MAX ||
      (int64_t)B * M > INT32_MAX || (int64_t)B * N > INT32_MAX ||
      ctas != (threads + PAIR_THREADS - 1) / PAIR_THREADS)
    return (int)cudaErrorInvalidValue;
  PairArgs<Tin> a{};
  a.x_pre = static_cast<const Tin*>(x_pre);
  a.s_post = static_cast<const Tin*>(s_post);
  a.s_pre = static_cast<const Tin*>(s_pre);
  a.x_post = static_cast<const Tin*>(x_post);
  a.w_in = w;
  a.w_out = out;
  a.B = B, a.M = M, a.N = N;
  a.a_plus = a_plus, a.a_minus = a_minus, a.w_min = w_min, a.w_max = w_max;
  stdp_pair_kernel<Tin><<<ctas, PAIR_THREADS, 0, (cudaStream_t)stream>>>(a);
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
  const float* w_in;  // (M, N)
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

// The grid of (TM, TN) weight tiles; `kernels/stdp/ops.py::stdp_seq_plan`
// gives the same tile, which the entry point checks.
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

// amps: K floats (host memory). w (M, N), P (K, T*B, M), Q (K, T*B, N):
// step t takes the B rows from t B of each plane. tm, tn: the weight tile
// of `kernels/stdp/ops.py::stdp_seq_plan`, the kernel's one tile (16, 8).
int stdp_seq_f32(const float* P, const float* Q, const float* w, float* out,
                 const float* amps, int K, int T, int B, int M, int N,
                 int tm, int tn, float w_min, float w_max, void* stream) {
  if (K < 1 || K > MAX_TERMS || tm != TM || tn != TN)
    return (int)cudaErrorInvalidValue;
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
             int ctas, void* stream) {
  return stdp_pair<float>(x_pre, s_post, s_pre, x_post, w, out, B, M, N,
                          a_plus, a_minus, w_min, w_max, ctas, stream);
}

int stdp_bf16(const void* x_pre, const void* s_post, const void* s_pre,
              const void* x_post, const float* w, float* out, int B, int M,
              int N, float a_plus, float a_minus, float w_min, float w_max,
              int ctas, void* stream) {
  return stdp_pair<uint16_t>(x_pre, s_post, s_pre, x_post, w, out, B, M, N,
                             a_plus, a_minus, w_min, w_max, ctas, stream);
}

}  // extern "C"
