// Flash attention forward (online softmax, causal and sliding window) for
// sm_90a.
//
// Replaces: src/repro/kernels/attention/kernel.py::flash_attention_pallas
//           (body `_flash_kernel`).
//
// q (BH, T, d), k and v (BH, S, d), heads folded into the batch, all
// contiguous, fp32 or bf16; 1 <= d <= 256. For each row t of each head:
//   s_c = (q_t . k_c) * scale, scale = d^-1/2 applied after the product
//   allowed(t, c) = (!causal || t - c >= 0) && (window <= 0 || t - c < window)
//   o_t = softmax over c of (allowed ? s_c : -1e30) applied to v
// with absolute positions from 0 on both axes, also when T != S. That is
// `kernels/attention/ref.py`, including its rows where nothing is allowed
// (window > 0 and t >= S + window - 1): every score is -1e30, the softmax
// is uniform, and the row is the mean of v. Arithmetic is fp32; bf16 is
// upcast on load and the output rounded once with __float2bfloat16_rn.
//
// What bounds it on an H100: the operations. A (q, k) pair costs 4 d
// (two d-long products), so at T = S = 32768, d = 128, causal, 12 heads
// the kernel must do 3.3e12 operations against 0.4 GB of traffic: far
// above the ridge. This first kernel runs them on the CUDA cores in fp32,
// so 67 TFLOP/s (49 ms there) is its ceiling, not the 989 TFLOP/s of the
// bf16 tensor cores. The design is the plain register-blocked one: a
// 256-thread block owns a 64-row q tile of one head and walks the KV
// tiles of 64 keys in a loop (the TPU's sequential `kj` grid axis); each
// thread holds a 4 x 4 patch of the score tile and a 4 x (DMAX / 16)
// patch of the output accumulator in registers, with the running max and
// sum of its 4 rows. K and then V of a tile share one shared-memory
// buffer, so at d = 128 two blocks fit on an SM. Tiles wholly above the
// diagonal (causal) or below the band (window) are skipped, as the Pallas
// kernel's `@pl.when` gate does, so work is ~T^2/2 causal and ~T W with a
// window. The tensor cores (wgmma, TMA, warp specialisation) are for a
// later version.
//
// Ragged edges are masked in the kernel: rows t >= T are neither loaded
// nor stored, keys c >= S get score -1e30 and weight 0, and d up to the
// template's DMAX is zero-filled. Nothing is padded in device memory, so
// padded keys can never enter a softmax. Masked entries inside a computed
// tile get weight 0 (as `p = where(ok, p, 0)` at kernel.py:64), so a row
// whose tile is wholly masked while its max is still -1e30 adds nothing,
// and the result is acc / max(l, 1e-30).
//
// Offsets are int64 (BH * S * d passes 2^31 at long contexts). The grid
// is one-dimensional, BH * ceil(T / 64) blocks, heaviest q tiles first:
// under causal masking the last tiles do the most work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BQ = 64;                 // q rows per block
constexpr int BK = 64;                 // keys per KV tile
constexpr int THREADS = 256;
constexpr int RM = 4;                  // rows per thread: ty * 4 + i
constexpr int CN = BK / 16;            // score columns per thread: tx + 16 j
constexpr int QLD = BQ + 4;            // Qs[kd][r], transposed
constexpr int PLD = BQ + 4;            // Ps[c][r], transposed
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

template <int DMAX>
constexpr int smem_floats() {
  return DMAX * QLD + BK * (DMAX + 1) + BK * PLD;
}

__device__ __forceinline__ float row_reduce_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_reduce_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// rows [c0, c0 + BK) of a (S, d) matrix into dst[r * (DMAX + 1) + col],
// zero beyond S and d
template <typename Tin, int DMAX>
__device__ __forceinline__ void load_kv(float* dst, const Tin* src, int c0,
                                        int S, int d) {
  constexpr int KLD = DMAX + 1;
#pragma unroll 4
  for (int e = threadIdx.x; e < BK * DMAX; e += THREADS) {
    const int r = e / DMAX, col = e % DMAX;
    float x = 0.f;
    if (c0 + r < S && col < d) x = to_f32(src[(int64_t)(c0 + r) * d + col]);
    dst[r * KLD + col] = x;
  }
}

template <typename Tin, int DMAX>
__global__ void __launch_bounds__(THREADS)
flash_fwd(const Tin* __restrict__ q, const Tin* __restrict__ k,
          const Tin* __restrict__ v, Tin* __restrict__ o, int BH, int T,
          int S, int d, int causal, int window, float scale) {
  constexpr int KLD = DMAX + 1;
  constexpr int DN = DMAX / 16;        // output columns per thread
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                    // DMAX x QLD
  float* KVs = Qs + DMAX * QLD;        // BK x KLD: K, then V, of one tile
  float* Ps = KVs + BK * KLD;          // BK x PLD

  const int nq = (T + BQ - 1) / BQ;
  const int bh = (int)(blockIdx.x % (unsigned)BH);
  const int qi = nq - 1 - (int)(blockIdx.x / (unsigned)BH);
  const int q0 = qi * BQ;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const Tin* qb = q + (int64_t)bh * T * d;
  const Tin* kb = k + (int64_t)bh * S * d;
  const Tin* vb = v + (int64_t)bh * S * d;

#pragma unroll 4
  for (int e = tid; e < BQ * DMAX; e += THREADS) {
    const int r = e / DMAX, col = e % DMAX;
    float x = 0.f;
    if (q0 + r < T && col < d) x = to_f32(qb[(int64_t)(q0 + r) * d + col]);
    Qs[col * QLD + r] = x;
  }

  // rows where no key is allowed: every score -1e30, a uniform softmax
  bool none[RM];
  float m[RM], l[RM], acc[RM][DN];
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = q0 + ty * RM + i;
    none[i] = window > 0 && (int64_t)t >= (int64_t)S + window - 1;
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int jj = 0; jj < DN; ++jj) acc[i][jj] = 0.f;
  }

  // the KV tiles this q tile needs; all of them if one of its rows has
  // no allowed key
  const int t_last = min(q0 + BQ, T) - 1;
  const int nk = (S + BK - 1) / BK;
  int j_lo = 0, j_hi = nk - 1;
  if (!(window > 0 && (int64_t)t_last >= (int64_t)S + window - 1)) {
    if (causal) j_hi = min(j_hi, t_last / BK);
    if (window > 0) {
      const int lo = q0 - window + 1;
      if (lo > 0) j_lo = lo / BK;
    }
  }

  for (int jt = j_lo; jt <= j_hi; ++jt) {
    const int c0 = jt * BK;
    __syncthreads();                   // the last tile's V and P are read
    load_kv<Tin, DMAX>(KVs, kb, c0, S, d);
    __syncthreads();

    float s[RM][CN];
#pragma unroll
    for (int i = 0; i < RM; ++i)
#pragma unroll
      for (int j = 0; j < CN; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int kd = 0; kd < d; ++kd) {
      const float4 qv = *reinterpret_cast<const float4*>(&Qs[kd * QLD +
                                                             ty * RM]);
      const float qr[RM] = {qv.x, qv.y, qv.z, qv.w};
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float kv = KVs[(tx + 16 * j) * KLD + kd];
#pragma unroll
        for (int i = 0; i < RM; ++i) s[i][j] = fmaf(qr[i], kv, s[i][j]);
      }
    }

#pragma unroll
    for (int i = 0; i < RM; ++i) {
      const int t = q0 + ty * RM + i;
      bool ok[CN];
      float mx = NEG_INF;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const int c = c0 + tx + 16 * j;
        const int dp = t - c;
        const bool allowed = c < S && (!causal || dp >= 0) &&
                             (window <= 0 || dp < window);
        s[i][j] = allowed ? s[i][j] * scale : NEG_INF;
        ok[j] = t < T && c < S && (allowed || none[i]);
        mx = fmaxf(mx, s[i][j]);
      }
      const float m_new = fmaxf(m[i], row_reduce_max(mx));
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < CN; ++j) {
        const float p = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        s[i][j] = p;
        ps += p;
      }
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + row_reduce_sum(ps);
      m[i] = m_new;
#pragma unroll
      for (int jj = 0; jj < DN; ++jj) acc[i][jj] *= corr;
    }
#pragma unroll
    for (int j = 0; j < CN; ++j)
      *reinterpret_cast<float4*>(&Ps[(tx + 16 * j) * PLD + ty * RM]) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();                   // K is read, P is written

    load_kv<Tin, DMAX>(KVs, vb, c0, S, d);
    __syncthreads();
    const int cn = min(BK, S - c0);
#pragma unroll 4
    for (int c = 0; c < cn; ++c) {
      const float4 pv = *reinterpret_cast<const float4*>(&Ps[c * PLD +
                                                             ty * RM]);
      const float pr[RM] = {pv.x, pv.y, pv.z, pv.w};
#pragma unroll
      for (int jj = 0; jj < DN; ++jj) {
        const float vv = KVs[c * KLD + tx + 16 * jj];
#pragma unroll
        for (int i = 0; i < RM; ++i) acc[i][jj] = fmaf(pr[i], vv, acc[i][jj]);
      }
    }
  }

  Tin* ob = o + (int64_t)bh * T * d;
#pragma unroll
  for (int i = 0; i < RM; ++i) {
    const int t = q0 + ty * RM + i;
    if (t >= T) continue;
    const float den = fmaxf(l[i], 1e-30f);
#pragma unroll
    for (int jj = 0; jj < DN; ++jj) {
      const int col = tx + 16 * jj;
      if (col < d) store(&ob[(int64_t)t * d + col], acc[i][jj] / den);
    }
  }
}

template <typename Tin, int DMAX>
int launch_d(const Tin* q, const Tin* k, const Tin* v, Tin* o, int BH, int T,
             int S, int d, int causal, int window, float scale,
             cudaStream_t stream) {
  const int bytes = smem_floats<DMAX>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd<Tin, DMAX>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)BH * ((T + BQ - 1) / BQ);
  flash_fwd<Tin, DMAX><<<(unsigned)blocks, THREADS, bytes, stream>>>(
      q, k, v, o, BH, T, S, d, causal, window, scale);
  return (int)cudaGetLastError();
}

template <typename Tin>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int T, int S, int d, int causal, int window, float scale,
           void* stream) {
  const int64_t blocks = (int64_t)BH * ((T + BQ - 1) / BQ);
  if (BH < 0 || T < 0 || S < 0 || d < 1 || d > 256 || blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  const Tin* qp = static_cast<const Tin*>(q);
  const Tin* kp = static_cast<const Tin*>(k);
  const Tin* vp = static_cast<const Tin*>(v);
  Tin* op = static_cast<Tin*>(o);
  cudaStream_t st = (cudaStream_t)stream;
  if (d <= 16)
    return launch_d<Tin, 16>(qp, kp, vp, op, BH, T, S, d, causal, window,
                             scale, st);
  if (d <= 32)
    return launch_d<Tin, 32>(qp, kp, vp, op, BH, T, S, d, causal, window,
                             scale, st);
  if (d <= 64)
    return launch_d<Tin, 64>(qp, kp, vp, op, BH, T, S, d, causal, window,
                             scale, st);
  if (d <= 128)
    return launch_d<Tin, 128>(qp, kp, vp, op, BH, T, S, d, causal, window,
                              scale, st);
  return launch_d<Tin, 256>(qp, kp, vp, op, BH, T, S, d, causal, window,
                            scale, st);
}

}  // namespace

extern "C" {

// scale: d^-1/2 as the caller rounds it to fp32; causal: 0 or 1;
// window <= 0: no window.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* o, int BH, int T, int S, int d, int causal,
                        int window, float scale, void* stream) {
  return launch<float>(q, k, v, o, BH, T, S, d, causal, window, scale,
                       stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int BH, int T, int S, int d, int causal,
                         int window, float scale, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, BH, T, S, d, causal, window,
                               scale, stream);
}

}  // extern "C"
