// Flash attention forward (online softmax, causal and sliding window) for
// sm_90a, by two routes.
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
// is uniform, and the row is the mean of v.
//
// What bounds it on an H100: the operations. A (q, k) pair costs 4 d
// (two d-long products), so at T = S = 32768, d = 128, causal, 12 heads
// the kernel must do 3.3e12 operations against 0.4 GB of traffic: far
// above the ridge of the bf16 tensor cores (989 TFLOP/s). With one query
// tile per head (T = 128) and a long S it is the bytes of K and V.
//
// Route 1, the tensor cores (`flash_fwd_tc`, bf16 with d = 64 or 128, the
// configs' head widths). A CTA of 288 threads owns a 128-row q tile of one
// head: two consumer warpgroups of 64 rows (the wgmma M) and one producer
// warp. The producer's first lane loads Q once and then K and V tiles of
// 128 keys by TMA (cp.async.bulk.tensor over 3-D maps (d, rows, BH) with
// 64-bit strides, 128-byte swizzle, a 256-byte row as two 64-column boxes)
// into a ring of NST stages, each completing on an mbarrier (K and V
// apart, so S = Q K^T starts before V lands); the consumers release a
// stage on a third mbarrier. TMA fills zeros past S, T and d, so nothing
// is padded in device memory and no load is masked; keys c >= S are still
// masked in the score. Each consumer warpgroup computes S = Q K^T by
// wgmma m64n128k16 (Q and K both K-major in swizzled shared memory, fp32
// accumulators in registers), applies the scale (times log2 e) and the
// mask in registers, and runs the online softmax on the accumulator
// fragment with exp2 (ex2.approx) of the pre-scaled scores; a row's max
// and sum are reduced by shuffles over the 4 lanes that share it (the sum
// only once, at the end). Then
// O += P V by wgmma with A = P from registers and B = V from shared memory,
// MN-major (the transpose bit). P is rounded to bf16 as two terms,
// P = hi + lo, each a wgmma into the same fp32 accumulator: one bf16 P is
// off by up to 2^-8 of each weight, which breaks the one-bf16-spacing
// tolerance the port is held to on rows whose few weights cancel; the two
// terms keep P to ~2^-16, at 1.5x the tensor-core work of one. O is
// rounded to bf16 once. Tiles wholly inside the mask skip the mask
// arithmetic.
//
// A split over KV (same kernel, nsplit > 1): when BH * ceil(T / 128) is
// under about twice the SM count, the wrapper cuts each q tile's KV tiles
// into nsplit whole-tile chunks; a CTA writes its unnormalised o (fp32) and
// its running max m (log2 units) and sum l to scratch the wrapper
// allocates, and `flash_combine` merges the splits of each row in fixed
// split order, so the result does not depend on scheduling.
//
// Route 2, the CUDA cores (`flash_fwd`, fp32, and bf16 at other d):
// arithmetic in fp32; bf16 is upcast on load and the output rounded once
// with __float2bfloat16_rn. So 67 TFLOP/s (49 ms at the size above) is
// its ceiling. The design is the plain register-blocked one: a
// 256-thread block owns a 64-row q tile of one head and walks the KV
// tiles of 64 keys in a loop (the TPU's sequential `kj` grid axis); each
// thread holds a 4 x 4 patch of the score tile and a 4 x (DMAX / 16)
// patch of the output accumulator in registers, with the running max and
// sum of its 4 rows. K and then V of a tile share one shared-memory
// buffer, so at d = 128 two blocks fit on an SM.
//
// Both routes skip tiles wholly above the diagonal (causal) or below the
// band (window), as the Pallas kernel's `@pl.when` gate does, so work is
// ~T^2/2 causal and ~T W with a window; a q tile that holds a row with no
// allowed key walks every KV tile, that row weighing every key 1 while
// the tile's other rows keep their masks. Both run the heaviest q tiles
// first (under causal masking the last tiles do the most work).
//
// Ragged edges are masked in the kernel: rows t >= T are not stored, keys
// c >= S get weight 0, and d up to the CUDA-core template's DMAX is
// zero-filled. Masked entries inside a computed tile get weight 0 (as
// `p = where(ok, p, 0)` at kernel.py:64), so a row whose tile is wholly
// masked while its max is still -1e30 adds nothing, and the result is
// acc / max(l, 1e-30). Offsets are int64 (BH * S * d passes 2^31 at long
// contexts); the grid is one-dimensional.

#include <cuda.h>
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

// The CUDA-core route at the head-dim tile `dmax` that
// `kernels/attention/ops.py::plan_call` chose (the least of 16, 32, 64,
// 128, 256 that holds d); any other tile is refused.
template <typename Tin>
int launch(const void* q, const void* k, const void* v, void* o, int BH,
           int T, int S, int d, int causal, int window, float scale,
           int dmax, void* stream) {
  const int64_t blocks = (int64_t)BH * ((T + BQ - 1) / BQ);
  if (BH < 0 || T < 0 || S < 0 || d < 1 || d > 256 || blocks > 0x7fffffff ||
      d > dmax || (dmax > 16 && 2 * d <= dmax))
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return (int)cudaSuccess;
  const Tin* qp = static_cast<const Tin*>(q);
  const Tin* kp = static_cast<const Tin*>(k);
  const Tin* vp = static_cast<const Tin*>(v);
  Tin* op = static_cast<Tin*>(o);
  cudaStream_t st = (cudaStream_t)stream;
  switch (dmax) {
    case 16:
      return launch_d<Tin, 16>(qp, kp, vp, op, BH, T, S, d, causal, window,
                               scale, st);
    case 32:
      return launch_d<Tin, 32>(qp, kp, vp, op, BH, T, S, d, causal, window,
                               scale, st);
    case 64:
      return launch_d<Tin, 64>(qp, kp, vp, op, BH, T, S, d, causal, window,
                               scale, st);
    case 128:
      return launch_d<Tin, 128>(qp, kp, vp, op, BH, T, S, d, causal, window,
                                scale, st);
    case 256:
      return launch_d<Tin, 256>(qp, kp, vp, op, BH, T, S, d, causal, window,
                                scale, st);
  }
  return (int)cudaErrorInvalidValue;
}


// ---------------------------------------------------------------------------
// Route 1: the tensor cores (bf16, d = 64 or 128)
// ---------------------------------------------------------------------------

constexpr int TC_BQ = 128;             // q rows per CTA: two warpgroups of 64
constexpr int TC_BK = 128;             // keys per KV tile
constexpr int TC_THREADS = 288;        // 2 consumer warpgroups, 1 producer warp
constexpr int TC_CONSUMER_WARPS = 8;
constexpr int ROW_BYTES = 128;         // a row of one 64-column bf16 box
constexpr float LOG2E = 1.4426950408889634f;

template <int D>
struct TcCfg {
  static constexpr int NST = D == 128 ? 2 : 3;   // stages of the K/V ring
  static constexpr int Q_BYTES = TC_BQ * D * 2;
  static constexpr int KV_BYTES = TC_BK * D * 2;  // one K or one V tile
  static constexpr int TILES = Q_BYTES + 2 * NST * KV_BYTES;
  // 1024 bytes of slack align the tiles to the 128-byte swizzle's
  // 1024-byte period; then barQ, fullK[NST], fullV[NST], empty[NST]
  static constexpr int SMEM = 1024 + TILES + 8 * (1 + 3 * NST);
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// until the barrier's phase of this parity has completed
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// one box of a 3-D tensor map into shared memory, completing on `bar`
__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

// a wgmma shared-memory descriptor of a 128-byte-swizzled tile: start
// address, leading and stride byte offsets (16-byte units), layout B128
__device__ __forceinline__ uint64_t sw128_desc(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(lbo >> 4) << 16) |
         ((uint64_t)(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait0() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// keeps the compiler from moving accumulator reads across a wgmma wait
template <int N>
__device__ __forceinline__ void fence_regs(float* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t* r) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// 2^x by the SFU (ex2.approx.ftz: 2^-inf = 0; results under 2^-126 flush
// to 0, weights no fp32 sum could keep beside the row's largest, 1)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// D (64 x N, fp32) += A (64 x 16) B (16 x N), bf16. _ss: A and B both
// K-major in shared memory; _rs: A from registers, B MN-major in shared
// memory (the transpose bit). Scale-d is 1: every accumulator starts at 0.
__device__ __forceinline__ void wgmma_ss_n128(float* d, uint64_t da, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n64(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31 "
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

__device__ __forceinline__ void wgmma_rs_n128(float* d, const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63 "
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

template <int N>
__device__ __forceinline__ void wgmma_rs(float* d, const uint32_t* a,
                                         uint64_t db) {
  if constexpr (N == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64(d, a, db);
}

__device__ __forceinline__ uint32_t bf2_bits(__nv_bfloat162 x) {
  return *reinterpret_cast<uint32_t*>(&x);
}

// Fragment layout of a warpgroup's 64 x N fp32 accumulator (wgmma): warp w
// of the group holds rows 16 w + lane / 4 (row 0 of the thread) and + 8
// (row 1); register e holds column 8 (e / 4) + 2 (lane % 4) + e % 2 of
// row (e / 2) % 2. Registers 8 kk .. 8 kk + 7 of the score tile are then
// exactly the A fragment of keys 16 kk .. 16 kk + 15 for O += P V.
template <int D>
__global__ void __launch_bounds__(TC_THREADS, 1)
flash_fwd_tc(const __grid_constant__ CUtensorMap tq,
             const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv,
             __nv_bfloat16* __restrict__ o, float* __restrict__ o_part,
             float* __restrict__ ml, int BH, int T, int S, int causal,
             int window, float sc2, int nsplit) {
  using C = TcCfg<D>;
  constexpr int NST = C::NST;
  const float NEG_INF_TRUE = __int_as_float(0xff800000);
  extern __shared__ uint8_t smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t sK0 = sQ + C::Q_BYTES;          // stage st at + st KV_BYTES
  const uint32_t sV0 = sK0 + NST * C::KV_BYTES;
  const uint32_t barQ = sQ + C::TILES;
  const uint32_t fullK0 = barQ + 8, fullV0 = fullK0 + 8 * NST,
                 empty0 = fullV0 + 8 * NST;

  // (q tile, head, split), heaviest q tiles first
  const int nq = (T + TC_BQ - 1) / TC_BQ;
  const int split = (int)(blockIdx.x % (unsigned)nsplit);
  const int rest = (int)(blockIdx.x / (unsigned)nsplit);
  const int bh = rest % BH;
  const int q0 = (nq - 1 - rest / BH) * TC_BQ;
  const int t_last = min(q0 + TC_BQ, T) - 1;

  // the KV tiles this q tile needs (all of them if one of its rows has no
  // allowed key), and this split's whole-tile share of them
  const int nk = (S + TC_BK - 1) / TC_BK;
  int j_lo = 0, j_hi = nk - 1;
  if (!(window > 0 && (int64_t)t_last >= (int64_t)S + window - 1)) {
    if (causal) j_hi = min(j_hi, t_last / TC_BK);
    if (window > 0) {
      const int lo = q0 - window + 1;
      if (lo > 0) j_lo = lo / TC_BK;
    }
  }
  const int64_t n = j_hi - j_lo + 1;
  const int ja = j_lo + (int)(split * n / nsplit);
  const int ntiles = j_lo + (int)((split + 1) * n / nsplit) - ja;

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  if (tid == 0) {
    mbar_init(barQ, 1);
    for (int st = 0; st < NST; ++st) {
      mbar_init(fullK0 + 8 * st, 1);
      mbar_init(fullV0 + 8 * st, 1);
      mbar_init(empty0 + 8 * st, TC_CONSUMER_WARPS);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == TC_CONSUMER_WARPS) {     // the producer warp: one lane loads
    if (lane == 0 && ntiles > 0) {
      mbar_expect_tx(barQ, C::Q_BYTES);
#pragma unroll
      for (int c = 0; c < D / 64; ++c)
        tma_load_3d(sQ + c * TC_BQ * ROW_BYTES, &tq, barQ, c * 64, q0, bh);
      for (int i = 0; i < ntiles; ++i) {
        const int st = i % NST;
        if (i >= NST) mbar_wait(empty0 + 8 * st, ((i / NST) - 1) & 1);
        const int c0 = (ja + i) * TC_BK;
        const uint32_t fk = fullK0 + 8 * st, fv = fullV0 + 8 * st;
        mbar_expect_tx(fk, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(sK0 + st * C::KV_BYTES + c * TC_BK * ROW_BYTES, &tk,
                      fk, c * 64, c0, bh);
        mbar_expect_tx(fv, C::KV_BYTES);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_3d(sV0 + st * C::KV_BYTES + c * TC_BK * ROW_BYTES, &tv,
                      fv, c * 64, c0, bh);
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns q rows wg * 64 .. wg * 64 + 63
  const int wg = warp / 4;
  const int t0 = q0 + wg * 64 + (warp % 4) * 16 + lane / 4, t1 = t0 + 8;
  const int cq = 2 * (lane & 3);
  const bool none0 = window > 0 && (int64_t)t0 >= (int64_t)S + window - 1;
  const bool none1 = window > 0 && (int64_t)t1 >= (int64_t)S + window - 1;
  float m0 = NEG_INF, m1 = NEG_INF, l0 = 0.f, l1 = 0.f;
  float acc[D / 2];
#pragma unroll
  for (int e = 0; e < D / 2; ++e) acc[e] = 0.f;
  if (ntiles > 0) mbar_wait(barQ, 0);

  for (int i = 0; i < ntiles; ++i) {
    const int st = i % NST;
    const uint32_t ph = (i / NST) & 1;
    const int c0 = (ja + i) * TC_BK;
    const uint32_t sK = sK0 + st * C::KV_BYTES, sV = sV0 + st * C::KV_BYTES;

    // S = Q K^T: D / 16 steps of 16 along d, a 64-column box each 4 steps
    float s[TC_BK / 2];
#pragma unroll
    for (int e = 0; e < TC_BK / 2; ++e) s[e] = 0.f;
    fence_regs<TC_BK / 2>(s);
    mbar_wait(fullK0 + 8 * st, ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t qa = sQ + (kk / 4) * TC_BQ * ROW_BYTES +
                          wg * 64 * ROW_BYTES + (kk % 4) * 32;
      const uint32_t ka = sK + (kk / 4) * TC_BK * ROW_BYTES + (kk % 4) * 32;
      wgmma_ss_n128(s, sw128_desc(qa, 16, 1024), sw128_desc(ka, 16, 1024));
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<TC_BK / 2>(s);

    // scale (log2 units) and mask: allowed -> score; a row with no allowed
    // key -> -1e30 for every key c < S (a uniform softmax); else weight 0
    float mx0 = NEG_INF_TRUE, mx1 = NEG_INF_TRUE;
    const bool inside = c0 + TC_BK <= S &&
                        (!causal || c0 + TC_BK - 1 <= q0) &&
                        (window <= 0 || t_last - c0 < window);
    if (inside) {
#pragma unroll
      for (int e = 0; e < TC_BK / 2; ++e) {
        s[e] *= sc2;
        if (e & 2) mx1 = fmaxf(mx1, s[e]);
        else mx0 = fmaxf(mx0, s[e]);
      }
    } else {
#pragma unroll
      for (int e = 0; e < TC_BK / 2; ++e) {
        const int c = c0 + 8 * (e / 4) + cq + (e & 1);
        const int dp = ((e & 2) ? t1 : t0) - c;
        const bool ok = c < S && (!causal || dp >= 0) &&
                        (window <= 0 || dp < window);
        const bool none = (e & 2) ? none1 : none0;
        s[e] = ok ? s[e] * sc2 : (none && c < S ? NEG_INF : NEG_INF_TRUE);
        if (e & 2) mx1 = fmaxf(mx1, s[e]);
        else mx0 = fmaxf(mx0, s[e]);
      }
    }
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
    mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
    mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float cr0 = ex2(m0 - mn0), cr1 = ex2(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    l0 *= cr0;
    l1 *= cr1;

    // P = exp2(s - m) as bf16 hi + lo, in the A-fragment order
    uint32_t phi[TC_BK / 16][4], plo[TC_BK / 16][4];
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int e = 8 * kk + 2 * r;           // row 1 when r is odd
        const float mm = (r & 1) ? mn1 : mn0;
        const float p0 = ex2(s[e] - mm), p1 = ex2(s[e + 1] - mm);
        if (r & 1) l1 += p0 + p1;
        else l0 += p0 + p1;
        const __nv_bfloat162 h = __floats2bfloat162_rn(p0, p1);
        const float2 hf = __bfloat1622float2(h);
        phi[kk][r] = bf2_bits(h);
        plo[kk][r] = bf2_bits(__floats2bfloat162_rn(p0 - hf.x, p1 - hf.y));
      }
    }
#pragma unroll
    for (int e = 0; e < D / 2; ++e) acc[e] *= (e & 2) ? cr1 : cr0;

    // O += P V: BK / 16 steps of 16 keys, V MN-major (d contiguous); its
    // two 64-column boxes lie TC_BK rows apart
    fence_regs<D / 2>(acc);
    fence_regs<TC_BK / 4>(&phi[0][0]);
    fence_regs<TC_BK / 4>(&plo[0][0]);
    mbar_wait(fullV0 + 8 * st, ph);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < TC_BK / 16; ++kk) {
      const uint64_t dv = sw128_desc(sV + kk * 16 * ROW_BYTES,
                                     TC_BK * ROW_BYTES, 1024);
      wgmma_rs<D>(acc, phi[kk], dv);
      wgmma_rs<D>(acc, plo[kk], dv);
    }
    wgmma_commit();
    wgmma_wait0();
    fence_regs<D / 2>(acc);
    if (lane == 0) mbar_arrive(empty0 + 8 * st);
  }

  l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
  l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
  l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
  if (nsplit == 1) {
    const float den0 = fmaxf(l0, 1e-30f), den1 = fmaxf(l1, 1e-30f);
    __nv_bfloat16* o0 = o + ((int64_t)bh * T + t0) * D + cq;
    __nv_bfloat16* o1 = o + ((int64_t)bh * T + t1) * D + cq;
#pragma unroll
    for (int jj = 0; jj < D / 8; ++jj) {
      if (t0 < T)
        *reinterpret_cast<__nv_bfloat162*>(o0 + 8 * jj) =
            __floats2bfloat162_rn(acc[4 * jj] / den0, acc[4 * jj + 1] / den0);
      if (t1 < T)
        *reinterpret_cast<__nv_bfloat162*>(o1 + 8 * jj) =
            __floats2bfloat162_rn(acc[4 * jj + 2] / den1,
                                  acc[4 * jj + 3] / den1);
    }
    return;
  }
  // a split: unnormalised o, and (m, l), rows (split, bh, t)
  const int64_t row0 = ((int64_t)split * BH + bh) * T + t0, row1 = row0 + 8;
#pragma unroll
  for (int jj = 0; jj < D / 8; ++jj) {
    if (t0 < T)
      *reinterpret_cast<float2*>(o_part + row0 * D + cq + 8 * jj) =
          make_float2(acc[4 * jj], acc[4 * jj + 1]);
    if (t1 < T)
      *reinterpret_cast<float2*>(o_part + row1 * D + cq + 8 * jj) =
          make_float2(acc[4 * jj + 2], acc[4 * jj + 3]);
  }
  if ((lane & 3) == 0) {
    if (t0 < T) *reinterpret_cast<float2*>(ml + 2 * row0) = make_float2(m0, l0);
    if (t1 < T) *reinterpret_cast<float2*>(ml + 2 * row1) = make_float2(m1, l1);
  }
}

// The splits of each row merged in split order: one warp a row (bh, t),
// o = sum_s o_s 2^(m_s - M) / max(sum_s l_s 2^(m_s - M), 1e-30), M = max m_s.
template <int D>
__global__ void __launch_bounds__(256)
flash_combine(const float* __restrict__ o_part, const float* __restrict__ ml,
              __nv_bfloat16* __restrict__ o, int64_t rows, int nsplit) {
  const int64_t row = (int64_t)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float M = NEG_INF;
  for (int s = 0; s < nsplit; ++s) M = fmaxf(M, ml[2 * (s * rows + row)]);
  float L = 0.f, acc[D / 32];
#pragma unroll
  for (int i = 0; i < D / 32; ++i) acc[i] = 0.f;
  for (int s = 0; s < nsplit; ++s) {
    const int64_t r = s * rows + row;
    const float e = exp2f(ml[2 * r] - M);
    L += ml[2 * r + 1] * e;
#pragma unroll
    for (int i = 0; i < D / 32; ++i) acc[i] += o_part[r * D + lane + 32 * i] * e;
  }
  const float den = fmaxf(L, 1e-30f);
#pragma unroll
  for (int i = 0; i < D / 32; ++i)
    o[row * D + lane + 32 * i] = __float2bfloat16_rn(acc[i] / den);
}

// cuTensorMapEncodeTiled from the CUDA driver API, through the runtime:
// the library links no -lcuda
typedef CUresult (*EncodeTiledFn)(CUtensorMap*, CUtensorMapDataType,
                                  cuuint32_t, void*, const cuuint64_t*,
                                  const cuuint64_t*, const cuuint32_t*,
                                  const cuuint32_t*, CUtensorMapInterleave,
                                  CUtensorMapSwizzle, CUtensorMapL2promotion,
                                  CUtensorMapFloatOOBfill);

EncodeTiledFn encode_tiled() {
  static EncodeTiledFn fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult res;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &res);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &res);
#endif
    if (err == cudaSuccess && res == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiledFn>(p);
  }
  return fn;
}

// a contiguous (BH, rows, d) bf16 tensor as the 3-D map (d, rows, BH),
// 64-bit strides, boxes of 64 columns x box_rows rows, 128-byte swizzle,
// zeros past every edge
bool make_map(CUtensorMap* map, const void* ptr, int BH, int rows, int d,
              int box_rows) {
  const cuuint64_t dims[3] = {(cuuint64_t)d, (cuuint64_t)rows,
                              (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)d * 2,
                                 (cuuint64_t)rows * (cuuint64_t)d * 2};
  const cuuint32_t box[3] = {64, (cuuint32_t)box_rows, 1};
  const cuuint32_t elem[3] = {1, 1, 1};
  return encode_tiled()(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                        const_cast<void*>(ptr), dims, strides, box, elem,
                        CU_TENSOR_MAP_INTERLEAVE_NONE,
                        CU_TENSOR_MAP_SWIZZLE_128B,
                        CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                        CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_tc(const void* q, const void* k, const void* v, void* o,
              void* o_part, void* ml, int BH, int T, int S, int causal,
              int window, float scale, int nsplit, cudaStream_t stream) {
  if (encode_tiled() == nullptr) return (int)cudaErrorNotSupported;
  CUtensorMap mq, mk, mv;
  if (!make_map(&mq, q, BH, T, D, TC_BQ) || !make_map(&mk, k, BH, S, D, TC_BK) ||
      !make_map(&mv, v, BH, S, D, TC_BK))
    return (int)cudaErrorInvalidValue;
  const int bytes = TcCfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc<D>, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return (int)err;
  const int64_t blocks = (int64_t)BH * ((T + TC_BQ - 1) / TC_BQ) * nsplit;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  flash_fwd_tc<D><<<(unsigned)blocks, TC_THREADS, bytes, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), static_cast<float*>(o_part),
      static_cast<float*>(ml), BH, T, S, causal, window, scale * LOG2E,
      nsplit);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// scale: d^-1/2 as the caller rounds it to fp32; causal: 0 or 1;
// window <= 0: no window; dmax: the plan's head-dim tile.
int flash_attention_f32(const void* q, const void* k, const void* v,
                        void* o, int BH, int T, int S, int d, int causal,
                        int window, float scale, int dmax, void* stream) {
  return launch<float>(q, k, v, o, BH, T, S, d, causal, window, scale, dmax,
                       stream);
}

int flash_attention_bf16(const void* q, const void* k, const void* v,
                         void* o, int BH, int T, int S, int d, int causal,
                         int window, float scale, int dmax, void* stream) {
  return launch<__nv_bfloat16>(q, k, v, o, BH, T, S, d, causal, window,
                               scale, dmax, stream);
}

// The tensor-core route: bf16, d = 64 or 128, q/k/v 16-byte aligned. With
// nsplit == 1 it writes o; with nsplit > 1 it writes o_part (nsplit, BH, T,
// d) fp32 and ml (nsplit, BH, T, 2) fp32, which
// flash_attention_combine_bf16 merges into o.
int flash_attention_bf16_tc(const void* q, const void* k, const void* v,
                            void* o, void* o_part, void* ml, int BH, int T,
                            int S, int d, int causal, int window, float scale,
                            int nsplit, void* stream) {
  if (BH < 1 || T < 1 || S < 1 || nsplit < 1 || (d != 64 && d != 128) ||
      (nsplit > 1 && (o_part == nullptr || ml == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return d == 64 ? launch_tc<64>(q, k, v, o, o_part, ml, BH, T, S, causal,
                                 window, scale, nsplit, st)
                 : launch_tc<128>(q, k, v, o, o_part, ml, BH, T, S, causal,
                                  window, scale, nsplit, st);
}

// rows = BH * T
int flash_attention_combine_bf16(const void* o_part, const void* ml, void* o,
                                 int64_t rows, int d, int nsplit,
                                 void* stream) {
  if (rows < 1 || nsplit < 1 || (d != 64 && d != 128))
    return (int)cudaErrorInvalidValue;
  const int64_t blocks = (rows + 7) / 8;
  if (blocks > 0x7fffffff) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const float* op = static_cast<const float*>(o_part);
  const float* mp = static_cast<const float*>(ml);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(o);
  if (d == 64)
    flash_combine<64><<<(unsigned)blocks, 256, 0, st>>>(op, mp, out, rows,
                                                        nsplit);
  else
    flash_combine<128><<<(unsigned)blocks, 256, 0, st>>>(op, mp, out, rows,
                                                         nsplit);
  return (int)cudaGetLastError();
}

}  // extern "C"
