// The gather's backward (B6), sm_90a: a dense cotangent against the
// transposed IE tables.
//
// Replaces: src/repro/kernels/spikemm/gather.py::_bwd (the custom VJP's
//           backward, `_gather_pallas` on the transposed tables).
//
// Computes d_spikes(M, n_pre) = g(M, n_post) @ W^T, where the caller hands
// the kernel the forward tables' transpose (`GatherTables.transpose()`: E
// entries sorted post-block-major, each a (bk, bn) patch `wblk[t]` at pre
// block kk[t]; below, n_pre, n_post, bk and bn are the transposed
// tables', so g is (M, n_pre) and the output (M, n_post)). g is dense: a
// cotangent has no zeros for an event walk to skip (the forward kernel,
// `spikemm_gather.cu`, lists events; on g it lists every nonzero patch row
// and reads each again for every 4 rows of g).
//
// What bounds it on an H100: the issue of the terms. Every output element
// is a chain of separately rounded multiplies and adds (no FMA, no tensor
// core: see below), two fp32 issues a term; the terms it needs are its
// column's nonzero weights. At train_banded's backward (1024 rows, the
// 8192-neuron band of +-64, 129 weights a column) that is 1.08 G terms,
// ~0.065 ms at 132 SMs x 128 lanes x 1.98 GHz; the bytes (g and the output,
// 32 MB each, 12.5 MB of patches) take ~0.023 ms.
//
// Design. A CTA owns BM rows of g (16 x RPT, RPT = 1, 2 or 4) and one
// 32-column slab of one post block; the grid is (post blocks x slabs, M /
// BM), `gather_bwd_plan` in kernels/spikemm/gather.py picks RPT. It walks
// a list of steps, each 32 patch rows k of one entry: the CTA's post
// block's entries in list order and, in each, the 32-row words ascending,
// only those whose (32 x 32) sub-tile of the patch at the CTA's slab holds
// a nonzero weight (`GatherTables.tile_mask`; the lists, `bwd_steps`, are
// built once on the host and memoised on the device with the other
// tables). Each step's g tile (BM x 32, the g columns of the entry's pre
// neurons) and patch tile (32 x 32) go through a 2-stage cp.async ring in
// shared memory, the next step's copies in flight while this one's terms
// run. A thread owns RPT rows (16 apart) x 4 adjacent columns and adds
// them in registers: each weight it loads from shared memory serves RPT
// rows, and each g value 4 columns. Against the band the slabs walk 160
// patch rows for the 129 terms a column needs (whole patch rows, 256).
//
// Determinism and bit equality: every output element is one chain
// acc = __fadd_rn(acc, __fmul_rn(g, w)) from +0, over its post block's
// entries in list order and each entry's k ascending, the order of the
// plain version (`gather.py::spikemm_gather_ref` on the transposed tables,
// `spikemm_gather_bwd_ref`), which adds every term. A term the walk skips
// has w = +-0 (a sub-tile of zeros, a sentinel entry, a row past bk), or
// g = +-0 read as a zero fill past n_pre; for finite g and W it is +-0,
// and __fadd_rn(acc, +-0) == acc, since acc starts at +0 and never
// becomes -0 (an exact zero sum rounds to +0). So B6 is bit for bit its
// plain version. A row's result does not depend on the rows beside it:
// no split over k, no atomics.
//
// Ragged edges (M, bk, bn, n_pre, n_post not multiples of anything) are
// masked in the copies (zero fill) and the store; nothing is padded in
// device memory.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int THREADS = 128;
constexpr int TX = 8;                 // threads along the slab's columns
constexpr int TY = THREADS / TX;      // threads along rows
constexpr int SLAB = 32;              // columns a CTA (GATHER_BWD_SLAB)
constexpr int BK = 32;                // patch rows a step (a bitmap word)
constexpr int CPT = SLAB / TX;        // columns a thread
constexpr int STAGES = 2;             // steps in shared memory
constexpr int ALD = BK + 4;           // g tile, floats a row

template <int RPT>
struct BwdTile {
  static constexpr int BM = TY * RPT;                    // rows a CTA
  static constexpr int A_SLOTS = BM * BK / 4 / THREADS;  // 16-byte slots
  static constexpr int B_SLOTS = BK * SLAB / 4 / THREADS;
  static constexpr int RING = STAGES * (BM * ALD + BK * SLAB);   // floats
  static_assert(A_SLOTS * THREADS * 4 == BM * BK &&
                B_SLOTS * THREADS * 4 == BK * SLAB, "tile shape");
};

template <int RPT>
__global__ void __launch_bounds__(THREADS)
gather_bwd_kernel(const float* __restrict__ g, const float* __restrict__ wblk,
                  const int32_t* __restrict__ sptr,
                  const int32_t* __restrict__ steps,
                  const int32_t* __restrict__ kk, float* __restrict__ out,
                  int M, int n_pre, int n_post, int bk, int bn, int words,
                  int slabs) {
  using L = BwdTile<RPT>;
  constexpr int BM = L::BM;
  extern __shared__ __align__(16) float smem[];
  float* As = smem;                          // [STAGES][BM][ALD]
  float* Bs = smem + STAGES * BM * ALD;      // [STAGES][BK][SLAB]
  const int tid = threadIdx.x, tx = tid % TX, ty = tid / TX;
  const int b = blockIdx.x, j = b / slabs, c0 = (b - j * slabs) * SLAB;
  const int m0 = blockIdx.y * BM;
  const int first = sptr[b], n = sptr[b + 1] - first;
  // 16-byte copies of g's rows (a step's first column is a multiple of 4
  // where bk is) and of the patch rows (c0 is a multiple of 32)
  const bool vec_g = n_pre % 4 == 0 && bk % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const bool vec_w = bn % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(wblk) % 16 == 0;

  auto fetch = [&](int st) {
    const int code = __ldg(steps + first + st);
    const int t = code / words, k0 = (code - t * words) * BK;
    const int rows = min(BK, bk - k0);       // patch rows of this step
    const int p0 = __ldg(kk + t) * bk + k0;  // g's column of its row 0
    const int buf = st % STAGES;
#pragma unroll
    for (int u = 0; u < L::A_SLOTS; ++u) {
      const int e = tid + THREADS * u;
      const int r = e / (BK / 4), q = (e % (BK / 4)) * 4;
      const uint32_t dst = smem_u32(As + (buf * BM + r) * ALD + q);
      const bool in = m0 + r < M;
      const float* src = g + (in ? (size_t)(m0 + r) * n_pre : 0) + p0 + q;
      if (vec_g) {
        cp_async16(dst, src, in && q < rows && p0 + q < n_pre);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          cp_async4(dst + 4 * c, src + c,
                    in && q + c < rows && p0 + q + c < n_pre);
      }
    }
#pragma unroll
    for (int u = 0; u < L::B_SLOTS; ++u) {
      const int e = tid + THREADS * u;
      const int k = e / (SLAB / 4), q = (e % (SLAB / 4)) * 4;
      const uint32_t dst = smem_u32(Bs + (buf * BK + k) * SLAB + q);
      const float* src =
          wblk + ((size_t)t * bk + k0 + (k < rows ? k : 0)) * bn + c0 + q;
      if (vec_w) {
        cp_async16(dst, src, k < rows && c0 + q < bn);
      } else {
#pragma unroll
        for (int c = 0; c < 4; ++c)
          cp_async4(dst + 4 * c, src + c, k < rows && c0 + q + c < bn);
      }
    }
  };

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int c = 0; c < CPT; ++c) acc[i][c] = 0.f;

#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < n) fetch(st);
    cp_async_commit();
  }
  for (int st = 0; st < n; ++st) {
    const int buf = st % STAGES;
    cp_async_wait<STAGES - 2>();     // this thread's copies of step st
    __syncthreads();                 // everyone's; step st - 1 is done
    if (st + STAGES - 1 < n) fetch(st + STAGES - 1);
    cp_async_commit();
    const float* A = As + (buf * BM + ty) * ALD;
    const float* B = Bs + buf * BK * SLAB + tx * CPT;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float a[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float4 v = *reinterpret_cast<const float4*>(A + i * TY * ALD +
                                                          k4);
        a[i][0] = v.x, a[i][1] = v.y, a[i][2] = v.z, a[i][3] = v.w;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const float4 v =
            *reinterpret_cast<const float4*>(B + (k4 + u) * SLAB);
        const float w[CPT] = {v.x, v.y, v.z, v.w};
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int c = 0; c < CPT; ++c)
            acc[i][c] = __fadd_rn(acc[i][c], __fmul_rn(a[i][u], w[c]));
      }
    }
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + ty + TY * i;
    if (m >= M) continue;
#pragma unroll
    for (int c = 0; c < CPT; ++c) {
      const int col = c0 + tx * CPT + c, gc = j * bn + col;
      if (col < bn && gc < n_post) out[(size_t)m * n_post + gc] = acc[i][c];
    }
  }
}

template <int RPT>
int launch(dim3 grid, cudaStream_t st, const float* g, const float* wblk,
           const int32_t* sptr, const int32_t* steps, const int32_t* kk,
           float* out, int M, int n_pre, int n_post, int bk, int bn,
           int words, int slabs) {
  constexpr int SMEM = BwdTile<RPT>::RING * 4;
  cudaError_t err = cudaFuncSetAttribute(
      gather_bwd_kernel<RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return (int)err;
  gather_bwd_kernel<RPT><<<grid, THREADS, SMEM, st>>>(
      g, wblk, sptr, steps, kk, out, M, n_pre, n_post, bk, bn, words, slabs);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// The transposed tables' patches wblk (E, bk, bn) and pre blocks kk (E,);
// the step lists of `GatherTables.bwd_steps`: sptr (jb x slabs + 1)
// offsets into steps, whose entries are t * ceil(bk / 32) + word for
// (post block, 32-column slab) b = j * slabs + slab, slabs = ceil(bn /
// 32); g (M, n_pre) and out (M, n_post) contiguous. rows (RPT) is
// `gather_bwd_plan`'s: 1, 2 or 4. Anything else is refused.
int spikemm_gather_bwd_f32(const float* g, const float* wblk,
                           const int32_t* sptr, const int32_t* steps,
                           const int32_t* kk, float* out, int M, int n_pre,
                           int n_post, int bk, int bn, int jb, int rows,
                           void* stream) {
  if (M <= 0 || n_pre <= 0 || n_post <= 0 || bk <= 0 || bn <= 0 || jb <= 0)
    return (int)cudaErrorInvalidValue;
  const int words = (bk + BK - 1) / BK;
  const int slabs = (bn + SLAB - 1) / SLAB;
  const long long gx = (long long)jb * slabs;
  const long long gy = (M + (long long)TY * rows - 1) / ((long long)TY * rows);
  if (gx > INT_MAX || gy > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  const cudaStream_t st = (cudaStream_t)stream;
  switch (rows) {
    case 1: return launch<1>(grid, st, g, wblk, sptr, steps, kk, out, M,
                             n_pre, n_post, bk, bn, words, slabs);
    case 2: return launch<2>(grid, st, g, wblk, sptr, steps, kk, out, M,
                             n_pre, n_post, bk, bn, words, slabs);
    case 4: return launch<4>(grid, st, g, wblk, sptr, steps, kk, out, M,
                             n_pre, n_post, bk, bn, words, slabs);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // extern "C"
