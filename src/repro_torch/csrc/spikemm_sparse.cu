// Block-sparse spike x weight matmul over a compacted block list, sm_90a.
//
// Replaces: src/repro/kernels/spikemm/sparse.py::spikemm_sparse_pallas
//           (body `_sparse_kernel`, list from `compact_blocks`).
//
// Computes out(M, N) = spikes(M, K) @ w(K, N) in fp32, visiting only the
// (BM, SBK) spike blocks that hold an event. The block shape is
// `SPARSE_BLOCK` of kernels/_build.py, passed in as -DSPIKEMM_SPARSE_BM and
// -DSPIKEMM_SPARSE_BK; the static_asserts below refuse a shape the tiling
// cannot take. The wrapper
// compacts the occupancy bitmap into a row-major list of occupied
// (i, k) blocks with one inactive sentinel per silent row block
// (`compact_blocks`, as in the JAX package) and hands the kernel the
// list's row offsets (CSR over i), the k index and the active flag of
// each entry.
//
// What bounds it on an H100: the bytes of the raster, of the weight rows
// of the occupied block columns and of the output, or the operations its
// events need (one multiply-add per spike and output column), whichever
// is larger; the kernel's own tile is the register-blocked SGEMM tile of
// csrc/spikemm.cu, so each occupied block costs what a flagged block costs
// the dense kernel, and a silent block costs nothing, not even a flag
// read. Making it fast (tensor cores, TMA) is later work.
//
// One CTA owns one (BM-row block, 64-column N tile). It walks its row
// block's entries in list order, i.e. in ascending k, and for each active
// one runs four 16-deep steps of the dense kernel's inner loop. A row
// block with no entry but its sentinel writes zeros. No split-K, no
// atomics: every output element is one fmaf chain over the occupied k in
// increasing order, with the dense kernel's per-element arithmetic. A
// skipped block holds only zero spikes, and fmaf(0, w, acc) == acc for
// finite w (acc is never -0), so on the card this channel equals the
// dense kernel bit for bit: it skips only silent work.

#include <cuda_runtime.h>
#include <cstdint>

#if !defined(SPIKEMM_SPARSE_BM) || !defined(SPIKEMM_SPARSE_BK)
#error "built by kernels/_build.py, which passes SPARSE_BLOCK as -D flags"
#endif

namespace {

constexpr int BM = SPIKEMM_SPARSE_BM;   // output rows of a CTA = block rows
constexpr int BN = 64;
constexpr int BK = 16;                  // depth of one shared-memory step
constexpr int SBK = SPIKEMM_SPARSE_BK;  // block depth: SBK / BK steps
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256 at BM = 64

static_assert(SBK > 0 && SBK % BK == 0, "a block is whole steps deep");
static_assert(BM > 0 && BM % TM == 0 && THREADS <= 1024 &&
                  (BM * BK) % THREADS == 0 && (BK * BN) % THREADS == 0,
              "BM must tile the CTA's threads and its shared-memory loads");

__global__ void __launch_bounds__(THREADS)
spikemm_sparse_kernel(const float* __restrict__ s, const float* __restrict__ w,
                      const int32_t* __restrict__ row_ptr,
                      const int32_t* __restrict__ idx_k,
                      const int32_t* __restrict__ active,
                      float* __restrict__ out, int M, int K, int N) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  const int t_end = row_ptr[blockIdx.y + 1];
  for (int t = row_ptr[blockIdx.y]; t < t_end; ++t) {
    if (active[t] == 0) continue;  // the sentinel: block-uniform
    const int kb0 = idx_k[t] * SBK;
    for (int k0 = kb0; k0 < kb0 + SBK && k0 < K; k0 += BK) {
#pragma unroll
      for (int r = 0; r < (BM * BK) / THREADS; ++r) {
        const int e = tid + r * THREADS;
        const int m = e / BK, k = e % BK;
        const int gm = m0 + m, gk = k0 + k;
        As[k][m] = (gm < M && gk < K) ? s[(size_t)gm * K + gk] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < (BK * BN) / THREADS; ++r) {
        const int e = tid + r * THREADS;
        const int k = e / BN, n = e % BN;
        const int gk = k0 + k, gn = n0 + n;
        Bs[k][n] = (gk < K && gn < N) ? w[(size_t)gk * N + gn] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
#pragma unroll
        for (int j = 0; j < TN; ++j) b[j] = Bs[k][tx * TN + j];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < N) out[(size_t)gm * N + gn] = acc[i][j];
    }
  }
}

}  // namespace

extern "C" {

// The wrapper builds the flags (ceil(M / BM), ceil(K / SBK)) at the block
// shape these were built with.
// row_ptr: (ceil(M / BM) + 1) offsets of each row block's entries in the
// row-major compacted list; idx_k, active: (n,) per entry.
int spikemm_sparse_f32(const float* s, const float* w, const int32_t* row_ptr,
                       const int32_t* idx_k, const int32_t* active, float* out,
                       int M, int K, int N, void* stream) {
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  spikemm_sparse_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      s, w, row_ptr, idx_k, active, out, M, K, N);
  return (int)cudaGetLastError();
}

}  // extern "C"
