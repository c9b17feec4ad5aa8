// Block-COO IE-table contraction (compressed-topology INTEG), sm_90a.
//
// Replaces: src/repro/kernels/spikemm/gather.py::_gather_pallas
//           (body `_gather_kernel`).
//
// Computes out(M, n_post) = spikes(M, n_pre) @ W, where W is never
// materialised: it is the packed block tables of an encoded topology
// (`GatherTables`), E entries sorted post-block-major, each a dense
// (bk, bn) patch `wblk[t]` at pre block kk[t] and post block jj[t], with
// one inactive sentinel (act[t] == 0) per empty post block. The wrapper
// hands the kernel the entries' offsets per post block (CSR over jj).
//
// What bounds it on an H100: the bytes of the weight patches. Every entry
// is read once (one M tile covers the serving shapes), 4 * bk * bn bytes
// against 2 * M * bk * bn operations, so below about 17 rows the product
// is bytes-bound at the fp32 ridge (67 TFLOP/s over 3.35 TB/s); the banded
// 10^6-neuron net's 94k entries are 384 MB of patches.
//
// One CTA owns one (64-row tile, 64-column tile) of one post block. It
// walks its post block's entries in list order (ascending kk) and each
// entry's bk rows in ascending k, through the register-blocked SGEMM step
// of csrc/spikemm.cu (16-deep tiles of spikes and of the patch in shared
// memory, a 4 x 4 accumulator per thread). The grid is
// (post blocks x ceil(bn / 64), ceil(M / 64)): at the banded net's bk =
// bn = 128 that is 128 CTAs for 64 rows, and at bk = bn = 32 one CTA per
// post block, never one per entry or per row. No split-K, no atomics:
// every output element is one chain over (entry, k) in that order, of
// `acc = __fadd_rn(acc, __fmul_rn(s, w))` with no FMA contraction, which
// the plain version (`gather.py::spikemm_gather_ref`) repeats term for
// term, so on the card the two agree bit for bit, and a row's result does
// not depend on the rows it is batched with.

#include <cuda_runtime.h>
#include <cstdint>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS)
spikemm_gather_kernel(const float* __restrict__ s,
                      const float* __restrict__ wblk,
                      const int32_t* __restrict__ jptr,
                      const int32_t* __restrict__ kk,
                      const int32_t* __restrict__ act,
                      float* __restrict__ out, int M, int n_pre, int n_post,
                      int bk, int bn, int n_tiles) {
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  const int j = blockIdx.x / n_tiles;           // post block
  const int c0 = (blockIdx.x % n_tiles) * BN;   // column inside the block
  const int m0 = blockIdx.y * BM;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int q = 0; q < TN; ++q) acc[i][q] = 0.f;

  const int t_end = jptr[j + 1];
  for (int t = jptr[j]; t < t_end; ++t) {
    if (act[t] == 0) continue;  // the sentinel: block-uniform
    const float* W = wblk + (size_t)t * bk * bn;
    const int p0 = kk[t] * bk;                  // first pre neuron
    for (int k0 = 0; k0 < bk; k0 += BK) {
#pragma unroll
      for (int r = 0; r < (BM * BK) / THREADS; ++r) {
        const int e = tid + r * THREADS;
        const int m = e / BK, k = e % BK;
        const int gm = m0 + m, kb = k0 + k, p = p0 + kb;
        As[k][m] = (gm < M && kb < bk && p < n_pre)
                       ? s[(size_t)gm * n_pre + p] : 0.f;
      }
#pragma unroll
      for (int r = 0; r < (BK * BN) / THREADS; ++r) {
        const int e = tid + r * THREADS;
        const int k = e / BN, n = e % BN;
        const int kb = k0 + k, c = c0 + n;
        Bs[k][n] = (kb < bk && c < bn) ? W[(size_t)kb * bn + c] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int k = 0; k < BK; ++k) {
        float a[TM], b[TN];
#pragma unroll
        for (int i = 0; i < TM; ++i) a[i] = As[k][ty * TM + i];
#pragma unroll
        for (int q = 0; q < TN; ++q) b[q] = Bs[k][tx * TN + q];
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int q = 0; q < TN; ++q)
            acc[i][q] = __fadd_rn(acc[i][q], __fmul_rn(a[i], b[q]));
      }
      __syncthreads();
    }
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= M) continue;
#pragma unroll
    for (int q = 0; q < TN; ++q) {
      const int c = c0 + tx * TN + q;
      const int col = j * bn + c;
      if (c < bn && col < n_post) out[(size_t)gm * n_post + col] = acc[i][q];
    }
  }
}

}  // namespace

extern "C" {

// Rows of one CTA's tile: a launch covers M in ceil(M / 64) grid rows.
int spikemm_gather_block_m() { return BM; }

// jptr: (jb + 1) offsets of each post block's entries; kk, act: (E,);
// wblk: (E, bk, bn) contiguous; out: (M, n_post).
int spikemm_gather_f32(const float* s, const float* wblk, const int32_t* jptr,
                       const int32_t* kk, const int32_t* act, float* out,
                       int M, int n_pre, int n_post, int bk, int bn, int jb,
                       void* stream) {
  const int n_tiles = (bn + BN - 1) / BN;
  dim3 grid(jb * n_tiles, (M + BM - 1) / BM);
  spikemm_gather_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      s, wblk, jptr, kk, act, out, M, n_pre, n_post, bk, bn, n_tiles);
  return (int)cudaGetLastError();
}

}  // extern "C"
