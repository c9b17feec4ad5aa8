// Event-gated spike x weight matmul (FINDIDX + LOCACC) for sm_90a.
//
// Replaces: src/repro/kernels/spikemm/kernel.py::spikemm_pallas
//           (body `_spikemm_kernel`), the dense channel.
//
// Computes out(M, N) = spikes(M, K) @ w(K, N) in fp32. A (BM, BK) block
// of the spike raster whose occupancy flag is 0 is skipped: neither its
// spike tile nor its weight tile is loaded, and no FMA runs for it.
//
// What bounds it on an H100: the operations. At the serving shape
// (2048 x 700) @ (700 x 256) the product is 0.73 GFLOP against 8.6 MB of
// traffic, ~85 FLOP/byte, above the fp32 CUDA-core ridge (67 TFLOP/s over
// 3.35 TB/s = 20 FLOP/byte). The design is the plain register-blocked
// SGEMM: each 256-thread block owns one 64 x 64 output tile, walks K in
// 16-deep steps through shared memory, and each thread keeps a 4 x 4
// accumulator in registers. No TF32 and no bf16: the spikes are exact in
// any format, the weights are not.
//
// Determinism: every output element is one fmaf chain over k = 0..K-1 in
// increasing order. There is no split-K and there are no atomics. A
// skipped block contributes exactly what fmaf(0, w, acc) = acc would, so
// a row's result does not depend on what the other rows of its block
// hold. That is what the serve engine's isolation invariant (a session is
// bit-identical alone or packed with strangers) needs from this kernel.
//
// Ragged edges (M = 2048, K = 700, N = 20 on the serving path) are masked
// in the loads and the store; nothing is padded in device memory.

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
spikemm_kernel(const float* __restrict__ s, const float* __restrict__ w,
               const int32_t* __restrict__ flags, float* __restrict__ out,
               int M, int K, int N, int nkb) {
  // +4 words of padding keep the transposed spike-tile stores from all
  // landing in one shared-memory bank
  __shared__ float As[BK][BM + 4];
  __shared__ float Bs[BK][BN];

  const int tid = threadIdx.x;
  const int ty = tid / (BN / TN);
  const int tx = tid % (BN / TN);
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int32_t* row_flags = flags + (size_t)blockIdx.y * nkb;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int kb = 0; kb < nkb; ++kb) {
    if (row_flags[kb] == 0) continue;  // block-uniform: the skip is safe
    const int k0 = kb * BK;
    // spike tile, consecutive threads on consecutive k (contiguous in s)
#pragma unroll
    for (int r = 0; r < (BM * BK) / THREADS; ++r) {
      const int e = tid + r * THREADS;
      const int m = e / BK, k = e % BK;
      const int gm = m0 + m, gk = k0 + k;
      As[k][m] = (gm < M && gk < K) ? s[(size_t)gm * K + gk] : 0.f;
    }
    // weight tile, consecutive threads on consecutive n (contiguous in w)
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

// Occupancy block shape the kernel skips at; the wrapper builds the flags
// (ceil(M / BM), ceil(K / BK)) int32 at exactly this shape.
int spikemm_block_m() { return BM; }
int spikemm_block_k() { return BK; }

int spikemm_f32(const float* s, const float* w, const int32_t* flags,
                float* out, int M, int K, int N, void* stream) {
  const int nkb = (K + BK - 1) / BK;
  dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  spikemm_kernel<<<grid, THREADS, 0, (cudaStream_t)stream>>>(
      s, w, flags, out, M, K, N, nkb);
  return (int)cudaGetLastError();
}

}  // extern "C"
