// The spike x weight matmul with a session axis, sm_90a: a learning serve
// window's plastic INTEG.
//
// Replaces: src/repro/kernels/spikemm/kernel.py::spikemm_pallas under the
//           JAX serve engine's per-session `vmap` (kernel 1 with a session
//           axis).
//
// Computes out(T, S, N): out[t, s] = spikes[t, s] @ w[s] in fp32, for S
// sessions each with its own weight w (S, K, N) and its rows of one
// (T, S, K) raster (row t S + s for session s, read in place: no
// transposed copy).
//
// What bounds it on an H100: bytes. Every session's weight is read whole
// (at serve_plastic's window, (32, 64, 256) @ (64, 256, 128) at 15 %
// input, W is 8.4 MB of the 11.5 MB the call moves: 3.4 us), since each
// (32, 32) spike block of a session's rows holds a spike. A window's
// sessions share nothing, so no weight is read twice by the function.
//
// Design. A CTA of 128 threads owns one session's rows (BM of them, the
// least tile that holds the window's T rows) and one column slab of CW
// columns (8 to 64: narrower slabs where S x column tiles would leave SMs
// idle); the grid is (N / CW, T / BM, S), `kernels/spikemm/ops.py::
// session_tile` picks (BM, CW). The CTA reads its slab of W[s] from
// device memory once, K in 32-deep steps through `spikemm_ring.cuh`'s
// 3-stage cp.async ring (the loop of the unbatched kernel's dense route),
// its rows of the raster through the same ring, and adds them in
// registers. There is no event list: a serve window's spikes meet every
// row of W[s], so listing them (FINDIDX, then LOCACC's loads of each
// event's weight row, as the unbatched kernel does) reads W[s] more than
// once and leaves the rows of a tile sized for the unbatched call idle.
// Nor does the ring look for all-zero (BM, 32) spike blocks to skip: at
// 15 % input there are none, and the check costs a block-wide OR a step.
// What is left after the bytes is the products' reads of shared memory:
// 128 threads (not the unbatched kernel's 256) give a thread 4 rows of a
// 32-row tile, so each weight it reads serves 4 rows (the 256-thread tile
// measured slower than `torch.bmm` at serve_plastic's window).
//
// Determinism and bit equality: every output element is one fmaf chain
// acc = fmaf(s[t, k], w[k, n], acc), acc from +0, over every k ascending,
// the chain of `spikemm.cu`'s two routes (which skip only terms with
// s = 0: fmaf(0, w, acc) == acc for finite w, acc never -0). So each
// session's result is, bit for bit,
// `spikemm_chain_ref` on its rows (`spikemm_sessions_chain_ref`), the
// unbatched kernel on its rows alone, and the same at any S: an element
// depends on nothing but its row and its session's weight (no split-K,
// no atomics). That is the serve engine's isolation invariant.
//
// Ragged edges (T, K, N not multiples of the tile) are masked in the loads
// and the store; nothing is padded in device memory.

#include <cuda_runtime.h>
#include <cstdint>

#include "spikemm_ring.cuh"

namespace {

constexpr int NT = 128;                // threads a CTA

template <int CW, int RPT>
__global__ void __launch_bounds__(NT)
spikemm_sessions_kernel(const float* __restrict__ s,
                        const float* __restrict__ w, float* __restrict__ out,
                        int T, int K, int N, int S) {
  using L = RingTile<CW, RPT, NT>;
  constexpr int CPT = L::CPT;
  extern __shared__ __align__(16) float ring[];
  const int tid = threadIdx.x, tx = tid % L::TX, ty = tid / L::TX;
  const int m0 = blockIdx.y * L::BM, n0 = blockIdx.x * CW;
  const size_t lds = (size_t)S * K, ldo = (size_t)S * N;
  // the session's rows (S K floats apart), its weight and its output rows
  s += (size_t)blockIdx.z * K;
  w += (size_t)blockIdx.z * K * N;
  out += (size_t)blockIdx.z * N;
  const bool vec_s = K % 4 == 0 && lds % 4 == 0 &&
                     reinterpret_cast<uintptr_t>(s) % 16 == 0;
  const bool vec_w = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;
  ring_product<CW, RPT, NT, false>(s, w, ring, m0, n0, T, K, N, lds, vec_s,
                                   vec_w, (K + BK - 1) / BK,
                                   [](int st) { return st * BK; }, acc);

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + ty + L::TY * i;
    if (m >= T) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int n = n0 + tx * CPT + j;
      if (n < N) out[(size_t)m * ldo + n] = acc[i][j];
    }
  }
}

template <int CW, int RPT>
int launch(const float* s, const float* w, float* out, int T, int K, int N,
           int S, cudaStream_t stream) {
  using L = RingTile<CW, RPT, NT>;
  constexpr int SMEM = L::RING * 4;
  cudaError_t err = cudaFuncSetAttribute(
      spikemm_sessions_kernel<CW, RPT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + CW - 1) / CW, (T + L::BM - 1) / L::BM, S);
  spikemm_sessions_kernel<CW, RPT><<<grid, NT, SMEM, stream>>>(
      s, w, out, T, K, N, S);
  return (int)cudaGetLastError();
}

// rows per CTA bm = TY * RPT: TY = 8 (16 at the 8-wide slab)
template <int CW>
int launch_cw(const float* s, const float* w, float* out, int T, int K,
              int N, int S, int bm, cudaStream_t st) {
  constexpr int TY = RingTile<CW, 1, NT>::TY;
  switch (bm / TY) {
    case 1: return launch<CW, 1>(s, w, out, T, K, N, S, st);
    case 2: return launch<CW, 2>(s, w, out, T, K, N, S, st);
    case 4: return launch<CW, 4>(s, w, out, T, K, N, S, st);
    default: return launch<CW, 8>(s, w, out, T, K, N, S, st);
  }
}

}  // namespace

extern "C" {

// s (T, S, K), w (S, K, N), out (T, S, N), contiguous; the CTA's tile as
// kernels/spikemm/ops.py::session_tile picks it: cw columns (8, 16, 32 or
// 64), bm rows (a power of two from 8 to 64, or from 16 to 128 when cw =
// 8). Anything else is refused.
int spikemm_sessions_f32(const float* s, const float* w, float* out, int T,
                         int K, int N, int S, int bm, int cw, void* stream) {
  const int least = cw == 8 ? 16 : 8;
  if (T < 1 || N < 1 || K < 0 || S < 1 || S > 65535 || bm < least ||
      bm > 8 * least || (bm & (bm - 1)) ||
      (cw != 8 && cw != 16 && cw != 32 && cw != 64) ||
      (T + bm - 1) / bm > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cw) {
    case 8: return launch_cw<8>(s, w, out, T, K, N, S, bm, st);
    case 16: return launch_cw<16>(s, w, out, T, K, N, S, bm, st);
    case 32: return launch_cw<32>(s, w, out, T, K, N, S, bm, st);
    default: return launch_cw<64>(s, w, out, T, K, N, S, bm, st);
  }
}

}  // extern "C"
