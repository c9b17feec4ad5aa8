// Block-sparse spike x weight matmul, sm_90a: two launches, no host sync.
//
// Replaces: src/repro/kernels/spikemm/sparse.py::spikemm_sparse_pallas
//           (body `_sparse_kernel`, list from `compact_blocks`).
//
// Computes out(M, N) = spikes(M, K) @ w(K, N) in fp32, visiting only the
// (BM, SBK) spike blocks that hold an event. The block shape is
// `SPARSE_BLOCK` of kernels/_build.py, passed in as -DSPIKEMM_SPARSE_BM and
// -DSPIKEMM_SPARSE_BK; the static_asserts below refuse a shape the tiling
// cannot take.
//
// 1. `spikemm_occupancy_kernel` measures the occupancy: flags (Mb, Kb)
//    int32, 1 where the block holds a nonzero (ragged edges count as
//    zero-padded blocks), and total (1,), the number of occupied blocks.
//    It replaces no TPU kernel: the JAX package's `block_occupancy` is jnp
//    that XLA fuses; here a reduction of that size costs about fifteen
//    PyTorch launches. One CTA a block reads its 64 rows of 64 floats
//    (16-byte loads where K and the raster's alignment allow, all issued
//    before any is tested), ORs them across the CTA (__syncthreads_or) and
//    writes the block's flag; `total` takes an integer atomicAdd per
//    occupied block, exact in any order, after a 4-byte memset on the
//    stream. Bound: the raster's bytes (33.5 MB at the sparse_integ path's
//    hidden INTEG, 10 us at 3.35 TB/s); 2048 CTAs there fill 132 SMs.
// 2. `spikemm_sparse_kernel` is the product. A CTA owns T x T outputs
//    inside one block row: T = 64 (a thread 4 x 4) where the output has
//    rows and columns enough for a CTA an SM, else T = 16 (a thread one
//    output), so that a narrow readout or a few occupied block rows still
//    spread over the card (`sparse_tile` in kernels/spikemm/sparse.py).
//    The CTA lists its block row's occupied k blocks in shared memory in
//    ascending k (__ballot_sync and __popc over the flag row, LIST at a
//    time): entry for entry the JAX `compact_blocks` row for that block.
//    It then walks them through the spike matmuls' ring (`ring_product`,
//    spikemm_ring.cuh: 32-deep steps, a 3-stage cp.async ring that flows
//    from one listed block into the next, a step with no spike in the
//    CTA's rows skipped). A block row with no occupied block lists none
//    and writes zeros, as the JAX list's sentinel does.
//
// What bounds the product on an H100: the bytes of the raster, of the
// weight rows of the occupied block columns and of the output, or the
// operations its events need (one multiply-add per spike and output
// column), whichever is larger. A CTA spends what the dense kernel's
// register-blocked loop spends on the same steps; a silent block costs it
// one flag read. What holds it above that bound: at 4 x 4 a thread reads
// 8 floats from shared memory for 16 products a k, and shared memory
// delivers one float a lane a cycle, so the loop runs at half the fp32
// rate at most; a larger thread tile leaves too few warps where few
// block rows are occupied (88 tiles of 64 x 64 at the sparse_integ path's
// hidden INTEG, one an SM), and the chain rules out split-K.
//
// No split-K, no atomics on the output, no TF32 or tensor cores (the
// weights are exact in neither): every output element is one fmaf chain
// from +0 over the k of its occupied blocks in ascending order, with the
// dense kernel's per-element arithmetic. A skipped block holds only zero
// spikes, and fmaf(0, w, acc) == acc for finite w (acc is never -0), so on
// the card this channel equals the dense kernel (csrc/spikemm.cu) bit for
// bit: it skips only silent work.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

#include "spikemm_ring.cuh"

#if !defined(SPIKEMM_SPARSE_BM) || !defined(SPIKEMM_SPARSE_BK)
#error "built by kernels/_build.py, which passes SPARSE_BLOCK as -D flags"
#endif

namespace {

constexpr int BM = SPIKEMM_SPARSE_BM;   // rows of a block = of a flag row
constexpr int SBK = SPIKEMM_SPARSE_BK;  // depth of a block
constexpr int SPB = SBK / BK;           // ring steps a block
constexpr int LIST = 1024;              // k blocks a CTA lists at once

static_assert(SBK > 0 && SBK % BK == 0, "a block is whole ring steps deep");
static_assert((BM * SBK / 4) % THREADS == 0,
              "a block is whole 16-byte loads for every thread");
static_assert(LIST % THREADS == 0, "the list is built THREADS flags a pass");

__global__ void __launch_bounds__(THREADS)
spikemm_occupancy_kernel(const float* __restrict__ s,
                         int32_t* __restrict__ flags,
                         int32_t* __restrict__ total, int M, int K, int Kb) {
  constexpr int QR = SBK / 4;                  // 16-byte loads a block row
  constexpr int VEC = BM * QR / THREADS;       // of them a thread
  constexpr int ONE = BM * SBK / THREADS;      // 4-byte loads a thread
  const int b = blockIdx.x, i = b / Kb, kb = b % Kb;
  const int m0 = i * BM, k0 = kb * SBK, tid = threadIdx.x;
  bool nz = false;
  if (K % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0) {
    float4 v[VEC];
#pragma unroll
    for (int r = 0; r < VEC; ++r) {
      const int e = tid + r * THREADS;
      const int m = m0 + e / QR, k = k0 + (e % QR) * 4;
      const float4* p = reinterpret_cast<const float4*>(s + (size_t)m * K + k);
      v[r] = m < M && k < K ? __ldg(p) : make_float4(0.f, 0.f, 0.f, 0.f);
    }
#pragma unroll
    for (int r = 0; r < VEC; ++r)
      nz |= v[r].x != 0.f || v[r].y != 0.f || v[r].z != 0.f || v[r].w != 0.f;
  } else {
    float v[ONE];
#pragma unroll
    for (int r = 0; r < ONE; ++r) {
      const int e = tid + r * THREADS;
      const int m = m0 + e / SBK, k = k0 + e % SBK;
      v[r] = m < M && k < K ? __ldg(s + (size_t)m * K + k) : 0.f;
    }
#pragma unroll
    for (int r = 0; r < ONE; ++r) nz |= v[r] != 0.f;
  }
  const int any = __syncthreads_or(nz);
  if (tid == 0) {
    flags[b] = any;
    if (any) atomicAdd(total, 1);
  }
}

// Lists the occupied k blocks of frow[kw, kw + len) in list[0, n) in
// ascending k (a ballot a warp, then each warp's count) and returns n, the
// same in every thread. Passes a barrier before it writes anything, so no
// thread still reads the list or the ring of the window before.
__device__ __forceinline__ int list_blocks(const int32_t* __restrict__ frow,
                                           int kw, int len, int* list,
                                           int* warp_n) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  int n = 0;
  for (int c = 0; c < len; c += THREADS) {
    const int j = c + tid;
    const bool occ = j < len && frow[kw + j] != 0;
    const unsigned bits = __ballot_sync(FULL, occ);
    __syncthreads();
    if (lane == 0) warp_n[warp] = __popc(bits);
    __syncthreads();
    int at = n + __popc(bits & ((1u << lane) - 1u));
    for (int q = 0; q < WARPS; ++q) {
      at += q < warp ? warp_n[q] : 0;
      n += warp_n[q];
    }
    if (occ) list[at] = kw + j;
  }
  __syncthreads();
  return n;
}

// The CTA's tile: T x T outputs, T = 64 (a thread 4 x 4) or 16 (a thread
// one output).
template <int T>
__global__ void __launch_bounds__(THREADS, 2)
spikemm_sparse_kernel(const float* __restrict__ s, const float* __restrict__ w,
                      const int32_t* __restrict__ flags,
                      float* __restrict__ out, int M, int K, int N, int Kb) {
  constexpr int RPT = T / RingTile<T, 1>::TY;
  using L = RingTile<T, RPT>;
  constexpr int CPT = L::CPT;
  static_assert(L::BM == T && BM % T == 0,
                "a CTA's rows lie in one block row");
  extern __shared__ __align__(16) float smem[];
  float* ring = smem;                                       // [L::RING]
  int* list = reinterpret_cast<int*>(smem + L::RING);       // [LIST]
  __shared__ int warp_n[WARPS];

  const int tid = threadIdx.x, tx = tid % L::TX, ty = tid / L::TX;
  const int m0 = blockIdx.y * T, n0 = blockIdx.x * T;
  const int32_t* frow = flags + (size_t)(m0 / BM) * Kb;
  const bool vec_s = K % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0;
  const bool vec_w = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  for (int kw = 0; kw < Kb; kw += LIST) {
    const int n = list_blocks(frow, kw, min(LIST, Kb - kw), list, warp_n);
    ring_product<T, RPT>(
        s, w, ring, m0, n0, M, K, N, K, vec_s, vec_w, n * SPB,
        [&](int st) { return list[st / SPB] * SBK + st % SPB * BK; }, acc);
  }

#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int m = m0 + ty + L::TY * i;
    if (m >= M) continue;
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const int n = n0 + tx * CPT + j;
      if (n < N) out[(size_t)m * N + n] = acc[i][j];
    }
  }
}

template <int T>
int launch_product(const float* s, const float* w, const int32_t* flags,
                   float* out, int M, int K, int N, cudaStream_t st) {
  using L = RingTile<T, T / RingTile<T, 1>::TY>;
  constexpr int SMEM = (L::RING + LIST) * 4;
  const int rows = (M + T - 1) / T;
  if (rows > 65535) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      spikemm_sparse_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + T - 1) / T, rows);
  spikemm_sparse_kernel<T><<<grid, THREADS, SMEM, st>>>(
      s, w, flags, out, M, K, N, (K + SBK - 1) / SBK);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// flags (ceil(M / BM), ceil(K / SBK)) int32 and total (1,) int32 of the
// raster s (M, K), at the block shape these were built with.
int spikemm_occupancy_f32(const float* s, int32_t* flags, int32_t* total,
                          int M, int K, void* stream) {
  if (M < 0 || K < 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  cudaError_t err = cudaMemsetAsync(total, 0, sizeof(int32_t), st);
  if (err != cudaSuccess) return (int)err;
  const long long Kb = (K + SBK - 1) / SBK;
  const long long blocks = (M + BM - 1) / BM * Kb;
  if (blocks > INT_MAX) return (int)cudaErrorInvalidValue;
  if (blocks > 0)
    spikemm_occupancy_kernel<<<(unsigned)blocks, THREADS, 0, st>>>(
        s, flags, total, M, K, (int)Kb);
  return (int)cudaGetLastError();
}

// out (M, N) = s (M, K) @ w (K, N) over the blocks `flags` marks, on
// CTAs of tile x tile outputs (64 or 16), as
// kernels/spikemm/sparse.py::sparse_tile picks it.
int spikemm_sparse_f32(const float* s, const float* w, const int32_t* flags,
                       float* out, int M, int K, int N, int tile,
                       void* stream) {
  if (M < 1 || N < 1 || K < 0 || (tile != 16 && tile != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  return tile == 64 ? launch_product<64>(s, w, flags, out, M, K, N, st)
                    : launch_product<16>(s, w, flags, out, M, K, N, st);
}

}  // extern "C"
