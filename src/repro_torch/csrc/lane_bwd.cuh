// The segment skeleton of the lane backward kernels, shared by
// `lif_bwd.cu` (B1, `lif_bwd_f32`) and `alif_bwd.cu` (B5, `alif_bwd_f32`):
// the STBP adjoints of a feed-forward neuron scan, whose lanes (b, n) are
// independent and whose time is a serial chain. `linrec_bwd.cu` (B2) takes
// its clock stamps and its 16-byte copy rule from here.
//
// A CTA owns 32 lanes (a warp's width): a chain warp, whose thread l
// carries lane l's state in registers, and three helper warps. Time is cut
// into segments of SEG steps (LANE_BWD_SEG, from kernels/_build.py, its
// one definition); a segment's planes live in shared memory,
// [plane][step][lane], so a warp's reads of one step fill the 32 banks.
// What the kernels share, here:
//   load_planes  all four warps copy a segment's steps of some planes by
//                cp.async, 16 bytes (four lanes) a copy where the planes
//                allow (`vec`), else a lane a copy; one commit group;
//   store_plane  all four warps write a segment's plane out, coalesced;
//   arrive,      the per-lane partials (B, N), summed over B in ascending
//   sum_over_b   b by the kernel's last CTA to finish (a counter of the
//                stream at 0, an acquire-release add), so that the wrapper
//                launches nothing after the kernel; the order of
//                `kernels/lifrec/ref.py::sum_rows_ascending`;
//   PASS_CLK     cycles by phase, in a build where the including file
//                names its stamp array LANE_BWD_CLK (its own
//                -D..._PASS_CLOCKS flag); else nothing.
// Each kernel keeps its own forward, surrogate and reverse steps.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "async_copy.cuh"

#ifndef LANE_BWD_SEG
#error "lane_bwd.cuh needs -DLANE_BWD_SEG (kernels/_build.py passes it)"
#endif

// Cycles by phase: thread 0 of block b adds the clock64() cycles of each
// phase k (after the barrier that ends it) into its register and writes
// them to LANE_BWD_CLK[PASS_CLK_SLOTS b + k] at the end, the whole
// kernel's in the last slot; the reader LANE_BWD_CLK_READER(name) defines
// copies them out (`chip_smoke.py` builds the stamped kernels beside the
// library). Without LANE_BWD_CLK the stamps compile to nothing.
constexpr int PASS_CLK_SLOTS = 8;
#ifdef LANE_BWD_CLK
constexpr int PASS_CLK_BLOCKS = 65536;
__device__ long long LANE_BWD_CLK[PASS_CLK_SLOTS * PASS_CLK_BLOCKS];
#define PASS_CLK_BEGIN                                        \
  long long clk_at = clock64(), clk_first = clk_at;           \
  long long clk_sum[PASS_CLK_SLOTS - 1] = {}
#define PASS_CLK(k)                                           \
  do {                                                        \
    const long long now = clock64();                          \
    clk_sum[k] += now - clk_at;                               \
    clk_at = now;                                             \
  } while (0)
#define PASS_CLK_END                                                   \
  if (threadIdx.x == 0 && blockIdx.x < PASS_CLK_BLOCKS) {              \
    long long* dst = LANE_BWD_CLK + PASS_CLK_SLOTS * blockIdx.x;       \
    for (int k = 0; k < PASS_CLK_SLOTS - 1; ++k) dst[k] = clk_sum[k];  \
    dst[PASS_CLK_SLOTS - 1] = clock64() - clk_first;                   \
  }
#define LANE_BWD_CLK_READER(name)                                      \
  extern "C" int name(long long* dst, int n) {                         \
    if (n < 0 || n > PASS_CLK_SLOTS * PASS_CLK_BLOCKS)                 \
      return (int)cudaErrorInvalidValue;                               \
    return (int)cudaMemcpyFromSymbol(dst, LANE_BWD_CLK,                \
                                     n * sizeof(long long));           \
  }
#else
#define PASS_CLK_BEGIN
#define PASS_CLK(k)
#define PASS_CLK_END
#define LANE_BWD_CLK_READER(name)
#endif

namespace {

constexpr int SEG = LANE_BWD_SEG;          // steps a segment
constexpr int WARPS = 4;                   // the chain warp and 3 helpers
constexpr int THREADS = 32 * WARPS;
constexpr int GQ = 4;                      // surrogates a thread at once
static_assert(SEG > 0, "a segment of steps");
// the phases the clock stamps sum (chip_smoke.py's LANE_BWD_PHASES); the
// last, the wait for the cotangent after the surrogate, is `lif_bwd`'s
enum { CLK_LOAD, CLK_FORWARD, CLK_G, CLK_REVERSE, CLK_STORE, CLK_SUMS,
       CLK_GS_WAIT };

__device__ __forceinline__ float* at(float* sm, int plane, int u) {
  return sm + (plane * SEG + u) * 32;
}

// All four warps copy steps t0 .. t0 + n - 1 of NP planes (src[i] into
// plane pl[i]) of the CTA's 32 lanes from `base` on into shared memory:
// 16 bytes (four lanes) a copy where `vec`, else a lane; lanes past the
// tensor's end read zeros. One commit group.
template <int NP>
__device__ __forceinline__ void load_planes(float* sm, bool vec,
                                            int64_t lanes, int64_t base,
                                            int t0, int n,
                                            const float* const (&src)[NP],
                                            const int (&pl)[NP]) {
  if (vec) {
    for (int e = threadIdx.x; e < n * NP * 8; e += THREADS) {
      const int row = e / 8, q = e % 8, u = row / NP, i = row % NP;
      const int64_t col = base + 4 * q;
      const bool in = col < lanes;
      cp_async16(smem_u32(at(sm, pl[i], u) + 4 * q),
                 src[i] + (int64_t)(t0 + u) * lanes + (in ? col : 0), in);
    }
  } else {
    for (int e = threadIdx.x; e < n * NP * 32; e += THREADS) {
      const int row = e / 32, l = e % 32, u = row / NP, i = row % NP;
      const int64_t col = base + l;
      const bool in = col < lanes;
      cp_async4(smem_u32(at(sm, pl[i], u) + l),
                src[i] + (int64_t)(t0 + u) * lanes + (in ? col : 0), in);
    }
  }
  cp_async_commit();
}

// All four warps write steps t0 .. t0 + n - 1 of the segment's plane
// `plane` to dst (T, B, N) at the CTA's lanes, coalesced.
__device__ __forceinline__ void store_plane(float* sm, int plane, float* dst,
                                            bool vec, int64_t lanes,
                                            int64_t base, int t0, int n) {
  if (vec) {
    for (int e = threadIdx.x; e < n * 8; e += THREADS) {
      const int u = e / 8, q = e % 8;
      const int64_t col = base + 4 * q;
      if (col < lanes)
        *reinterpret_cast<float4*>(dst + (int64_t)(t0 + u) * lanes + col) =
            *reinterpret_cast<const float4*>(at(sm, plane, u) + 4 * q);
    }
  } else {
    for (int e = threadIdx.x; e < n * 32; e += THREADS) {
      const int64_t col = base + e % 32;
      if (col < lanes)
        dst[(int64_t)(t0 + e / 32) * lanes + col] = at(sm, plane, 0)[e];
    }
  }
}

// The chain warp, once its lanes' partials are written: counts its CTA
// done on `count`, a counter of the stream at 0, by one acquire-release
// add of lane 0 after the warp's barrier (the release publishes the
// lanes' partials to the grid, the acquire the others' to the last CTA,
// as a semaphore does); `last` (shared memory) is then true in the CTA
// that counted last, for every thread past the next barrier. It runs
// while the helper warps store the last segment.
__device__ __forceinline__ void arrive(unsigned* count, bool& last) {
  __syncwarp();
  if (threadIdx.x == 0) {
    unsigned old;
    asm volatile("atom.acq_rel.gpu.add.u32 %0, [%1], 1;"
                 : "=r"(old) : "l"(count) : "memory");
    last = old == gridDim.x - 1;
  }
}

// NQ outputs (N,) of the per-lane partials part (NQ, B, N), each summed
// over B in ascending b, ((p[0] + p[1]) + p[2]) + ..., by every thread of
// the last CTA (`arrive`, then a barrier), each sum's rows read from L2
// at once; a null dst[i] is skipped. The last CTA sets the counter back
// to 0 for the next launch on the stream.
template <int NQ>
__device__ __forceinline__ void sum_over_b(const float* part,
                                           float* const (&dst)[NQ],
                                           unsigned* count, bool last,
                                           int64_t lanes, int B, int N) {
  if (!last) return;
  constexpr int BB = 64;                   // loads in flight a thread
  for (int q = threadIdx.x; q < NQ * N; q += THREADS) {
    // output q / N, picked by selects (no indexed local array)
    float* out = dst[0];
    const float* src = part + q % N;
#pragma unroll
    for (int i = 1; i < NQ; ++i)
      if (q >= i * N) {
        out = dst[i];
        src = part + i * lanes + q % N;
      }
    if (!out) continue;
    float sum = __ldcg(src);
    for (int b0 = 1; b0 < B; b0 += BB) {
      float x[BB];
#pragma unroll
      for (int j = 0; j < BB; ++j)
        x[j] = b0 + j < B ? __ldcg(src + (int64_t)(b0 + j) * N) : 0.f;
#pragma unroll
      for (int j = 0; j < BB; ++j)
        if (b0 + j < B) sum = __fadd_rn(sum, x[j]);
    }
    out[q % N] = sum;
  }
  if (threadIdx.x == 0) *count = 0;        // ready for the next launch
}

// Whether a call's planes take the 16-byte copies: whole groups of four
// lanes (B N % 4 == 0) and every plane 16-byte aligned.
template <class... P>
inline bool lane_bwd_vec(int64_t lanes, const P*... planes) {
  return lanes % 4 == 0 && (((uintptr_t)planes | ...) % 16) == 0;
}

// The planes' dynamic shared memory, past the default 48 KB with the
// kernels' static `last`: take the opt-in, then launch.
template <class Kernel, class Args>
inline int launch_lane_bwd(Kernel kernel, size_t smem, int64_t lanes,
                           const Args& args, void* stream) {
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int64_t blocks = (lanes + 31) / 32;
  kernel<<<(unsigned)blocks, THREADS, smem, (cudaStream_t)stream>>>(args);
  return (int)cudaGetLastError();
}

}  // namespace
