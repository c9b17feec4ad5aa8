// A lane's time series staged through shared memory by cp.async, for the
// scans whose parallelism is their lanes: one thread owns one (b, d) lane
// of a (T, B, D) tensor and walks its T steps in a register (`linrec.cu`;
// `lif.cu` and `alifrec.cu`'s feed-forward `alif` run the same loop).
//
// The chain of such a scan is short (a rounded product and a rounded sum
// a step), so what holds it back is memory: a load a step waits for a
// round trip, and loads issued a few steps ahead still wait once every
// few steps. Here a thread copies its lane's values of NP planes (the
// input, a decay plane) for LS_CHUNK steps at a time into a ring of
// LS_STAGES stages, and keeps LS_STAGES - 1 chunks in flight while it
// runs the chain over the oldest, the copies of a chunk interleaved with
// the chain's steps (a lone warp's issue slots are what a step costs once
// memory is off the chain). Lanes are adjacent across a warp, so
// each step of a chunk is one coalesced 128-byte copy of a warp; the
// 4-byte copies need no alignment (rows of D = 6, 20 or 130 floats).
//
// A thread reads back only the slots it copied, and
// `cp.async.wait_group` makes a thread's own copies visible to it, so the
// ring needs no barrier and lanes past the tensor's end may simply leave.
// Slots are [stage][plane][step][thread], so a warp's copies and reads of
// one step fill the 32 banks; the CTA's width is a template constant, so
// a slot's offset is one too.
//
// LANE_SCAN_CHUNK and LANE_SCAN_STAGES come from `kernels/_build.py`
// (-D flags), their one definition; the wrappers size the ring's shared
// memory from them (`lane_ring_bytes`).

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "async_copy.cuh"

#ifndef LANE_SCAN_CHUNK
#error "lane_scan.cuh needs -DLANE_SCAN_CHUNK (kernels/_build.py passes it)"
#endif
#ifndef LANE_SCAN_STAGES
#error "lane_scan.cuh needs -DLANE_SCAN_STAGES (kernels/_build.py passes it)"
#endif

namespace {

constexpr int LS_CHUNK = LANE_SCAN_CHUNK;    // steps a stage holds
constexpr int LS_STAGES = LANE_SCAN_STAGES;  // stages of the ring
static_assert(LS_STAGES >= 2 && (LS_STAGES & (LS_STAGES - 1)) == 0,
              "a ring of a power of two stages, at least two");

// Stages a scan of T steps needs: the ring, or fewer when T fits in fewer
// chunks (chunk c always lands in stage c % LS_STAGES).
__host__ __device__ inline int lane_ring_stages(int T) {
  const int chunks = (T + LS_CHUNK - 1) / LS_CHUNK;
  return chunks < LS_STAGES ? chunks : LS_STAGES;
}

// Dynamic shared memory of a CTA of `threads` threads staging `planes`
// planes in `stages` stages.
inline size_t lane_ring_bytes(int threads, int planes, int stages) {
  return (size_t)threads * planes * stages * LS_CHUNK * sizeof(float);
}

// The ring of one thread's lane in a CTA of THREADS threads, NP planes.
// Use: start(); then for each chunk c: wait(), read its values (`stage`),
// and while the chain runs over them, copy the chunk LS_STAGES - 1 ahead
// into the stage chunk c - 1 was read from, one step's copies between two
// steps of the chain (a warp issues in order: a block of copies before
// the chain would stall it): copy_whole(u) where that chunk lies inside T
// (`whole()`), copy(u) for the last one, nothing once `done()`; then
// commit().
template <int NP, int THREADS>
struct LaneRing {
  float* col;               // this thread's column: smem + threadIdx.x
  const float* src[NP];     // plane p's value of this lane at the next copy
  int64_t step[NP];         // elements from one step of plane p to the next
  int T;
  int chunks;
  int next_c;               // the chunk the next copies fill
  int next_t;               // its first step

  __device__ LaneRing(float* smem, const float* const (&base)[NP],
                      const int64_t (&stride)[NP], int T_)
      : col(smem + threadIdx.x), T(T_),
        chunks((T_ + LS_CHUNK - 1) / LS_CHUNK), next_c(0), next_t(0) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      src[p] = base[p];
      step[p] = stride[p];
    }
  }

  // chunk c's stage: plane p's step u at stage(c)[(p * LS_CHUNK + u) *
  // THREADS]
  __device__ __forceinline__ float* stage(int c) const {
    return col + (c & (LS_STAGES - 1)) * (NP * LS_CHUNK * THREADS);
  }
  __device__ __forceinline__ uint32_t slot(int p, int u) const {
    return smem_u32(stage(next_c) + (p * LS_CHUNK + u) * THREADS);
  }

  __device__ __forceinline__ bool done() const { return next_c >= chunks; }
  __device__ __forceinline__ bool whole() const {
    return next_t + LS_CHUNK <= T;
  }

  // Step u of chunk next_c, which lies inside T.
  __device__ __forceinline__ void copy_whole(int u) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      cp_async4(slot(p, u), src[p], true);
      src[p] += step[p];
    }
  }

  // Step u of chunk next_c, if that chunk exists. Steps past T copy
  // nothing (`in` false) and the source stays on step T - 1, inside the
  // tensor.
  __device__ __forceinline__ void copy(int u) {
    if (done()) return;
    const int t = next_t + u;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      cp_async4(slot(p, u), src[p], t < T);
      if (t + 1 < T) src[p] += step[p];
    }
  }

  // Closes chunk next_c's copies as one group; past the last chunk the
  // group is empty, so that group counts stay the same to the end.
  __device__ __forceinline__ void commit() {
    cp_async_commit();
    ++next_c;
    next_t += LS_CHUNK;
  }

  // Before the first chunk: the first LS_STAGES - 1 chunks in flight.
  __device__ __forceinline__ void start() {
#pragma unroll 1
    for (int s = 0; s < LS_STAGES - 1; ++s) {
      if (!done() && whole()) {
#pragma unroll
        for (int u = 0; u < LS_CHUNK; ++u) copy_whole(u);
      } else {
#pragma unroll
        for (int u = 0; u < LS_CHUNK; ++u) copy(u);
      }
      commit();
    }
  }

  // Before reading chunk c (the c-th call): its copies have landed.
  __device__ __forceinline__ void wait() const {
    cp_async_wait<LS_STAGES - 2>();
  }

  // At the end: nothing left in flight (the groups left are empty).
  __device__ __forceinline__ void finish() const { cp_async_wait<0>(); }
};

}  // namespace
