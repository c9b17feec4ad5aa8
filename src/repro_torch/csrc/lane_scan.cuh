// The scans whose parallelism is their lanes, staged through shared memory
// by cp.async: one thread owns one (b, n) lane of a (T, B, N) tensor and
// walks its T steps with its state in registers. `linrec.cu` (the DIFF
// recurrence), `lif.cu` (LIF) and `alifrec.cu`'s feed-forward `alif` run
// their chains through `lane_scan` below; the wrappers size the CTAs and
// the ring with `kernels/common.py::lane_plan`.
//
// The chain of such a scan is short (a rounded product and sum a step,
// then, for the neurons, a compare and the reset), so what holds it back
// first is memory: a load a step waits for a round trip, and loads issued
// a few steps ahead still wait once every few steps. Here a thread's
// lane's values of NP planes (the input, a decay plane) are copied
// LS_CHUNK steps at a time into a ring of LS_STAGES stages, LS_STAGES - 1
// chunks in flight while the chain runs over the oldest, the copies of a
// chunk interleaved with the chain's steps. Once memory is off the chain,
// a step costs its dependent chain and the instructions a lone warp issues
// around it (a shared load, a copy, a store). Steps past T are not copied:
// a partial chunk's chain never reads their slots.
//
// Slots are [stage][plane][step][thread], so a warp's reads of one step
// fill the 32 banks; the CTA's width is a template constant, so a slot's
// offset is one too. Two layouts of the copies:
// - a lane a thread: each step of a chunk is one coalesced 128-byte copy
//   of the warp, 4 bytes a thread, which needs no alignment (rows of
//   N = 6, 20 or 130 floats). A thread reads back only the slots it
//   copied, and `cp.async.wait_group` makes a thread's own copies visible
//   to it, so the ring needs no barrier and lanes past the tensor's end
//   may simply leave.
// - VEC (rows of whole warps, the input 16-byte aligned: `lane_vec`): the
//   input is copied by the warp together, 16 bytes a thread, four steps of
//   its 32 lanes an instruction, a quarter of the copies and of their
//   address arithmetic, and the prologue's copies shrink the same way. A
//   thread then reads slots that others copied, so the warp passes a
//   __syncwarp before each chunk; every warp that runs is whole.
//
// LANE_SCAN_CHUNK and LANE_SCAN_STAGES come from `kernels/_build.py`
// (-D flags), their one definition; the wrappers size the ring's shared
// memory from them.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>
#include <type_traits>

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

// The ring of one thread's lane in a CTA of THREADS threads, NP planes;
// `lane_scan` drives it. VEC (rows of whole warps, plane 0 16-byte
// aligned: `lane_vec`): plane 0 is copied by the warp together, 16 bytes
// a thread, so that one copy instruction of the warp moves four steps of
// its 32 lanes; thread l copies lanes 4 (l % 8) .. 4 (l % 8) + 3 of step
// 4 k + l / 8 in the k-th copy of a chunk, and a thread reads slots other
// threads of its warp copied, after a __syncwarp. The other planes (a
// decay plane) are copied a lane a thread.
template <int NP, int THREADS, bool VEC>
struct LaneRing {
  float* col;               // this thread's column: smem + threadIdx.x
  float* vcol;              // VEC: its 16-byte group's column in plane 0
  const float* src[NP];     // plane p's value of this lane at the next copy
                            // (VEC plane 0: the group's at its next copy)
  int64_t step[NP];         // elements from one step of plane p to the next
  int T;
  int chunks;
  int next_c;               // the chunk the next copies fill
  int next_t;               // its first step
  int vq;                   // VEC: the step of a 4-step copy it fills

  __device__ LaneRing(float* smem, const float* const (&base)[NP],
                      const int64_t (&stride)[NP], int T_)
      : col(smem + threadIdx.x), T(T_),
        chunks((T_ + LS_CHUNK - 1) / LS_CHUNK), next_c(0), next_t(0) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      src[p] = base[p];
      step[p] = stride[p];
    }
    if constexpr (VEC) {
      const int lane = threadIdx.x & 31, g = 4 * (lane & 7);
      vq = lane >> 3;
      vcol = smem + vq * THREADS + (threadIdx.x - lane) + g;
      src[0] = base[0] - lane + g + vq * stride[0];
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
  // VEC: where the copy of steps u .. u + 3 of plane 0 puts its 16 bytes
  __device__ __forceinline__ uint32_t vslot(int u) const {
    return smem_u32(vcol + (next_c & (LS_STAGES - 1)) *
                               (NP * LS_CHUNK * THREADS) + u * THREADS);
  }

  __device__ __forceinline__ bool done() const { return next_c >= chunks; }
  __device__ __forceinline__ bool whole() const {
    return next_t + LS_CHUNK <= T;
  }

  // Step u of chunk next_c, which lies inside T (VEC plane 0: steps u ..
  // u + 3 at each u that is a multiple of 4).
  __device__ __forceinline__ void copy_whole(int u) {
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (VEC && p == 0) {
        if (u % 4 == 0) {
          cp_async16(vslot(u), src[0], true);
          src[0] += 4 * step[0];
        }
      } else {
        cp_async4(slot(p, u), src[p], true);
        src[p] += step[p];
      }
    }
  }

  // Step u of chunk next_c, if that chunk exists and the step lies inside
  // T; a source never moves past step T - 1, inside the tensor.
  __device__ __forceinline__ void copy(int u) {
    if (done()) return;
#pragma unroll
    for (int p = 0; p < NP; ++p) {
      if (VEC && p == 0) {
        const int t = next_t + u + vq;
        if (u % 4 == 0 && t < T) {
          cp_async16(vslot(u), src[0], true);
          if (t + 4 < T) src[0] += 4 * step[0];
        }
      } else {
        const int t = next_t + u;
        if (t < T) {
          cp_async4(slot(p, u), src[p], true);
          if (t + 1 < T) src[p] += step[p];
        }
      }
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
};

// Whether a scan over `lanes` lanes takes the ring's VEC layout: rows of
// whole warps (no warp holds a lane past the end, so every thread of a
// live warp takes part in its copies and barriers) and plane 0 (`x`, of
// time stride `lanes`) 16-byte aligned.
inline bool lane_vec(const float* x, int64_t lanes) {
  return lanes % 32 == 0 && reinterpret_cast<uintptr_t>(x) % 16 == 0;
}

// Runs a lane's chain over its T steps: `step(in, u)` for step u of each
// chunk, with in[p][u] plane p's value there (registers: the chunk's
// values are read from its stage before its first step, so the chain's
// stores never wait behind a shared load). While the chain runs over
// chunk c, chunk c + LS_STAGES - 1 is copied into the stage chunk c - 1
// was read from, one step's copies between two steps of the chain (a warp
// issues in order: a block of copies before the chain would stall it).
template <int NP, int THREADS, bool VEC, class Step>
__device__ __forceinline__ void lane_scan(LaneRing<NP, THREADS, VEC>& ring,
                                          Step&& step) {
  ring.start();
  for (int c = 0; c < ring.chunks; ++c) {
    cp_async_wait<LS_STAGES - 2>();         // chunk c's copies have landed
    // VEC: and the warp's (which also finished reading chunk c - 1, whose
    // stage the copies below refill)
    if (VEC) __syncwarp();
    const float* st = ring.stage(c);
    float in[NP][LS_CHUNK];
#pragma unroll
    for (int p = 0; p < NP; ++p)
#pragma unroll
      for (int u = 0; u < LS_CHUNK; ++u)
        in[p][u] = st[(p * LS_CHUNK + u) * THREADS];
    const int n = ring.T - c * LS_CHUNK;    // steps of chunk c inside T
    if (n >= LS_CHUNK && !ring.done() && ring.whole()) {
#pragma unroll
      for (int u = 0; u < LS_CHUNK; ++u) {
        step(in, u);
        ring.copy_whole(u);                 // fills the chain's gaps
      }
    } else if (n >= LS_CHUNK && ring.done()) {
#pragma unroll
      for (int u = 0; u < LS_CHUNK; ++u) step(in, u);
    } else {
#pragma unroll
      for (int u = 0; u < LS_CHUNK; ++u) {
        if (u < n) step(in, u);
        ring.copy(u);
      }
    }
    ring.commit();
  }
  cp_async_wait<0>();                       // the groups left are empty
}

// The neurons' compare as a value (PTX `set`, one instruction): 1.0f
// where a >= b, else 0.0f (a NaN gives 0.0f), i.e. the plain versions'
// spike s; and 1 - s, 1.0f where a < b or either is NaN. A predicate and
// a select in its place would put a longer wait on the chain.
__device__ __forceinline__ float set_ge(float a, float b) {
  float d;
  asm("set.ge.f32.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}
__device__ __forceinline__ float set_ltu(float a, float b) {
  float d;
  asm("set.ltu.f32.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// The instantiation of a lane scan: CTAs of 1, 2 or 4 warps (`lane_plan`'s
// choice) and the ring's layout. Calls f(std::integral_constant<int,
// threads>, std::bool_constant<vec>).
template <class F>
int with_lane_layout(int warps, bool vec, F&& f) {
  auto go = [&](auto threads) {
    return vec ? f(threads, std::true_type{}) : f(threads, std::false_type{});
  };
  switch (warps) {
    case 1:
      return go(std::integral_constant<int, 32>{});
    case 2:
      return go(std::integral_constant<int, 64>{});
    case 4:
      return go(std::integral_constant<int, 128>{});
  }
  return (int)cudaErrorInvalidValue;
}

// Launches a lane scan's kernel over `lanes` lanes in CTAs of THREADS
// threads, with the ring's NP planes in `stages` stages of dynamic shared
// memory (above 48 KB through the opt-in). Returns cudaGetLastError().
template <int THREADS, int NP, class... P, class... A>
int launch_lane_scan(void (*kernel)(P...), int64_t lanes, int stages,
                     cudaStream_t stream, A... args) {
  const size_t smem = lane_ring_bytes(THREADS, NP, stages);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int64_t blocks = (lanes + THREADS - 1) / THREADS;
  kernel<<<(unsigned)blocks, THREADS, smem, stream>>>(args...);
  return (int)cudaGetLastError();
}

}  // namespace
