// The register-blocked loop of the spike x weight matmuls, shared by
// `spikemm.cu` (its dense route), `spikemm_sparse.cu` (the product) and
// `spikemm_sessions.cu`, so that all compute every output element as the
// same fmaf chain.
//
// A CTA of NT threads (THREADS unless the caller names another count;
// `spikemm_sessions.cu` takes 128) owns BM = TY * RPT rows and CW columns
// of the output; a thread owns RPT rows, TY apart (so that the two row
// groups of a warp read distinct shared-memory banks), and CPT = CW / TX
// adjacent columns. `ring_product` walks a list of BK-deep steps of k (the
// caller says where each starts) through a ring of STAGES shared-memory
// buffers filled by cp.async, STAGES - 1 steps in flight while one step's
// products run; unless the caller turns SKIP off, a (BM, BK) spike tile
// with no spike is skipped (fmaf(0, w, acc) == acc for finite w, so
// skipping it changes no bit). Each element's chain runs over the steps in
// list order, k ascending within a step.

#pragma once

#include <cuda_runtime.h>
#include <cstdint>

#include "async_copy.cuh"

namespace {

constexpr int THREADS = 256;
constexpr int WARPS = THREADS / 32;
constexpr int BK = 32;                 // depth of a step
constexpr int STAGES = 3;              // steps in shared memory
constexpr unsigned FULL = 0xffffffffu;

template <int CW, int RPT, int NT = THREADS>
struct RingTile {
  static constexpr int TX = CW >= 16 ? 16 : 8;    // threads along columns
  static constexpr int TY = NT / TX;              // threads along rows
  static constexpr int CPT = CW / TX;             // columns per thread
  static constexpr int BM = TY * RPT;             // rows per CTA
  static constexpr int ALD = BK + 4;              // A tile, per row
  // 4-float slots of a step's A (BM x BK) and B (BK x CW) tiles
  static constexpr int A_SLOTS = (BM * BK / 4 + NT - 1) / NT;
  static constexpr int B_SLOTS = (BK * CW / 4 + NT - 1) / NT;
  static constexpr int RING = STAGES * (BM * ALD + BK * CW);   // floats
  static_assert(BM % (NT / 32) == 0 && CPT <= 4, "tile shape");
};

template <int N>
__device__ __forceinline__ void load_vec(float (&dst)[N], const float* p) {
  if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  } else if constexpr (N == 2) {
    const float2 v = *reinterpret_cast<const float2*>(p);
    dst[0] = v.x, dst[1] = v.y;
  } else {
    dst[0] = *p;
  }
}

// acc[i][j] = fmaf(s[m, k], w[k, n], acc[i][j]) for thread (tx, ty) =
// (tid % TX, tid / TX) of NT, its rows m = m0 + ty + TY i and its columns
// n = n0 + tx CPT + j, over k in [k_at(st), k_at(st) + BK) for
// st = 0 .. steps - 1 (k_at block-uniform, a multiple of 4 when vec_s);
// zeros are read past M, K and N. Row m of the raster starts lds floats
// after row m - 1 (K for a raster of its own; a session's rows of a
// (T, S, K) raster are S K apart). `ring` holds RING floats. vec_s /
// vec_w: the raster's / w's rows may be copied 16 bytes at a time (K and
// lds / N a multiple of 4, 16-byte aligned). SKIP: whether a step whose
// spike tile is all zero is skipped (its check costs a block-wide OR a
// step; a caller whose tiles always hold spikes turns it off). Ends with
// no copy of a listed step in flight; a caller that refills the ring or
// what k_at reads afterwards passes a barrier first.
template <int CW, int RPT, int NT = THREADS, bool SKIP = true, class KAt>
__device__ __forceinline__ void ring_product(
    const float* __restrict__ s, const float* __restrict__ w, float* ring,
    int m0, int n0, int M, int K, int N, size_t lds, bool vec_s, bool vec_w,
    int steps,
    KAt k_at, float (&acc)[RPT][RingTile<CW, RPT, NT>::CPT]) {
  using L = RingTile<CW, RPT, NT>;
  constexpr int BM = L::BM, CPT = L::CPT, ALD = L::ALD;
  float* As = ring;                        // [STAGES][BM][ALD]
  float* Bs = ring + STAGES * BM * ALD;    // [STAGES][BK][CW]
  const int tid = threadIdx.x, tx = tid % L::TX, ty = tid / L::TX;
  auto fetch = [&](int st) {
    const int k0 = k_at(st), buf = st % STAGES;
#pragma unroll
    for (int u = 0; u < L::A_SLOTS; ++u) {
      const int e = tid + NT * u;
      if (e >= BM * BK / 4) break;
      const int row = e / (BK / 4), k = k0 + (e % (BK / 4)) * 4;
      const uint32_t dst =
          smem_u32(As + (buf * BM + row) * ALD + (e % (BK / 4)) * 4);
      const bool in = m0 + row < M;
      const float* src = s + (in ? (size_t)(m0 + row) * lds : 0);
      if (vec_s) {
        cp_async16(dst, src + k, in && k < K);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cp_async4(dst + 4 * j, src + k + j, in && k + j < K);
      }
    }
#pragma unroll
    for (int u = 0; u < L::B_SLOTS; ++u) {
      const int e = tid + NT * u;
      if (e >= BK * CW / 4) break;
      const int k = k0 + e / (CW / 4), n = n0 + (e % (CW / 4)) * 4;
      const uint32_t dst = smem_u32(Bs + buf * BK * CW + e * 4);
      const float* src = w + (k < K ? (size_t)k * N : 0);
      if (vec_w) {
        cp_async16(dst, src + n, k < K && n < N);
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j)
          cp_async4(dst + 4 * j, src + n + j, k < K && n + j < N);
      }
    }
  };
  // whether this thread's share of a step's spike tile holds a spike
  auto any_spike = [&](int buf) {
    bool nz = false;
#pragma unroll
    for (int u = 0; u < L::A_SLOTS; ++u) {
      const int e = tid + NT * u;
      if (e >= BM * BK / 4) break;
      float t[4];
      load_vec<4>(t, As + (buf * BM + e / (BK / 4)) * ALD + (e % (BK / 4)) * 4);
      nz |= t[0] != 0.f || t[1] != 0.f || t[2] != 0.f || t[3] != 0.f;
    }
    return nz;
  };
#pragma unroll
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) fetch(st);
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    const int buf = st % STAGES;
    cp_async_wait<STAGES - 2>();       // this thread's copies of step st
    // every copy of step st is in and step st - 1 is done: skip a (BM, BK)
    // block with no spike, refill the buffer step st - 1 used
    bool live_step = true;
    if constexpr (SKIP)
      live_step = __syncthreads_or(any_spike(buf));
    else
      __syncthreads();
    if (st + STAGES - 1 < steps) fetch(st + STAGES - 1);
    cp_async_commit();
    if (!live_step) continue;
    const float* A = As + (buf * BM + ty) * ALD;
    const float* B = Bs + buf * BK * CW + tx * CPT;
#pragma unroll
    for (int k4 = 0; k4 < BK; k4 += 4) {
      float a[RPT][4];
#pragma unroll
      for (int i = 0; i < RPT; ++i) load_vec<4>(a[i], A + i * L::TY * ALD + k4);
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        float bv[CPT];
        load_vec<CPT>(bv, B + (k4 + u) * CW);
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[i][j] = fmaf(a[i][u], bv[j], acc[i][j]);
      }
    }
  }
}

}  // namespace
