// B3, spikemm's weight gradient, for sm_90a: g_w = spikes^T g, its
// reduction over the raster's rows split into chunks.
//
// Replaces: the JAX package's custom VJP of spikemm, whose g_w is its
//           Pallas spike kernel on the transposed raster:
//           src/repro/kernels/spikemm/ops.py:186 `_bwd` (g_w at :192).
//
// Computes out (K, N) = sum over r of s[r, k] g[r, n], r = 0 .. R - 1 (the
// forward's T B rows), reading the raster (R, K) and g (R, N) in their own
// layouts, so nothing is transposed or copied first. Raster row r is
// head[r] for r < H and body[r - H] above: H = 0 for the forward's raster;
// the recurrent g_W's one-step-shifted raster [s0; s_0 .. s_{T-2}] is
// head = s0 (H = B) and body = the spikes plane, with no `cat`.
//
// What bounds it on an H100: the bytes, the raster, g and the output read
// or written once (ECG input, 4 x 3200 @ 3200 x 64: 0.26 us; the SHD
// hidden layer, 700 x 2880 @ 2880 x 256: 3.5 us); the events' operations,
// 2 nnz(s) N, lie under them. The product has few outputs (K N: 256 to
// 180K) and a long reduction (R: 2880 to 3200). Kernel 1 on the
// transposed raster, the route this kernel replaces, tiles the output
// only: 1 to 4 CTAs and 3200-deep chains on the ECG shapes.
//
// Design: the reduction split twice, over the CTAs of a thread block
// cluster and over groups of threads in a CTA, each chunk of rows walked
// by one group from shared memory, the chunks' partials combined in the
// cluster.
//   tile     (`wgrad_tile` in kernels/spikemm/wgrad.py) small products,
//            K <= 64: the largest tile of BM (8 to 64) output rows and CW
//            (8 to 128) columns whose tiles still make 64 CTAs, so that
//            the rows stream into 64 SMs and not into a few; a group of
//            T = BM CW / (4 CPT) threads (32 to 256; CPT = 2, or CW / 16
//            above 32 columns) computes it densely, 4 x CPT outputs a
//            thread, and a CTA of 256 threads holds G = 256 / T groups.
//            Over 64 rows (the SHD hidden layer, the ALIF net's input):
//            64-row tiles of up to 128 columns, one group a CTA, its 8
//            warps each walking the events of 8 output rows.
//   split    chunks of L rows (`wgrad_chunk`, a multiple of 16, a
//            function of the shapes alone): chunk q = c G + g is walked by
//            group g of CTA c of the tile's cluster of 8 CTAs (the grid's
//            z), so a tile has up to 8 G chunks.
//   ring     a step is BK rows (16, 32 for one or two groups a CTA) of
//            every group's chunk: the raster block (BK rows x BM columns,
//            read along the raster's rows: the transpose is in the
//            indexing, not in a copy) and the g block (BK rows x CW) of
//            each group are copied into shared memory by cp.async, four
//            steps in a ring; a step whose raster blocks hold no spike is
//            skipped (`__syncthreads_or`). Dense groups: each thread runs
//            its 4 x CPT chains over the step's rows in ascending order,
//            two vector reads of shared memory a row. Event tiles: a
//            warp ballots the step's rows with a spike among its 8 output
//            rows and, for each in ascending order, adds its nonzero
//            spikes times the row of g (warp-uniform branches).
//   combine  the groups' partials go to a (chunks, K, N) scratch; after a
//            cluster barrier (its release and acquire order the writes
//            before the reads) each thread of the cluster reads every
//            chunk's partial of its outputs at once and adds them in
//            ascending chunk order. No atomics, no counters, one launch.
// Designs tried before this one, measured on the H100 (`PERF.md` § 6): a
// warp walking its rows' events with g's rows read from global memory
// (a memory round trip, 1-2 us there, each listed row), one 256-thread
// CTA a tile with one output a thread (a shared-memory read a product),
// a combine by the last CTA to finish (a fence, a counter and the
// partials' loads, each a round trip), and combines through distributed
// shared memory (one thread an output: its remote loads one after
// another; a warp an output: slower still): 11-55 us at the training
// shapes.
//
// Determinism and bit equality: each output's partial is one chain
// acc = fmaf(s, g, acc) from +0 over its chunk's rows in ascending r (a
// skipped step's spikes are all 0: fmaf(0, g, acc) == acc for finite g,
// and acc never becomes -0); the output is ((p_0 + p_1) + p_2) + ... +
// p_{C-1}, one rounded add each in ascending chunk order. The split
// depends on (R, K, N) alone, not on the SM count or on timing, so the
// same inputs give the same bits on any card. `spikemm_wgrad_chain_ref`
// (kernels/spikemm/ref.py) is the same chunks and combine in plain
// PyTorch, built on `spikemm_chain_ref`: for 0/1 spikes each product is
// exact, so each of its adds rounds once, as fmaf does. No TF32, no
// library call.

#include <cuda_runtime.h>
#include <cstdint>

#include <cooperative_groups.h>

#include "async_copy.cuh"

namespace cg = cooperative_groups;

// Cycles by phase, in a build with -DWGRAD_PASS_CLOCKS (`chip_smoke.py`
// makes one beside the library): thread 0 of block b adds the clock64()
// cycles of each phase into its registers and writes them to
// wgrad_pass_clk[8 b + k] at the end (k: 0 the waits for a step's copies
// and its barrier, 1 the copies' issue, 2 the products, 3 the partial's
// stores and the cluster barrier (one chunk: the output's stores), 4 the
// steps computed, not skipped (a count), 5 the combine's loads, sums and
// stores, 7 the whole kernel); `wgrad_pass_clocks` copies them out.
// Without the flag the stamps compile to nothing.
#ifdef WGRAD_PASS_CLOCKS
__device__ long long wgrad_pass_clk[8 * 65536];
#define WCLK_BEGIN \
  long long wclk_at = clock64(), wclk_first = wclk_at, wclk[6] = {}
#define WCLK_LIVE ++wclk[4]
#define WCLK(k)                                                 \
  do {                                                          \
    const long long now = clock64();                            \
    wclk[k] += now - wclk_at;                                   \
    wclk_at = now;                                              \
  } while (0)
#define WCLK_END                                                        \
  if (threadIdx.x == 0) {                                               \
    const unsigned b = blockIdx.x + gridDim.x * (blockIdx.y +           \
                                                  gridDim.y * blockIdx.z); \
    if (b < 65536) {                                                    \
      for (int k = 0; k < 6; ++k) wgrad_pass_clk[8 * b + k] = wclk[k];  \
      wgrad_pass_clk[8 * b + 7] = clock64() - wclk_first;               \
    }                                                                   \
  }
extern "C" int wgrad_pass_clocks(long long* dst, int n) {
  if (n < 0 || n > 8 * 65536) return (int)cudaErrorInvalidValue;
  return (int)cudaMemcpyFromSymbol(dst, wgrad_pass_clk,
                                   n * sizeof(long long));
}
#else
#define WCLK_BEGIN
#define WCLK(k)
#define WCLK_LIVE
#define WCLK_END
#endif

namespace {

constexpr int THREADS = 256;
constexpr int STAGES = 4;              // steps in the ring
constexpr int MAX_CLUSTER = 8;         // a portable cluster's CTAs
constexpr int RT = 4;                  // output rows a thread

// A group's tile: BM x CW outputs, TX threads along the columns (CPT
// each), TY along the rows (RT each); G groups a CTA; a step's blocks in a
// stage, [group][row][column], rows padded to ALD / BLD floats.
template <int BM, int CW>
struct Tile {
  static constexpr int CPT = CW <= 32 ? 2 : CW / 16;
  static constexpr int TX = CW / CPT;
  static constexpr int TY = BM / RT;
  static constexpr int T = TX * TY;
  static constexpr int G = THREADS / T;
  static constexpr int BK = G <= 2 ? 32 : 16;   // rows of a chunk a step
  // a 64-row tile of one group walks its events (`events` below): a warp
  // 8 output rows, a lane CW / 32 columns
  static constexpr bool EVENTS = G == 1 && BM == 64 && CW % 32 == 0;
  static constexpr int KPW = 8;                // output rows a warp (events)
  static constexpr int NC = CW / 32;
  static constexpr int ALD = BM + 4;
  static constexpr int BLD = CW + 4;
  static constexpr int STAGE = G * BK * (ALD + BLD);     // floats
  static constexpr int SMEM = STAGES * STAGE;
  static_assert(T % 32 == 0 && THREADS % T == 0, "whole warps a group");
  static_assert(G * BM * CW <= SMEM, "the partials fit in the ring");
};

struct WgradArgs {
  const float* head;   // (H, K): the raster's first H rows, or null
  const float* body;   // its rows from H on, at least R - H of them
  const float* g;      // (R, N)
  float* out;          // (K, N)
  float* part;         // (chunks, K, N) partials, chunks > 1
  int H, R, K, N, L, C;
  bool vec_s;          // K % 4 == 0, head and body 16-byte aligned
  bool vec_g;          // N % 4 == 0, g 16-byte aligned
};

template <int N>
__device__ __forceinline__ void lds(float (&dst)[N], const float* p) {
  if constexpr (N >= 4) {
#pragma unroll
    for (int q = 0; q < N; q += 4) {
      const float4 v = *reinterpret_cast<const float4*>(p + q);
      dst[q] = v.x, dst[q + 1] = v.y, dst[q + 2] = v.z, dst[q + 3] = v.w;
    }
  } else if constexpr (N == 4) {
    const float4 v = *reinterpret_cast<const float4*>(p);
    dst[0] = v.x, dst[1] = v.y, dst[2] = v.z, dst[3] = v.w;
  } else {
    const float2 v = *reinterpret_cast<const float2*>(p);
    dst[0] = v.x, dst[1] = v.y;
  }
}

template <int BM, int CW>
__global__ void __launch_bounds__(THREADS) wgrad_kernel(const WgradArgs p) {
  using L = Tile<BM, CW>;
  constexpr int CPT = L::CPT, TX = L::TX, T = L::T, G = L::G, BK = L::BK;
  constexpr int ALD = L::ALD, BLD = L::BLD;
  extern __shared__ __align__(16) float smem[];
  WCLK_BEGIN;
  const int tid = threadIdx.x, grp = tid / T, t = tid % T;
  const int tx = t % TX, ty = t / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * CW;
  const int rank = blockIdx.z;
  const int chunk = rank * G + grp;          // this group's chunk
  const int chunks = p.R > p.L ? (p.R + p.L - 1) / p.L : 1;
  // every group walks as many steps (the longest chunk's), past its end
  // on zeros
  const int steps = (min(p.L, p.R) + BK - 1) / BK;

  // A thread's share of a step's copies, the same every step: chunks of 4
  // floats (or 1 where a row is not 16-byte aligned) of the stage's
  // raster rows (G BK of them, group-major: its column cA, rows rA + PA j)
  // and g rows (column cB, rows rB + PB j). Row rr of the raster is
  // head's for rr < H, else body's: one base pointer chosen by a select.
  const bool vs = p.vec_s, vg = p.vec_g;
  const int wa = vs ? 4 : 1, wb = vg ? 4 : 1;
  const int qa = BM / wa, qb = CW / wb;      // chunks of a row
  const int cA = tid % qa, rA = tid / qa, PA = THREADS / qa;
  const int cB = tid % qb, rB = tid / qb, PB = THREADS / qb;
  const int colA = m0 + cA * wa, colB = n0 + cB * wb;
  const bool colA_in = colA < p.K, colB_in = colB < p.N;
  const float* body_shift = p.body - (size_t)p.H * p.K;
  auto fetch = [&](int st) {
    float* A = smem + (st % STAGES) * L::STAGE;     // [G][BK][ALD]
    float* B = A + G * BK * ALD;                    // [G][BK][BLD]
#pragma unroll 1
    for (int r = rA; r < G * BK; r += PA) {
      const int q = (r / BK) + rank * G;            // the row's chunk
      const int rr = q * p.L + st * BK + r % BK;
      const bool in = colA_in && rr < min(p.R, (q + 1) * p.L);
      const int rc = in ? rr : 0;
      const float* src = (rc < p.H ? p.head : body_shift) + (size_t)rc * p.K +
                         (in ? colA : 0);
      const uint32_t dst = smem_u32(A + r * ALD + cA * wa);
      if (vs) cp_async16(dst, src, in);
      else cp_async4(dst, src, in);
    }
#pragma unroll 1
    for (int r = rB; r < G * BK; r += PB) {
      const int q = (r / BK) + rank * G;
      const int rr = q * p.L + st * BK + r % BK;
      const bool in = colB_in && rr < min(p.R, (q + 1) * p.L);
      const float* src = p.g + (in ? (size_t)rr * p.N + colB : 0);
      const uint32_t dst = smem_u32(B + r * BLD + cB * wb);
      if (vg) cp_async16(dst, src, in);
      else cp_async4(dst, src, in);
    }
  };
  // One group on 16-byte rows (the event tiles): a thread's copies are
  // the same rows of its chunk every step, BK rows further on, so their
  // sources are worked out once and a step adds BK rows to them (the
  // general `fetch` above works each out again: its address arithmetic
  // took a quarter of the SHD hidden layer's time on the H100).
  constexpr int FA = BK * BM / 4 / THREADS > 0 ? BK * BM / 4 / THREADS : 1;
  constexpr int FB = BK * CW / 4 / THREADS > 0 ? BK * CW / 4 / THREADS : 1;
  const bool fast = G == 1 && vs && vg;
  const int r_end1 = min(p.R, (rank + 1) * p.L);
  int a_row[FA], b_row[FB];
#pragma unroll
  for (int j = 0; j < FA; ++j) a_row[j] = rank * p.L + rA + PA * j;
#pragma unroll
  for (int j = 0; j < FB; ++j) b_row[j] = rank * p.L + rB + PB * j;
  auto fetch_fast = [&](int st) {
    float* A = smem + (st % STAGES) * L::STAGE;
    float* B = A + BK * ALD;
#pragma unroll
    for (int j = 0; j < FA; ++j) {
      const int r = rA + PA * j, rr = a_row[j] + st * BK;
      if (r >= BK) break;
      const bool in = colA_in && rr < r_end1;
      const int rc = in ? rr : 0;
      cp_async16(smem_u32(A + r * ALD + cA * 4),
                 (rc < p.H ? p.head : body_shift) + (size_t)rc * p.K +
                     (in ? colA : 0),
                 in);
    }
#pragma unroll
    for (int j = 0; j < FB; ++j) {
      const int r = rB + PB * j, rr = b_row[j] + st * BK;
      if (r >= BK) break;
      const bool in = colB_in && rr < r_end1;
      cp_async16(smem_u32(B + r * BLD + cB * 4),
                 p.g + (in ? (size_t)rr * p.N + colB : 0), in);
    }
  };
  // whether this thread's own copies of a step's raster rows hold a spike
  // (its copies are visible to it after its wait)
  auto any_spike = [&](int st) {
    const float* A = smem + (st % STAGES) * L::STAGE + cA * wa;
    bool nz = false;
    for (int r = rA; r < G * BK; r += PA) {
      if (vs) {
        const float4 v = *reinterpret_cast<const float4*>(A + r * ALD);
        nz |= v.x != 0.f || v.y != 0.f || v.z != 0.f || v.w != 0.f;
      } else {
        nz |= A[r * ALD] != 0.f;
      }
    }
    return nz;
  };

  // the accumulators: dense, 4 rows x CPT columns; events, a warp's 8
  // rows x NC columns (the same registers)
  constexpr int KPW = L::KPW;
  constexpr int AR = L::EVENTS ? KPW : RT, AC = L::EVENTS ? L::NC : CPT;
  float acc[AR][AC];
#pragma unroll
  for (int i = 0; i < AR; ++i)
#pragma unroll
    for (int j = 0; j < AC; ++j) acc[i][j] = 0.f;
  const int warp = tid / 32, lane = tid % 32;
  // the output element of accumulator (i, j) of this thread, in the tile
  auto out_m = [&](int i) { return L::EVENTS ? warp * KPW + i : ty * RT + i; };
  auto out_n = [&](int j) { return L::EVENTS ? lane + 32 * j : tx * CPT + j; };
#pragma unroll 1
  for (int st = 0; st < STAGES - 1; ++st) {
    if (st < steps) {
      if (fast) fetch_fast(st);
      else fetch(st);
    }
    cp_async_commit();
  }
  for (int st = 0; st < steps; ++st) {
    cp_async_wait<STAGES - 2>();         // this thread's copies of step st
    // every copy of step st is in and step st - 1 is done: skip a step
    // with no spike, refill the stage step st - 1 used
    const bool live = __syncthreads_or(any_spike(st));
    WCLK(0);
    if (st + STAGES - 1 < steps) {
      if (fast) fetch_fast(st + STAGES - 1);
      else fetch(st + STAGES - 1);
    }
    cp_async_commit();
    WCLK(1);
    if (!live) continue;
    WCLK_LIVE;
    if constexpr (L::EVENTS) {
      // the rows of the step with a spike among the warp's KPW output rows
      // (a lane a row, a ballot), in ascending order; for each, its
      // nonzero ones times g's row (warp-uniform branches)
      const float* A = smem + (st % STAGES) * L::STAGE + warp * KPW;
      const float* B = smem + (st % STAGES) * L::STAGE + BK * ALD + lane;
      unsigned nz = 0;
      if (lane < BK) {
#pragma unroll
        for (int q = 0; q < KPW; q += 4) {
          const float4 v = *reinterpret_cast<const float4*>(A + lane * ALD + q);
          nz |= (v.x != 0.f ? 1u : 0u) << q | (v.y != 0.f ? 2u : 0u) << q |
                (v.z != 0.f ? 4u : 0u) << q | (v.w != 0.f ? 8u : 0u) << q;
        }
      }
      unsigned rows = __ballot_sync(0xffffffffu, nz != 0);
      while (rows) {
        const int r = __ffs((int)rows) - 1;
        rows &= rows - 1;
        const unsigned mr = __shfl_sync(0xffffffffu, nz, r);
        float sv[KPW];
        lds<KPW>(sv, A + r * ALD);
        float gv[AC];
#pragma unroll
        for (int j = 0; j < AC; ++j) gv[j] = B[r * BLD + 32 * j];
#pragma unroll
        for (int i = 0; i < KPW; ++i)
          if (mr >> i & 1u)
#pragma unroll
            for (int j = 0; j < AC; ++j)
              acc[i][j] = fmaf(sv[i], gv[j], acc[i][j]);
      }
      WCLK(2);
      continue;
    } else {
    const float* A = smem + (st % STAGES) * L::STAGE + grp * BK * ALD +
                     ty * RT;
    const float* B = smem + (st % STAGES) * L::STAGE + G * BK * ALD +
                     grp * BK * BLD + tx * CPT;
#pragma unroll
    for (int r0 = 0; r0 < BK; r0 += 4) {
      float a[4][RT], b[4][CPT];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        lds<RT>(a[u], A + (r0 + u) * ALD);
        lds<CPT>(b[u], B + (r0 + u) * BLD);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u)
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[i][j] = fmaf(a[u][i], b[u][j], acc[i][j]);
    }
    }
    WCLK(2);
  }
  cp_async_wait<0>();                    // the empty groups left

  if (chunks == 1) {                     // one chunk: the chain is the output
    if (chunk == 0) {
#pragma unroll
      for (int i = 0; i < AR; ++i) {
        const int m = m0 + out_m(i);
        if (m >= p.K) continue;
#pragma unroll
        for (int j = 0; j < AC; ++j) {
          const int n = n0 + out_n(j);
          if (n < p.N) p.out[(size_t)m * p.N + n] = acc[i][j];
        }
      }
    }
    WCLK(3);
    WCLK_END
    return;
  }

  cg::cluster_group cluster = cg::this_cluster();
  // the combine: each group's partial to the (chunks, K, N) scratch; after
  // a cluster barrier (its release and acquire order the writes before the
  // reads) the cluster's threads sum each output over the chunks in
  // ascending order, every chunk's partial read at once
  float* mine = p.part + (size_t)chunk * p.K * p.N;
  if (chunk < chunks) {
#pragma unroll
    for (int i = 0; i < AR; ++i) {
      const int m = m0 + out_m(i);
      if (m >= p.K) continue;
#pragma unroll
      for (int j = 0; j < AC; ++j) {
        const int n = n0 + out_n(j);
        if (n < p.N) mine[(size_t)m * p.N + n] = acc[i][j];
      }
    }
  }
  cluster.sync();
  WCLK(3);
  constexpr int QMAX = MAX_CLUSTER * G;           // chunks, at most
  constexpr int OB = QMAX >= 32 ? 1 : 32 / QMAX;  // outputs at once
  const size_t plane = (size_t)p.K * p.N;
  for (int o0 = rank + p.C * tid; o0 < BM * CW; o0 += p.C * THREADS * OB) {
    float v[OB][QMAX];
    size_t at[OB];
    bool in[OB];
#pragma unroll
    for (int b = 0; b < OB; ++b) {
      const int o = o0 + b * p.C * THREADS;
      const int m = m0 + o / CW, n = n0 + o % CW;
      in[b] = o < BM * CW && m < p.K && n < p.N;
      at[b] = in[b] ? (size_t)m * p.N + n : 0;
#pragma unroll
      for (int q = 0; q < QMAX; ++q)
        v[b][q] = __ldcg(p.part + at[b] + (q < chunks ? q : 0) * plane);
    }
#pragma unroll
    for (int b = 0; b < OB; ++b) {
      float sum = v[b][0];
#pragma unroll
      for (int q = 1; q < QMAX; ++q)
        if (q < chunks) sum = __fadd_rn(sum, v[b][q]);
      if (in[b]) p.out[at[b]] = sum;
    }
  }
  WCLK(5);
  WCLK_END
}

template <int BM, int CW>
int launch(const WgradArgs& p, cudaStream_t st) {
  using L = Tile<BM, CW>;
  constexpr int smem = L::SMEM * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      wgrad_kernel<BM, CW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + CW - 1) / CW, (p.K + BM - 1) / BM, p.C);
  cfg.blockDim = dim3(THREADS);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;          // a tile's CTAs: one cluster
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = p.C;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, wgrad_kernel<BM, CW>, p);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// the (bm, cw) tiles `wgrad_tile` picks from: whole warps a group
template <int CW>
int launch_cw(const WgradArgs& p, int bm, cudaStream_t st) {
  if constexpr (CW == 8) {
    switch (bm) {
      case 32: return launch<32, 8>(p, st);
      case 64: return launch<64, 8>(p, st);
    }
  } else if constexpr (CW == 16) {
    switch (bm) {
      case 16: return launch<16, 16>(p, st);
      case 32: return launch<32, 16>(p, st);
      case 64: return launch<64, 16>(p, st);
    }
  } else if constexpr (CW <= 64) {
    switch (bm) {
      case 8: return launch<8, CW>(p, st);
      case 16: return launch<16, CW>(p, st);
      case 32: return launch<32, CW>(p, st);
      case 64: return launch<64, CW>(p, st);
    }
  } else if constexpr (CW == 128) {
    switch (bm) {
      case 32: return launch<32, 128>(p, st);
      case 64: return launch<64, 128>(p, st);
    }
  }
  return (int)cudaErrorInvalidValue;
}

}  // namespace

extern "C" {

// g_w (K, N) = raster^T g, the raster's R rows being head's H rows, then
// body's; the tile of bm output rows and cw columns and the cluster of
// `cluster` CTAs as kernels/spikemm/wgrad.py::wgrad_tile picks them (cw 8:
// bm 32, 64; 16: 16, 32, 64; 32, 64: 8, 16, 32, 64; 128: 32, 64; at most 8
// CTAs), `rows` the chunk length as `wgrad_chunk` picks it (a multiple of
// 16): chunk q is walked by group q % G of the cluster's CTA q / G (G =
// 256 / the group's bm cw / (4 cpt) threads), and the chunks number at
// most cluster G. With more than one chunk, `part` holds (chunks, K, N)
// floats of scratch.
int spikemm_wgrad_f32(const float* head, int H, const float* body,
                      const float* g, float* out, float* part, int R, int K,
                      int N, int rows, int bm, int cw, int cluster,
                      void* stream) {
  if (R < 0 || K < 1 || N < 1 || H < 0 || H > R || (H > 0 && !head) ||
      rows < 16 || rows % 16 || cluster < 1 || cluster > MAX_CLUSTER ||
      (cw != 8 && cw != 16 && cw != 32 && cw != 64 && cw != 128) ||
      (bm != 8 && bm != 16 && bm != 32 && bm != 64))
    return (int)cudaErrorInvalidValue;
  const int cpt = cw <= 32 ? 2 : cw / 16;
  const int threads = (cw / cpt) * (bm / RT);
  if (threads % 32 || THREADS % threads) return (int)cudaErrorInvalidValue;
  const int groups = THREADS / threads;
  const int chunks = R > rows ? (R + rows - 1) / rows : 1;
  if (chunks > cluster * groups || (chunks > 1 && !part))
    return (int)cudaErrorInvalidValue;
  const bool vec_s =
      K % 4 == 0 && reinterpret_cast<uintptr_t>(body) % 16 == 0 &&
      (H == 0 || reinterpret_cast<uintptr_t>(head) % 16 == 0);
  const bool vec_g = N % 4 == 0 && reinterpret_cast<uintptr_t>(g) % 16 == 0;
  const WgradArgs p{head, body, g, out, part, H, R, K, N, rows, cluster,
                    vec_s, vec_g};
  cudaStream_t st = (cudaStream_t)stream;
  switch (cw) {
    case 8: return launch_cw<8>(p, bm, st);
    case 16: return launch_cw<16>(p, bm, st);
    case 32: return launch_cw<32>(p, bm, st);
    case 64: return launch_cw<64>(p, bm, st);
    default: return launch_cw<128>(p, bm, st);
  }
}

}  // extern "C"
