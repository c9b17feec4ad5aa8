// Event-driven spike x weight matmul (FINDIDX + LOCACC) for sm_90a.
//
// Replaces: src/repro/kernels/spikemm/kernel.py::spikemm_pallas
//           (body `_spikemm_kernel`), the dense channel.
//
// Computes out(M, N) = spikes(M, K) @ w(K, N) in fp32, in one launch with
// no pre-pass: the kernel finds the events itself.
//
// What bounds it on an H100: the bytes of the raster (read once), of w and
// of the output, or the operations the events need: one multiply-add per
// spike and output column, 2 nnz N. At the SHD window's hidden INTEG,
// (2048 x 700) @ (700 x 256) at a few percent firing, that is the bytes:
// 5.7 MB of raster, 1.7 us. A dense product does 30-100x the work the
// events need.
//
// Design. A CTA owns BM rows (16 to 128) and one column tile of CW = 8, 16,
// 32 or 64 columns, sized from N so that narrow readouts (N = 20, 8, 6) do
// not leave most lanes idle; a thread owns RPT rows, TY apart (so that the
// two row groups of a warp read distinct shared-memory banks), and CPT
// columns. The wrapper takes the largest BM that still gives the card
// about a wave of CTAs (`rows_per_cta` in kernels/spikemm/ops.py).
//
//   FINDIDX  the CTA's warps read its rows (a row slab of 128 k as one
//            float4 a lane where K allows, several slabs in flight) and,
//            by __ballot_sync, compact each row's nonzero k and spike
//            values into a list in shared memory in ascending k, counting
//            the events. A row with more than CAP events stops the scan.
//   route    from that count, on the device and with no host sync: a tile
//            with more than one event in four of its entries, or a row past
//            CAP, runs the dense register-blocked loop (`ring_product` of
//            spikemm_ring.cuh, which the sparse channel shares: K in
//            32-deep steps through a 3-stage cp.async ring in shared
//            memory, skipping (BM, 32) blocks with no spike); else
//   LOCACC   each thread walks its rows' lists (its RPT rows interleaved
//            and unrolled, so their loads of w are in flight together) and
//            adds spike times w's row, read through L2 (w stays resident),
//            into its columns.
//
// Determinism and bit equality: both routes compute every output element
// as one fmaf chain acc = fmaf(s[m, k], w[k, n], acc), acc from +0, over k
// in ascending order: LOCACC over the nonzero k, the dense loop over every
// k of the blocks that hold a spike. fmaf(0, w, acc) == acc for finite w,
// and acc never becomes -0 (a sum that is exactly 0 rounds to +0), so the
// routes give the same bits, and so does the first version of this kernel
// (the plain 64 x 64 SGEMM tile). An element depends on nothing but its
// row of spikes: no split-K, no atomics. That is what the serve engine's
// isolation invariant (a session is bit-identical alone or packed with
// strangers) needs from this kernel. `spikemm_chain_ref`
// (kernels/spikemm/ref.py) is the same chain in plain PyTorch. No TF32 and
// no bf16: the weights are exact in neither.
//
// Ragged edges (M = 2048, K = 700, N = 20 on the serving path) are masked
// in the loads and the store; nothing is padded in device memory.

#include <cuda_runtime.h>
#include <cstdint>

#include "spikemm_ring.cuh"

namespace {

constexpr int LIST_ENTRIES = 4096;     // event list capacity of a CTA
constexpr int INFLIGHT = 8;            // row slabs a lane reads at once

template <int CW, int RPT>
struct Tile : RingTile<CW, RPT> {
  using R = RingTile<CW, RPT>;
  static constexpr int CAP = LIST_ENTRIES / R::BM;   // events a row may list
  // events of each row LOCACC takes at once: about 32 loads of w in flight
  static constexpr int UNROLL =
      RPT * R::CPT >= 32 ? 1
                         : (32 / (RPT * R::CPT) > 8 ? 8 : 32 / (RPT * R::CPT));
  // the lists (k, spike), their counts, and the dense ring
  static constexpr int SMEM = LIST_ENTRIES * 8 + R::BM * 4 + R::RING * 4;
};

// FINDIDX over the CTA's rows. Work items are (row, slab of 32 PER k),
// row = warp + WARPS r, taken INFLIGHT at a time per warp so that their
// loads are issued together; PER = 4 reads a float4 a lane (K % 4 == 0).
// Each row's nonzero k and values go to its list in ascending k; a row
// past CAP sets `overflow` and stops every warp's scan. Returns the events
// this warp listed.
template <int PER, int BM, int CAP>
__device__ __forceinline__ int findidx(const float* __restrict__ s, int m0,
                                       int M, int K, int* klist,
                                       float* vlist, int* counts,
                                       int* overflow) {
  constexpr int STEP = 32 * PER;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const unsigned lt = (1u << lane) - 1u;
  const int slabs = (K + STEP - 1) / STEP;
  const int items = (BM / WARPS) * slabs;
  int events = 0;
  for (int g = 0; g < items; g += INFLIGHT) {
    if (*reinterpret_cast<volatile int*>(overflow)) break;
    float x[INFLIGHT][PER];
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      const int it = g + u, row = warp + WARPS * (it / slabs);
      const int k = (it % slabs) * STEP + lane * PER, m = m0 + row;
      if (it < items && m < M && k < K) {
        load_vec<PER>(x[u], s + (size_t)m * K + k);
      } else {
#pragma unroll
        for (int j = 0; j < PER; ++j) x[u][j] = 0.f;
      }
    }
#pragma unroll
    for (int u = 0; u < INFLIGHT; ++u) {
      const int it = g + u;
      if (it >= items) break;                          // warp-uniform
      const int row = warp + WARPS * (it / slabs), slab = it % slabs;
      int below = 0, n = 0;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        const unsigned b = __ballot_sync(FULL, x[u][j] != 0.f);
        below += __popc(b & lt);
        n += __popc(b);
      }
      const int base = counts[row];
      __syncwarp();
      if (base + n > CAP) {                            // too many to list
        if (lane == 0) *overflow = 1;
        break;
      }
      int pos = base + below;
#pragma unroll
      for (int j = 0; j < PER; ++j) {
        if (x[u][j] != 0.f) {
          klist[row * CAP + pos] = slab * STEP + lane * PER + j;
          vlist[row * CAP + pos] = x[u][j];
          ++pos;
        }
      }
      if (lane == 0) counts[row] = base + n;
      __syncwarp();
      events += n;
    }
  }
  return events;
}

template <int CW, int RPT>
__global__ void __launch_bounds__(THREADS, RPT < 8 ? 2 : 1)
spikemm_kernel(const float* __restrict__ s, const float* __restrict__ w,
               float* __restrict__ out, int M, int K, int N) {
  using L = Tile<CW, RPT>;
  constexpr int BM = L::BM, CPT = L::CPT, TX = L::TX, CAP = L::CAP;
  constexpr int UNROLL = L::UNROLL;
  extern __shared__ __align__(16) float smem[];
  int* klist = reinterpret_cast<int*>(smem);          // [BM][CAP]
  float* vlist = smem + LIST_ENTRIES;                  // [BM][CAP]
  int* counts = reinterpret_cast<int*>(vlist + LIST_ENTRIES);  // [BM]
  float* ring = vlist + LIST_ENTRIES + BM;             // [L::RING]
  __shared__ int total, overflow;

  const int tid = threadIdx.x, lane = tid % 32;
  const int tx = tid % TX, ty = tid / TX;
  const int m0 = blockIdx.y * BM, n0 = blockIdx.x * CW;
  const int live = min(BM, M - m0);
  // float4 reads of a raster row, of a row of w (16-byte aligned rows)
  const bool vec_s = K % 4 == 0 && reinterpret_cast<uintptr_t>(s) % 16 == 0;
  const bool vec_w = N % 4 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  if (tid == 0) total = overflow = 0;
  for (int r = tid; r < BM; r += THREADS) counts[r] = 0;
  __syncthreads();

  const int events =
      vec_s ? findidx<4, BM, CAP>(s, m0, M, K, klist, vlist, counts, &overflow)
            : findidx<1, BM, CAP>(s, m0, M, K, klist, vlist, counts, &overflow);
  if (lane == 0) atomicAdd(&total, events);
  __syncthreads();

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.f;

  if (overflow || 4LL * total > (long long)live * K) {
    // dense: every BK-deep step of K through the ring
    ring_product<CW, RPT>(s, w, ring, m0, n0, M, K, N, K, vec_s, vec_w,
                          (K + BK - 1) / BK, [](int st) { return st * BK; },
                          acc);
  } else {
    // LOCACC: this thread's rows' events, interleaved, in ascending k,
    // UNROLL a row at a time with all their loads of w issued first. Past
    // a row's last event a slot adds 0 times w's row 0 (k = 0, spike 0):
    // fmaf(0, w, acc) == acc, so the chain is unchanged and no load waits
    // on a branch; columns past N read column N - 1 and are not stored.
    int cnt[RPT], most = 0;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      cnt[i] = counts[ty + L::TY * i];
      most = max(most, cnt[i]);
    }
    int cc[CPT];
#pragma unroll
    for (int j = 0; j < CPT; ++j) cc[j] = min(n0 + tx * CPT + j, N - 1);
    for (int e0 = 0; e0 < most; e0 += UNROLL) {
      float v[UNROLL][RPT], wv[UNROLL][RPT][CPT];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
          const int e = e0 + u, at = (ty + L::TY * i) * CAP + e;
          const bool ok = e < cnt[i];
          const int k = ok ? klist[at] : 0;
          v[u][i] = ok ? vlist[at] : 0.f;
          const float* wr = w + (size_t)k * N;
#pragma unroll
          for (int j = 0; j < CPT; ++j) wv[u][i][j] = __ldg(wr + cc[j]);
        }
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
          for (int j = 0; j < CPT; ++j)
            acc[i][j] = fmaf(v[u][i], wv[u][i][j], acc[i][j]);
    }
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

template <int CW, int RPT>
int launch(const float* s, const float* w, float* out, int M, int K, int N,
           cudaStream_t stream) {
  using L = Tile<CW, RPT>;
  cudaError_t err = cudaFuncSetAttribute(
      spikemm_kernel<CW, RPT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::SMEM);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((N + CW - 1) / CW, (M + L::BM - 1) / L::BM);
  spikemm_kernel<CW, RPT><<<grid, THREADS, L::SMEM, stream>>>(s, w, out, M,
                                                             K, N);
  return (int)cudaGetLastError();
}

// rows per CTA bm = TY * RPT
template <int CW>
int launch_cw(const float* s, const float* w, float* out, int M, int K,
              int N, int bm, cudaStream_t st) {
  constexpr int TY = Tile<CW, 1>::TY;
  switch (bm / TY) {
    case 1: return launch<CW, 1>(s, w, out, M, K, N, st);
    case 2: return launch<CW, 2>(s, w, out, M, K, N, st);
    case 4: return launch<CW, 4>(s, w, out, M, K, N, st);
    default:
      if constexpr (TY == 16)
        return launch<CW, 8>(s, w, out, M, K, N, st);
      else
        return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// The CTA's tile, as kernels/spikemm/ops.py::col_tile and rows_per_cta
// pick it: cw columns (8, 16, 32 or 64), bm rows (a power of two from 16,
// or 32 when cw = 8, to 128)
int spikemm_f32(const float* s, const float* w, float* out, int M, int K,
                int N, int bm, int cw, void* stream) {
  if (M < 1 || N < 1 || K < 0 || bm > 128 || bm < (cw == 8 ? 32 : 16) ||
      (bm & (bm - 1)) || (cw != 8 && cw != 16 && cw != 32 && cw != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  switch (cw) {
    case 8: return launch_cw<8>(s, w, out, M, K, N, bm, st);
    case 16: return launch_cw<16>(s, w, out, M, K, N, bm, st);
    case 32: return launch_cw<32>(s, w, out, M, K, N, bm, st);
    default: return launch_cw<64>(s, w, out, M, K, N, bm, st);
  }
}

}  // extern "C"
