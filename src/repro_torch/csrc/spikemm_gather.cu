// Block-COO IE-table contraction (compressed-topology INTEG), sm_90a: an
// event-driven walk of the tables.
//
// Replaces: src/repro/kernels/spikemm/gather.py::_gather_pallas
//           (body `_gather_kernel`).
//
// Computes out(M, n_post) = spikes(M, n_pre) @ W, where W is never
// materialised: it is the packed block tables of an encoded topology
// (`GatherTables`), E entries sorted post-block-major, each a dense
// (bk, bn) patch `wblk[t]` at pre block kk[t] and post block jj[t], with
// one inactive sentinel (act[t] == 0) per empty post block. The wrapper
// hands the kernel the entries' offsets per post block (CSR over jj) and
// `rowbits`, a bitmap of each entry's patch rows, ceil(bk / 32) words an
// entry: bit k % 32 of word k / 32 is set where row k holds a nonzero
// weight, the entry is active and its pre neuron kk[t] * bk + k < n_pre
// (`GatherTables.row_bitmap`, computed once on the host, memoised with the
// other device tables).
//
// What bounds it on an H100: the bytes the events need, or the issue of
// the terms they need. The function needs the nonzero weights of the pre
// neurons that spike, the raster and the output. The kernel reads more: a
// whole patch row (bn weights) wherever the row holds a nonzero weight and
// a spike of the warp's rows meets it. At 10^6 neurons (band 2, bk = bn =
// 32, M = 8 at 10 % firing) those rows are ~21 % of the 384 MB of patches,
// 82 MB for ~11 MB of nonzeros, and the kernel is bound by its own reads,
// about twice the function's bytes. With many rows (the banded
// path's chunk: 64 steps at 20 %) every nonzero row of a patch meets a
// spike, the weight rows come from L2, and what is left is issue: a
// separate multiply and add a term, a shared-memory broadcast of the
// spikes, the bookkeeping of each listed row, and the latency of a
// warp's batch of loads, which only other warps hide.
//
// Design. A warp owns R rows (1, 2, 4 or 8) and 32 x C columns of one post
// block (C = 1 or 4 adjacent columns a lane, loaded as one 4- or 16-byte
// vector: bn % C == 0), a thread C columns and R x C <= 16
// accumulators. A post block of bn columns takes ceil(bn / 32 C) warps. A
// CTA holds `groups` row groups x `units` consecutive column warps (several
// post blocks where bn is small), at most 8 warps. `gather_plan` in
// kernels/spikemm/gather.py takes C from bn (4 where 4 divides bn and
// bn >= 128, else 1) and the most rows a warp that still give the card 16
// warps an SM: measured, fewer rows a warp win where the work is small,
// since a warp's listed rows wait on its own loads (the banded chunk:
// R = 1, C = 4). No warp waits on another: there is no CTA barrier.
//
// A warp walks its post block's entries in list order and each entry's
// patch rows in 32-row words (items). For each item:
//   FINDIDX  the lanes whose row bit is set load the spikes of the warp's
//            R rows at their pre neuron; `__ballot_sync` of x != 0 over
//            the rows gives the word's list of k, ascending (`__ffs`):
//            rows with a nonzero weight that meet a spike;
//   stage    the R spikes of each k go to the warp's slice of shared
//            memory (32 x R floats), read back as broadcasts;
//   LOCACC   the listed rows' weights (32 C floats a warp and row) are
//            loaded INFLIGHT rows at a time, all issued before their
//            adds, and each thread adds s * w into its accumulators.
// The items' bitmap words and first pre neurons are read 32 items at a
// time, a lane an item, and broadcast by `__shfl_sync`; the next item's
// spikes are loaded before the current one is summed. (Issuing the next
// batch of weights before summing the current one measured no faster: it
// cost registers, and at R = 8, C = 1 spills.)
//
// Determinism and bit equality: every output element is one chain
// `acc = __fadd_rn(acc, __fmul_rn(s, w))` from +0, not FMA-contracted,
// over its post block's entries in list order and each entry's k
// ascending, which the plain version (`gather.py::spikemm_gather_ref`)
// repeats term for term over every k. A term the walk skips has s = +-0
// or w = +-0 for every column of its row (an inactive entry, a row of
// zeros, a pre neuron past n_pre, a spike of zero in every row of the
// warp). For finite inputs such a term is +-0, and __fadd_rn(acc, +-0) ==
// acc: acc starts at +0 and never becomes -0 (a sum that is exactly 0
// rounds to +0, and +0 + -0 = +0). So the skipped terms change no bit.
// Precondition: finite spikes and weights (an inf or NaN times 0 is NaN
// in the plain version, and skipped here). A row's result does not depend
// on the rows batched with it (rows of a warp add zero terms, which change
// nothing), no split-K, no atomics: the serve engine's isolation invariant
// holds.
//
// Ragged edges (M, bk, bn, n_pre, n_post not multiples of anything) are
// masked in the loads and the store; nothing is padded in device memory.

#include <cuda_runtime.h>
#include <climits>
#include <cstdint>

namespace {

constexpr int MAX_WARPS = 8;
constexpr int INFLIGHT = 8;            // weight rows a batch loads at once
constexpr unsigned FULL = 0xffffffffu;

// x[r] = s[m0 + r, p] where `on` (the lane's row bit) and the row exists.
template <int R>
__device__ __forceinline__ void load_spikes(float (&x)[R],
                                            const float* __restrict__ s,
                                            size_t row0, int n_pre,
                                            int rows_left, int p, bool on) {
#pragma unroll
  for (int r = 0; r < R; ++r)
    x[r] = (on && r < rows_left)
               ? __ldg(s + row0 + (size_t)r * n_pre + p) : 0.f;
}

// The lane's C adjacent weights of one patch row (16 bytes where C is 4:
// bn % C == 0 keeps the row segment aligned).
template <int C>
__device__ __forceinline__ void load_w(float (&w)[C], const float* p) {
  if constexpr (C == 4) {
    const float4 q = __ldg(reinterpret_cast<const float4*>(p));
    w[0] = q.x, w[1] = q.y, w[2] = q.z, w[3] = q.w;
  } else {
    w[0] = __ldg(p);
  }
}

// The next INFLIGHT listed rows of `mask` (lowest first), their loads
// issued; ks[u] = -1 past the list.
template <int C>
__device__ __forceinline__ void take(unsigned& mask, int (&ks)[INFLIGHT],
                                     float (&w)[INFLIGHT][C],
                                     const float* W, int bn, bool col) {
#pragma unroll
  for (int u = 0; u < INFLIGHT; ++u) {
    ks[u] = mask ? __ffs(mask) - 1 : -1;
    mask &= mask - 1;
    if (ks[u] >= 0 && col) {
      load_w<C>(w[u], W + (size_t)ks[u] * bn);
    } else {
#pragma unroll
      for (int q = 0; q < C; ++q) w[u][q] = 0.f;
    }
  }
}

// acc[r][q] += s[r, k] * w[k][q] over the batch's rows k, in list order.
template <int R, int C>
__device__ __forceinline__ void add(float (&acc)[R][C],
                                    const int (&ks)[INFLIGHT],
                                    const float (&w)[INFLIGHT][C],
                                    const float* sx) {
#pragma unroll
  for (int u = 0; u < INFLIGHT; ++u) {
    if (ks[u] < 0) break;                      // warp-uniform
    const float* sv = sx + ks[u] * R;
    float v[R];
    if constexpr (R % 4 == 0) {
#pragma unroll
      for (int r = 0; r < R; r += 4) {
        const float4 q = *reinterpret_cast<const float4*>(sv + r);
        v[r] = q.x, v[r + 1] = q.y, v[r + 2] = q.z, v[r + 3] = q.w;
      }
    } else {
#pragma unroll
      for (int r = 0; r < R; ++r) v[r] = sv[r];
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int q = 0; q < C; ++q)
        acc[r][q] = __fadd_rn(acc[r][q], __fmul_rn(v[r], w[u][q]));
  }
}

template <int R, int C>
__global__ void __launch_bounds__(32 * MAX_WARPS)
spikemm_gather_kernel(const float* __restrict__ s,
                      const float* __restrict__ wblk,
                      const uint32_t* __restrict__ rowbits,
                      const int32_t* __restrict__ jptr,
                      const int32_t* __restrict__ kk,
                      float* __restrict__ out, int M, int n_pre, int n_post,
                      int bk, int bn, int words, int col_warps, int n_units,
                      int units, int groups) {
  extern __shared__ float4 smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int unit = blockIdx.x * units + warp % units;
  const int m0 = (blockIdx.y * groups + warp / units) * R;
  if (unit >= n_units || m0 >= M) return;      // a whole warp; no barrier
  const int j = unit / col_warps;
  const int c = (unit - j * col_warps) * 32 * C + lane * C;
  const bool col = c < bn;                     // bn % C == 0: all C or none
  const int rows_left = M - m0;
  const size_t row0 = (size_t)m0 * n_pre;
  float* sx = reinterpret_cast<float*>(smem) + warp * 32 * R;  // [k][r]

  float acc[R][C];
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int q = 0; q < C; ++q) acc[r][q] = 0.f;

  const int t0 = jptr[j];
  const int n = (jptr[j + 1] - t0) * words;    // items, in list order
  // lane l holds item (32 q + l)'s bitmap word and first pre neuron
  uint32_t bits_l = 0;
  int p_l = 0;
  auto meta = [&](int base) {
    const int i = base + lane;
    bits_l = 0;
    p_l = 0;
    if (i < n) {
      const int e = i / words, wd = i - e * words;
      bits_l = rowbits[(size_t)(t0 + e) * words + wd];
      p_l = kk[t0 + e] * bk + wd * 32;
    }
  };
  meta(0);
  float x[R];                                  // item i's spikes
  load_spikes<R>(x, s, row0, n_pre, rows_left,
                 __shfl_sync(FULL, p_l, 0) + lane,
                 (__shfl_sync(FULL, bits_l, 0) >> lane) & 1u);

  for (int i = 0; i < n; ++i) {
    const int nx = i + 1;
    if ((nx & 31) == 0 && nx < n) meta(nx);
    uint32_t mnext = 0;
    int pnext = 0;
    if (nx < n) {
      mnext = __shfl_sync(FULL, bits_l, nx & 31);
      pnext = __shfl_sync(FULL, p_l, nx & 31);
    }
    float xn[R];
    load_spikes<R>(xn, s, row0, n_pre, rows_left, pnext + lane,
                   (mnext >> lane) & 1u);

    // FINDIDX: the rows of this word with a nonzero weight (only their
    // lanes loaded) that meet a spike of the warp's rows
    unsigned mask = 0;
#pragma unroll
    for (int r = 0; r < R; ++r) mask |= __ballot_sync(FULL, x[r] != 0.f);
    if (mask) {
      __syncwarp();                            // earlier reads of sx done
      if constexpr (R % 4 == 0) {
#pragma unroll
        for (int r = 0; r < R; r += 4)
          *reinterpret_cast<float4*>(sx + lane * R + r) =
              make_float4(x[r], x[r + 1], x[r + 2], x[r + 3]);
      } else {
#pragma unroll
        for (int r = 0; r < R; ++r) sx[lane * R + r] = x[r];
      }
      __syncwarp();
      const int e = i / words, wd = i - e * words;
      const float* W = wblk + ((size_t)(t0 + e) * bk + wd * 32) * bn + c;
      do {
        int ks[INFLIGHT];
        float w[INFLIGHT][C];
        take<C>(mask, ks, w, W, bn, col);
        add<R, C>(acc, ks, w, sx);
      } while (mask);
    }
#pragma unroll
    for (int r = 0; r < R; ++r) x[r] = xn[r];
  }

  if (col) {
#pragma unroll
    for (int q = 0; q < C; ++q) {
      const int gc = j * bn + c + q;
      if (gc >= n_post) break;
#pragma unroll
      for (int r = 0; r < R; ++r)
        if (r < rows_left) out[(size_t)(m0 + r) * n_post + gc] = acc[r][q];
    }
  }
}

template <int R, int C>
void launch(dim3 grid, int threads, cudaStream_t st, const float* s,
            const float* wblk, const uint32_t* rowbits, const int32_t* jptr,
            const int32_t* kk, float* out, int M, int n_pre, int n_post,
            int bk, int bn, int words, int col_warps, int n_units, int units,
            int groups) {
  const size_t smem = (size_t)threads * R * sizeof(float);
  spikemm_gather_kernel<R, C><<<grid, threads, smem, st>>>(
      s, wblk, rowbits, jptr, kk, out, M, n_pre, n_post, bk, bn, words,
      col_warps, n_units, units, groups);
}

}  // namespace

extern "C" {

// jptr: (jb + 1) offsets of each post block's entries; kk: (E,); rowbits:
// (E, ceil(bk / 32)); wblk: (E, bk, bn) contiguous; out: (M, n_post).
// rows (R), cols (C), units and groups are `gather_plan`'s: R in {1, 2, 4,
// 8}, C in {1, 4} dividing bn, R x C <= 16, units x groups <= 8 warps a
// CTA. Anything else is refused.
int spikemm_gather_f32(const float* s, const float* wblk,
                       const uint32_t* rowbits, const int32_t* jptr,
                       const int32_t* kk, float* out, int M, int n_pre,
                       int n_post, int bk, int bn, int jb, int rows,
                       int cols, int units, int groups, void* stream) {
  if (M <= 0 || n_pre <= 0 || n_post <= 0 || bk <= 0 || bn <= 0 ||
      jb <= 0 || rows <= 0 || cols <= 0 || bn % cols != 0 || units <= 0 ||
      groups <= 0 || units * groups > MAX_WARPS)
    return (int)cudaErrorInvalidValue;
  const int words = (bk + 31) / 32;
  const int col_warps = (bn + 32 * cols - 1) / (32 * cols);
  const long long n_units = (long long)jb * col_warps;
  const long long gx = (n_units + units - 1) / units;
  const long long gy = ((M + (long long)rows - 1) / rows + groups - 1) /
                       groups;
  if (n_units > INT_MAX || gx > INT_MAX || gy > 65535)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)gx, (unsigned)gy);
  const int threads = 32 * units * groups;
  const cudaStream_t st = (cudaStream_t)stream;
#define GATHER_CASE(R, C)                                                 \
  if (rows == R && cols == C) {                                           \
    launch<R, C>(grid, threads, st, s, wblk, rowbits, jptr, kk, out, M,   \
                 n_pre, n_post, bk, bn, words, col_warps, (int)n_units,   \
                 units, groups);                                          \
    return (int)cudaGetLastError();                                       \
  }
  GATHER_CASE(1, 1)
  GATHER_CASE(2, 1)
  GATHER_CASE(4, 1)
  GATHER_CASE(8, 1)
  GATHER_CASE(1, 4)
  GATHER_CASE(2, 4)
  GATHER_CASE(4, 4)
#undef GATHER_CASE
  return (int)cudaErrorInvalidValue;
}

}  // extern "C"
