// Key-split attention for a few query rows over a long key axis,
// flash-decoding style: B8's decode over a head-major page pool
// (decode_attention.cu) and B11's verify chunk (flash_chunk.cu). Both
// are bound by bytes, so the key axis of one (batch row, kv head) is
// split across the CTAs of a thread block cluster; each CTA of 4 warps
// streams its split through a cp.async ring of kTile-key tiles, each warp
// keeping its own online softmax over a slice of every tile, and the
// partial (m, l, acc) are merged in warp order through shared memory,
// then in split order through distributed shared memory: deterministic,
// and no workspace in HBM (neither C entry has one to offer).
//
// What is shared here: the split rule (from the shape alone), the
// cluster launch, the shared-memory chunk swizzle of the K/V tiles, and
// the merges, which write the output through the caller's functor.
#pragma once

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include "hopper.cuh"

namespace ptt {
namespace keysplit {

constexpr int kTile = 64;         // keys of a ring tile
constexpr int kStages = 3;        // cp.async ring depth
constexpr int kThreads = 128;     // four warps a CTA
constexpr int kMaxSplits = 8;     // the portable cluster size
constexpr int kMinSplit = 256;    // keys a split covers at least
constexpr int kTargetCtas = 264;  // CTAs a grid aims at: two an SM

// The split of a key axis of W keys for `rows` (batch row, kv head)
// pairs, from the shape alone: the most splits (a power of two, at most
// kMaxSplits) that keep the grid within about two CTAs an SM and leave
// each split at least kMinSplit keys; a CTA's fixed costs (its first
// tile's latency, the merge) outweigh the parallelism of more, shorter
// splits. A split wholly past a row's live keys loads nothing, so short
// rows do not hold the longest back. On an H100 (chip_smoke.py phase 2,
// compare_flash.py) 8 rows x 32 kv heads run fastest at 1 split, 8 x 8
// (GQA) at 4 for both kernels, one row x 32 at 4 (bf16) or 8 (int8); the
// rule gives 1, 4 and 8.
inline int split_count(long long rows, int W) {
  int n = 1;
  while (n < kMaxSplits && 2LL * n * rows <= kTargetCtas &&
         W >= 2 * n * kMinSplit)
    n *= 2;
  return n;
}

// Keys a split covers: W over n splits, rounded up to whole tiles.
inline int split_length(int W, int n) {
  const int per = (W + n - 1) / n;
  return (per + kTile - 1) / kTile * kTile;
}

// kern on a grid (nsplit, HK, B) of kThreads-thread CTAs, the nsplit
// splits of one (kv head, batch row) forming a cluster.
template <typename... P, typename... A>
cudaError_t launch(void (*kern)(P...), int nsplit, int HK, int B,
                   size_t smem, cudaStream_t stream, A... args) {
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(nsplit, HK, B);
  cfg.blockDim = dim3(kThreads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = nsplit;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, kern, args...);
  if (e != cudaSuccess) return e;
  return cudaGetLastError();
}

// K/V tiles hold rows of CPR 16-byte chunks; chunk c of row r is stored
// at chunk c ^ swz(r): conflict-free for the fragment reads of both
// kernels (rows 2i and 2i + 1 reading 4 neighbouring chunks each; rows
// r, r + 4, r + 8, r + 12 reading the chunks of D / 8 columns).
template <int CPR>
__device__ __forceinline__ int swz(int r) {
  const int b2 = ((r ^ (r >> 2)) & 1) << 2;
  const int hi = (r >> 3) & 1;
  if (CPR >= 16) return b2 | hi;
  if (CPR == 8) return b2 | (hi << 1);
  return hi << 1;
}

// Column of (row r, dim d) in a warp's partial slice: a swizzle within
// 32 columns, so a store instruction's 32 lanes meet 32 banks.
__device__ __forceinline__ int pcol(int r, int d) {
  return d ^ (((d >> 5) & 3) | ((r & 7) << 2));
}

// A warp's partial for accumulator rows gq + 8 i (i = 0, 1) into slot
// `slot` of the partials (D floats at part + slot * D, (m, l) at
// pml + 2 slot). acc is the p.v accumulator of mma.m16n8k16 n8 tiles
// whose element (jd, e) is row gq + 8 (e / 2), dim (2 t + e % 2) * NT +
// jd; l is the thread's share, summed over the quad here.
template <int D>
__device__ __forceinline__ void put_partial(float* part, float* pml,
                                            int slot, int r, int tq,
                                            const float (&acc)[D / 8][4],
                                            int i, float m, float l) {
  constexpr int NT = D / 8;
  l += __shfl_xor_sync(0xffffffffu, l, 1);
  l += __shfl_xor_sync(0xffffffffu, l, 2);
  float* po = part + (long long)slot * D;
#pragma unroll
  for (int jd = 0; jd < NT; ++jd) {
    po[pcol(r, (2 * tq) * NT + jd)] = acc[jd][2 * i];
    po[pcol(r, (2 * tq + 1) * NT + jd)] = acc[jd][2 * i + 1];
  }
  if (tq == 0) {
    pml[2 * slot] = m;
    pml[2 * slot + 1] = l;
  }
}

// The CTA's partial of M rows from KS slices of RP rows each (slot
// k * RP + r), merged in slice order into mo (M x D) and mml (m, l a
// row). c = scale * log2(e); m is in raw q.k units.
template <int D, int KS, int RP>
__device__ __forceinline__ void merge_slices(const float* part,
                                             const float* pml, float* mo,
                                             float* mml, int M, float c) {
  for (int i = threadIdx.x; i < M * D; i += kThreads) {
    const int r = i / D;
    const int d = i % D;
    float mk = -INFINITY;
#pragma unroll
    for (int k = 0; k < KS; ++k) mk = fmaxf(mk, pml[2 * (k * RP + r)]);
    float o = 0.f, lk = 0.f;
    if (mk != -INFINITY) {
#pragma unroll
      for (int k = 0; k < KS; ++k) {
        const float wk = hop::exp2_approx((pml[2 * (k * RP + r)] - mk) * c);
        o += wk * part[((long long)k * RP + r) * D + pcol(r, d)];
        lk += wk * pml[2 * (k * RP + r) + 1];
      }
    }
    mo[r * D + d] = o;
    if (d == 0) {
      mml[2 * r] = mk;
      mml[2 * r + 1] = lk;
    }
  }
}

// A split that saw no key: an empty partial (its mo is never read).
__device__ __forceinline__ void empty_partial(float* mml, int M) {
  for (int r = threadIdx.x; r < M; r += kThreads) {
    mml[2 * r] = -INFINITY;
    mml[2 * r + 1] = 0.f;
  }
}

// The cluster's splits merged in split order, every CTA's partial (mo,
// mml) in place: split rank takes every nr-th element of the M x D
// output and hands out(r, d, value) the normalized result (0 for a row
// that saw no key, as the TPU kernels write).
template <int D, typename Out>
__device__ __forceinline__ void merge_cluster(float* mo, float* mml, int M,
                                              float c, Out out) {
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  cluster.sync();  // every split's partial is in place
  const int nr = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  for (int i = rank * kThreads + threadIdx.x; i < M * D;
       i += nr * kThreads) {
    const int r = i / D;
    const int d = i % D;
    // every rank's (m, l, o) first, so the remote loads overlap
    float mr[kMaxSplits], lr[kMaxSplits], orr[kMaxSplits];
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k) {
      mr[k] = -INFINITY;
      lr[k] = orr[k] = 0.f;
      if (k < nr) {
        const float* rml = cluster.map_shared_rank(mml, k);
        mr[k] = rml[2 * r];
        lr[k] = rml[2 * r + 1];
        orr[k] = cluster.map_shared_rank(mo, k)[r * D + d];
      }
    }
    float mk = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMaxSplits; ++k) mk = fmaxf(mk, mr[k]);
    float o = 0.f, lk = 0.f;
    if (mk != -INFINITY) {
#pragma unroll
      for (int k = 0; k < kMaxSplits; ++k) {
        if (mr[k] == -INFINITY) continue;  // empty: its o was not written
        const float wk = hop::exp2_approx((mr[k] - mk) * c);
        o += wk * orr[k];
        lk += wk * lr[k];
      }
    }
    out(r, d, lk > 0.f ? o / lk : 0.f);
  }
  cluster.sync();  // keep this CTA's partial until every rank has read it
}

}  // namespace keysplit
}  // namespace ptt
