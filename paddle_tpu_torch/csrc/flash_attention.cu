// B1-B3 flash attention for training: the forward (B1) and its two
// backward passes (B2: dK and dV; B3: dQ).
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/flash_attention.py:
// `_fwd_kernel` (B1, the pallas_call in `_fwd`), `_bwd_dkv_kernel` (B2)
// and `_bwd_dq_kernel` (B3, the two pallas_calls in `_bwd`).
//
// Semantics, as the Pallas kernels compute them, over (B, S, H, D)
// tensors read in place (contiguous; H equal for q and k/v, the caller
// repeats GQA heads): scores s = (q . k) * scale in f32; under `causal`
// query row t sees key columns c <= t, both counted from 0 (top-left
// aligned, also when Sq != Sk). B1 writes O = softmax(s) v in the model
// dtype and lse = m + log(l) per row in f32, (B, H, Sq). B2 and B3
// recompute p = exp(s - lse) and ds = p * (dO . v - delta) * scale, with
// delta = rowsum(O * dO) computed outside in f32: B2 sums dV = p^T dO and
// dK = ds^T q for one key tile over the query tiles, B3 dQ = ds k for one
// query tile over the key tiles. p is rounded to the model dtype before
// its products and ds likewise, as the TPU kernels cast them; l and the
// scores stay f32.
//
// What bounds them on the H100, bf16 at the training shape (B = 4,
// S = 4096, H = 12, D = 128, causal): operations. B1 does 4 D flops a
// visible (query, key) pair (q.k and p.v), B3 6 D (q.k, dO.v and ds.k),
// B2 8 D, on 8 S D bytes a head (q, k, v and O in bf16) or a little more:
// B1 about S / 4 = 1024 flops a byte against the card's 295 (989 TFLOP/s
// over 3.35 TB/s), so the products belong on the tensor cores at their
// full rate.
//
// What the design does about it:
// - the TPU's sequential grid axis, which carries the softmax state (B1)
//   or the dK/dV (B2) and dQ (B3) sums in VMEM from one grid step to the
//   next, becomes a loop inside one CTA, so no sum crosses CTAs and no
//   atomics are needed: B1 and B3 run one CTA per (128-row query tile,
//   head, batch row) and loop over key tiles up to the tile's causal
//   limit; B2 runs one CTA per (64-key tile, head, batch row) and loops
//   over the query tiles from the first one that sees its keys. Tiles
//   past the causal limit cost nothing;
// - the causal grid is uneven (a tile's work grows with its distance
//   from the first row), so the longest CTAs are launched first: B1 and
//   B3 put the query tile on the grid's slowest axis and take it from
//   the last (every head's longest tile before any shorter one), B2's
//   key tile 0 is its longest and comes first;
// - B1, B2 and B3 in bf16 are Hopper kernels (hopper.cuh): 384 threads, a
//   producer warpgroup whose one thread keeps TMA loads in flight (it
//   gives its registers up with setmaxnreg, down to 24) and two consumer
//   warpgroups. In B1 and B3 each owns 64 of the CTA's 128 query rows.
//   B2 is key-stationary and its two warpgroups share 64 keys and split
//   the work: the first computes S^T, p and dV += p^T dO and hands p to
//   the second through shared memory, which computes dP^T, ds and dK +=
//   ds^T q (ptxas allocates the consumers within the entry's 168
//   registers, and a warpgroup holding dK, dV and the scores spilled).
//   The row tiles (B1: Q; B2: K and V; B3: Q and dO) are loaded once; the
//   other two tiles stream through a ring of 2 stages under full / empty
//   mbarriers: K and V, 128 keys a tile in B1 and 64 in B3 (three f32
//   sums, S, dP and dQ, with ds beside them fit at 64 keys; 128 would
//   need 224 registers for them alone); Q and dO, 64 queries a tile in
//   B2. Q, K, V and dO are read as 4-D TMA tensors (D, H, S, B), boxes of
//   64 columns with the 128-byte swizzle, so D = 128 is two boxes a
//   tile, and rows past S arrive as zeros (the TPU kernels'
//   _zero_pad_rows) without reading the next batch row;
// - every product is a wgmma (m64nNk16, bf16 in, f32 sums): q.k^T and
//   dO.v^T with K and V as K-major B operands, and B2's transposed k.q^T
//   and v.dO^T with Q and dO as the K-major B operands; p.v (B1), ds.k
//   (B3), p^T.dO and ds^T.q (B2) with p or ds taken from the score
//   accumulator's registers as the A operand, rounded to bf16 (the
//   accumulator layout of m64nN is the A layout of its k16 slices), and
//   V, K, dO or Q as MN-major B operands of the same shared tile, in
//   their natural (rows x D) layout: no transposed copy anywhere;
// - the online softmax stays in registers: exp2 with scale * log2(e)
//   folded into one FMA, the row max and sum over the 4 threads of a
//   row by two quad shuffles (the sum only at the end), the causal mask
//   and the columns past Sk applied only on tiles that cross them. p is
//   rounded to bf16 for p.v while l sums it unrounded; O = acc / l is
//   rounded once; the max is kept in raw q.k units so lse = m * scale +
//   log(l) comes out in natural-log units without the log2 folding's
//   rounding. B3 reads lse (times log2(e)) and delta into registers; in
//   B2 they vary along the accumulator's columns, so its warpgroups
//   stage a tile's lse or delta in shared memory a tile ahead (f32 rows
//   of odd length cannot be TMA tensors), and queries past Sq,
//   zero-filled with lse 0 (p = 1), are masked on the last tile;
// - float32 (the tests' dtype) keeps plain f32 FMA: each of 256 threads
//   computes a 4 x 4 block of a 64 x 64 score tile and a 4 x (D/16)
//   block of its output from f32 tiles in shared memory.
// Left for later: overlap of the softmax with the next tile's wgmma
// inside a warpgroup (two score buffers, or the two warpgroups taking
// turns), a persistent tile scheduler, and GQA through kv_rep without
// the caller's head repeat (ROADMAP.md).

#include "common.cuh"
#include "hopper.cuh"
#include "mma.cuh"

namespace {

constexpr int kB = 64;          // rows of a query or key tile
constexpr int kThreads = 256;   // 16 x 16; thread (ty, tx) owns rows ty*4..+3
constexpr int kLDP = kB + 1;    // padded row of a 64 x 64 score tile

enum Kind { kFwd = 0, kDkv = 1, kDq = 2 };

struct FlashArgs {
  const void* q;        // (B, Sq, H, D) model dtype
  const void* k;        // (B, Sk, H, D)
  const void* v;        // (B, Sk, H, D)
  const void* dout;     // (B, Sq, H, D), backward only
  const float* lse;     // (B, H, Sq) f32, backward only
  const float* delta;   // (B, H, Sq) f32, backward only
  void* out;            // B1: O (B, Sq, H, D); B2: dK; B3: dQ
  void* out2;           // B1: lse (B, H, Sq) f32; B2: dV
  int H, Sq, Sk;
  float scale;
  int causal;
};

// ------------------------------------------------ float32: plain FMA
// Rows [row0, row0 + kB) of one head of a (B, S, H, D) f32 tensor into a
// kB x ld tile; rows at or past `limit` are zero.
template <int D>
__device__ __forceinline__ void load_tile(float* dst, int ld, const float* src,
                                          long long row_stride, int row0,
                                          int limit) {
  constexpr int EPC = 4;         // floats per 16-byte chunk
  constexpr int CPR = D / EPC;   // chunks per row
  for (int idx = threadIdx.x; idx < kB * CPR; idx += kThreads) {
    const int r = idx / CPR;
    const int c = idx % CPR;
    float v[EPC];
    if (row0 + r < limit) {
      ptt::load_vec<float, EPC>(
          src + (long long)(row0 + r) * row_stride + c * EPC, v);
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPC; ++e) dst[r * ld + c * EPC + e] = v[e];
  }
}

// kB consecutive values of one head's row of a (B, H, S) f32 tensor;
// zero at or past `limit`.
__device__ __forceinline__ void load_rowvals(float* dst, const float* src,
                                             int row0, int limit) {
  for (int r = threadIdx.x; r < kB; r += kThreads)
    dst[r] = row0 + r < limit ? src[row0 + r] : 0.f;
}

// s[i][j] = sum_d A[ty*4 + i][d] * Bt[tx + 16*j][d] over two kB x (D+1)
// tiles: the thread's 4 x 4 block of A Bt^T.
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* A,
                                         const float* Bt, int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float x[4], y[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = A[(ty * 4 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) y[j] = Bt[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] += x[i] * y[j];
  }
}

// Whether query `row` sees key `col`: both inside, and under the causal
// mask col <= row (top-left aligned).
__device__ __forceinline__ bool visible(const FlashArgs& a, int row,
                                        int col) {
  return row < a.Sq && col < a.Sk && (!a.causal || col <= row);
}

// ---------------------------------------------------------- B1, f32
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const FlashArgs a) {
  constexpr int LD = D + 1;
  constexpr int DPT = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;            // [kB][LD]
  float* sK = sQ + kB * LD;    // [kB][LD]
  float* sV = sK + kB * LD;    // [kB][D]
  float* sP = sV + kB * D;     // [kB][kLDP]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long rs = (long long)a.H * D;  // row stride of (B, S, H, D)
  const float* qb = static_cast<const float*>(a.q) +
                    ((long long)b * a.Sq * a.H + h) * D;
  const float* kb = static_cast<const float*>(a.k) +
                    ((long long)b * a.Sk * a.H + h) * D;
  const float* vb = static_cast<const float*>(a.v) +
                    ((long long)b * a.Sk * a.H + h) * D;

  load_tile<D>(sQ, LD, qb, rs, q0, a.Sq);

  float m[4], l[4], acc[4][DPT];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  // under the causal mask no row of this tile sees a key past its last
  const int c_end = a.causal ? min(a.Sk, q0 + kB) : a.Sk;
  for (int c0 = 0; c0 < c_end; c0 += kB) {
    load_tile<D>(sK, LD, kb, rs, c0, a.Sk);
    load_tile<D>(sV, D, vb, rs, c0, a.Sk);
    __syncthreads();

    float s[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = q0 + ty * 4 + i;
      bool ok[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = visible(a, row, c0 + tx + 16 * j);
        s[i][j] = ok[j] ? s[i][j] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row group are 16 consecutive lanes
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      float alpha = 1.f, rsum = 0.f;
      float p[4];
      if (mn == -INFINITY) {  // nothing visible to this row yet
#pragma unroll
        for (int j = 0; j < 4; ++j) p[j] = 0.f;
      } else {
        alpha = expf(m[i] - mn);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = ok[j] ? expf(s[i][j] - mn) : 0.f;
          rsum += p[j];
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rsum += __shfl_xor_sync(0xffffffffu, rsum, o);
      l[i] = l[i] * alpha + rsum;
      m[i] = mn;
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) acc[i][jj] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(ty * 4 + i) * kLDP + tx + 16 * j] = p[j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float pc[4], vc[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pc[i] = sP[(ty * 4 + i) * kLDP + c];
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) vc[jj] = sV[c * D + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) acc[i][jj] += pc[i] * vc[jj];
    }
    __syncthreads();
  }

  float* ob = static_cast<float*>(a.out) + ((long long)b * a.Sq * a.H + h) * D;
  float* lse = static_cast<float*>(a.out2) + ((long long)b * a.H + h) * a.Sq;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj)
      ob[row * rs + tx + 16 * jj] =
          l[i] > 0.f ? acc[i][jj] / l[i] : 0.f;
    if (tx == 0) lse[row] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
  }
}

// p and ds of the thread's 4 x 4 block of a (query tile r0, key tile
// c0) pair into the kB x kLDP tiles sP (may be null) and sS, rows =
// queries, columns = keys. sL / sD hold the query tile's lse and delta.
template <int D>
__device__ __forceinline__ void probs_and_ds(
    const FlashArgs& a, const float* sQ, const float* sO, const float* sK,
    const float* sV, const float* sL, const float* sD, float* sP, float* sS,
    int r0, int c0, int ty, int tx) {
  float s[4][4], dp[4][4];
  tile_dot<D>(s, sQ, sK, ty, tx);
  tile_dot<D>(dp, sO, sV, ty, tx);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i;
    const float lr = sL[r];
    const float dr = sD[r];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = tx + 16 * j;
      const float p =
          visible(a, r0 + r, c0 + c) ? expf(s[i][j] * a.scale - lr) : 0.f;
      const float ds = p * (dp[i][j] - dr) * a.scale;
      if (sP != nullptr) sP[r * kLDP + c] = p;
      sS[r * kLDP + c] = ds;
    }
  }
}

// ---------------------------------------------------------- B2, f32
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dkv_kernel(const FlashArgs a) {
  constexpr int LD = D + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;             // [kB][LD]
  float* sV = sK + kB * LD;     // [kB][LD]
  float* sQ = sV + kB * LD;     // [kB][LD]
  float* sO = sQ + kB * LD;     // [kB][LD] dO
  float* sP = sO + kB * LD;     // [kB][kLDP] p, rows = queries
  float* sS = sP + kB * kLDP;   // [kB][kLDP] ds
  float* sL = sS + kB * kLDP;   // [kB] lse
  float* sD = sL + kB;          // [kB] delta

  const int k0 = blockIdx.x * kB;  // key tile 0 is the longest
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long rs = (long long)a.H * D;
  const long long qoff = ((long long)b * a.Sq * a.H + h) * D;
  const long long koff = ((long long)b * a.Sk * a.H + h) * D;
  const long long loff = ((long long)b * a.H + h) * a.Sq;

  load_tile<D>(sK, LD, static_cast<const float*>(a.k) + koff, rs, k0, a.Sk);
  load_tile<D>(sV, LD, static_cast<const float*>(a.v) + koff, rs, k0, a.Sk);

  float dk[4][DPT], dv[4][DPT];  // keys ty*4 + i, columns tx + 16*jj
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) dk[i][jj] = dv[i][jj] = 0.f;

  // under the causal mask query rows before k0 see none of these keys
  for (int r0 = a.causal ? k0 : 0; r0 < a.Sq; r0 += kB) {
    load_tile<D>(sQ, LD, static_cast<const float*>(a.q) + qoff, rs, r0, a.Sq);
    load_tile<D>(sO, LD, static_cast<const float*>(a.dout) + qoff, rs, r0,
                    a.Sq);
    load_rowvals(sL, a.lse + loff, r0, a.Sq);
    load_rowvals(sD, a.delta + loff, r0, a.Sq);
    __syncthreads();

    probs_and_ds<D>(a, sQ, sO, sK, sV, sL, sD, sP, sS, r0, k0, ty, tx);
    __syncthreads();

#pragma unroll 4
    for (int r = 0; r < kB; ++r) {
      float pr[4], sr[4], orow[DPT], qrow[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        pr[i] = sP[r * kLDP + ty * 4 + i];
        sr[i] = sS[r * kLDP + ty * 4 + i];
      }
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) {
        orow[jj] = sO[r * LD + tx + 16 * jj];
        qrow[jj] = sQ[r * LD + tx + 16 * jj];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) {
          dv[i][jj] += pr[i] * orow[jj];
          dk[i][jj] += sr[i] * qrow[jj];
        }
    }
    __syncthreads();
  }

  float* dkb = static_cast<float*>(a.out) + koff;
  float* dvb = static_cast<float*>(a.out2) + koff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty * 4 + i;
    if (key >= a.Sk) continue;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) {
      dkb[key * rs + tx + 16 * jj] = dk[i][jj];
      dvb[key * rs + tx + 16 * jj] = dv[i][jj];
    }
  }
}

// ---------------------------------------------------------- B3, f32
template <int D>
__global__ void __launch_bounds__(kThreads)
    flash_bwd_dq_kernel(const FlashArgs a) {
  constexpr int LD = D + 1;
  constexpr int DPT = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;             // [kB][LD]
  float* sO = sQ + kB * LD;     // [kB][LD] dO
  float* sK = sO + kB * LD;     // [kB][LD]
  float* sV = sK + kB * LD;     // [kB][LD]
  float* sS = sV + kB * LD;     // [kB][kLDP] ds, rows = queries
  float* sL = sS + kB * kLDP;   // [kB] lse
  float* sD = sL + kB;          // [kB] delta

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const long long rs = (long long)a.H * D;
  const long long qoff = ((long long)b * a.Sq * a.H + h) * D;
  const long long koff = ((long long)b * a.Sk * a.H + h) * D;
  const long long loff = ((long long)b * a.H + h) * a.Sq;

  load_tile<D>(sQ, LD, static_cast<const float*>(a.q) + qoff, rs, q0, a.Sq);
  load_tile<D>(sO, LD, static_cast<const float*>(a.dout) + qoff, rs, q0,
                  a.Sq);
  load_rowvals(sL, a.lse + loff, q0, a.Sq);
  load_rowvals(sD, a.delta + loff, q0, a.Sq);

  float dq[4][DPT];  // rows ty*4 + i, columns tx + 16*jj
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj) dq[i][jj] = 0.f;

  const int c_end = a.causal ? min(a.Sk, q0 + kB) : a.Sk;
  for (int c0 = 0; c0 < c_end; c0 += kB) {
    load_tile<D>(sK, LD, static_cast<const float*>(a.k) + koff, rs, c0, a.Sk);
    load_tile<D>(sV, LD, static_cast<const float*>(a.v) + koff, rs, c0, a.Sk);
    __syncthreads();

    probs_and_ds<D>(a, sQ, sO, sK, sV, sL, sD, nullptr, sS, q0, c0, ty,
                       tx);
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kB; ++c) {
      float sr[4], kc[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) sr[i] = sS[(ty * 4 + i) * kLDP + c];
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) kc[jj] = sK[c * LD + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) dq[i][jj] += sr[i] * kc[jj];
    }
    __syncthreads();
  }

  float* dqb = static_cast<float*>(a.out) + qoff;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = q0 + ty * 4 + i;
    if (row >= a.Sq) continue;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj)
      dqb[row * rs + tx + 16 * jj] = dq[i][jj];
  }
}


using bf16 = __nv_bfloat16;

// -------------------------------------- bf16 on Hopper: B1, B2 and B3
constexpr int kHopRows = 128;       // row-tile rows of a CTA (two warpgroups)
constexpr int kHopConsumers = 256;  // threads of the consumer warpgroups
constexpr int kHopThreads = 384;    // and one producer warpgroup
constexpr int kHopStages = 2;       // ring depth of the streamed tiles
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a Hopper flash CTA, byte offsets from a 1024-aligned
// base: NQ row tiles of kHopRows x D loaded once (B1: Q; B2: K and V; B3:
// Q and dO), the ring of kHopStages tile pairs of BN x D (B1, B3: K and
// V; B2: Q and dO), then the barriers full[kHopStages], empty[kHopStages]
// and the row tiles'. A tile of D columns is D / 64 TMA boxes of 64
// (hopper.cuh's layout law).
template <int D, int BN, int NQ, int ROWS = kHopRows>
struct HopSmem {
  static constexpr int kRowTile = ROWS * D * 2;
  static constexpr int kTile = BN * D * 2;
  static constexpr int kRing = NQ * kRowTile;
  static constexpr int kBars = kRing + kHopStages * 2 * kTile;
  static constexpr int kRowBar = kBars + 16 * kHopStages;
  static constexpr int kBytes = kRowBar + 8;
};

// The ring's barriers (full: one arrival and the TMA bytes; empty: every
// consumer thread) and the row tiles', before the roles split.
template <typename L>
__device__ __forceinline__ void hop_init(uint32_t base) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < kHopStages; ++s) {
      hop::mbar_init(base + L::kBars + 8 * s, 1);
      hop::mbar_init(base + L::kBars + 8 * (kHopStages + s), kHopConsumers);
    }
    hop::mbar_init(base + L::kRowBar, 1);
    hop::fence_barrier_init();
  }
  __syncthreads();
}

// The producer: the NQ row tiles of rows [r0, r0 + ROWS) once (maps
// rm[0 .. NQ)), then rows [c0, c0 + n_tiles * BN) of the maps ta and tb
// through the ring: a stage is refilled once all consumer threads
// released it. Rows past the end of a tensor arrive as zeros (TMA's
// out-of-bounds fill).
template <int D, int BN, int NQ, int ROWS = kHopRows>
__device__ __forceinline__ void hop_produce(uint32_t base,
                                            const CUtensorMap* const* rm,
                                            const CUtensorMap* ta,
                                            const CUtensorMap* tb, int h,
                                            int b, int r0, int c0,
                                            int n_tiles) {
  using L = HopSmem<D, BN, NQ, ROWS>;
  hop::mbar_arrive_expect_tx(base + L::kRowBar, NQ * L::kRowTile);
  for (int n = 0; n < NQ; ++n)
    for (int j = 0; j < D / 64; ++j)
      hop::tma_load_4d(base + n * L::kRowTile + j * ROWS * 128, rm[n],
                       base + L::kRowBar, 64 * j, h, r0, b);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kHopStages;
    const uint32_t full = base + L::kBars + 8 * s;
    const uint32_t st = base + L::kRing + s * 2 * L::kTile;
    const int c = c0 + it * BN;
    hop::mbar_wait(full + 8 * kHopStages, ((it / kHopStages) & 1) ^ 1);
    hop::mbar_arrive_expect_tx(full, 2 * L::kTile);
    for (int j = 0; j < D / 64; ++j) {
      hop::tma_load_4d(st + j * BN * 128, ta, full, 64 * j, h, c, b);
      hop::tma_load_4d(st + L::kTile + j * BN * 128, tb, full, 64 * j, h, c,
                       b);
    }
  }
}

// The warpgroup's 64 x D block of acc, scaled per row by inv[i] (rows
// row[0] and row[1] of this thread), into one head of (B, S, H, D) bf16;
// rows past `limit` skip.
template <int D>
__device__ __forceinline__ void hop_store(bf16* dst, long long row_stride,
                                          const int (&row)[2], int limit,
                                          const float (&acc)[D / 2],
                                          const float (&inv)[2], int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (row[i] >= limit) continue;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + row[i] * row_stride + 8 * j +
                                   2 * t) =
          ptt::pack_bf16(acc[4 * j + 2 * i] * inv[i],
                         acc[4 * j + 2 * i + 1] * inv[i]);
  }
}

// --------------------------------------------------------- B1, bf16
template <int D>
__global__ void __launch_bounds__(kHopThreads, 1)
    flash_fwd_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                           const __grid_constant__ CUtensorMap tk,
                           const __grid_constant__ CUtensorMap tv,
                           const FlashArgs a) {
  constexpr int BN = 128;  // keys of a ring tile
  using L = HopSmem<D, BN, 1>;
  extern __shared__ __align__(128) unsigned char hop_smem[];
  const uint32_t base = (hop::smem_u32(hop_smem) + 1023u) & ~1023u;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kHopRows;  // longest first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // under the causal mask no row of this tile sees a key past its last
  const int c_end = a.causal ? min(a.Sk, q0 + kHopRows) : a.Sk;
  const int n_tiles = (c_end + BN - 1) / BN;
  hop_init<L>(base);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    hop::setmaxnreg_dec<24>();
    const CUtensorMap* rm[1] = {&tq};
    if (threadIdx.x == 2 * 128)
      hop_produce<D, BN, 1>(base, rm, &tk, &tv, h, b, q0, 0, n_tiles);
    return;
  }
  hop::setmaxnreg_inc<240>();
  const int w = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int r0 = q0 + 64 * wg;  // the warpgroup's first row
  const int row[2] = {r0 + 16 * w + g, r0 + 16 * w + g + 8};
  const float c = a.scale * kLog2e;  // exp(x * scale) = 2^(x * c)
  const uint32_t qa = base + wg * 64 * 128;  // its rows of each Q box

  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // m: the row's running max of the raw scores q.k; l: this thread's
  // share of its running sum of p (the quad's four shares add up last)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  hop::mbar_wait(base + L::kRowBar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kHopStages;
    const uint32_t sk = base + L::kRing + s * 2 * L::kTile;
    hop::mbar_wait(base + L::kBars + 8 * s, (it / kHopStages) & 1);
    float sc[BN / 2];
    hop::wgmma_fence();
    hop::wgmma_xyt<D, BN, kHopRows, BN>(sc, qa, sk);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);

    // only a tile that crosses the diagonal or the end of the keys masks
    const int c0 = it * BN;
    if (c0 + BN > a.Sk || (a.causal && c0 + BN - 1 > r0)) {
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int col = c0 + 8 * j + 2 * t + (e & 1);
          if (col >= a.Sk || (a.causal && col > row[e >> 1]))
            sc[4 * j + e] = -INFINITY;
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // rows g and g + 8
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      // the 4 threads of a row are 4 consecutive lanes
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[i], mx);
      const float mc = mn == -INFINITY ? 0.f : mn * c;
      const float alpha = hop::exp2_approx(m[i] * c - mc);  // 0 from -inf
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < BN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = sc[4 * j + 2 * i + e];
          x = hop::exp2_approx(fmaf(x, c, -mc));  // masked: 2^-inf = 0
          rsum += x;
        }
      l[i] = l[i] * alpha + rsum;
      m[i] = mn;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j + 2 * i] *= alpha;
        o[4 * j + 2 * i + 1] *= alpha;
      }
    }
    // p is cast to V's dtype before the product, l sums it unrounded
    hop::wgmma_pz<D, BN>(o, sc, sk + L::kTile);
    hop::mbar_arrive(base + L::kBars + 8 * (kHopStages + s));
  }

  float inv[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    inv[i] = l[i] > 0.f ? 1.f / l[i] : 0.f;
  }
  const long long rs = (long long)a.H * D;
  hop_store<D>(static_cast<bf16*>(a.out) +
                   ((long long)b * a.Sq * a.H + h) * D,
               rs, row, a.Sq, o, inv, t);
  if (t == 0) {
    float* lse = static_cast<float*>(a.out2) + ((long long)b * a.H + h) * a.Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      // natural-log units: the max in the plain version's own rounding
      if (row[i] < a.Sq)
        lse[row[i]] = l[i] > 0.f ? m[i] * a.scale + logf(l[i]) : -INFINITY;
  }
}

// --------------------------------------------------------- B3, bf16
template <int D>
__global__ void __launch_bounds__(kHopThreads, 1)
    flash_bwd_dq_wgmma_kernel(const __grid_constant__ CUtensorMap tq,
                              const __grid_constant__ CUtensorMap tdo,
                              const __grid_constant__ CUtensorMap tk,
                              const __grid_constant__ CUtensorMap tv,
                              const FlashArgs a) {
  // keys of a ring tile: 64, as S, dP (32 registers each) and dQ (D / 2)
  // then fit in a consumer's 240 registers with room to spare; 128-key
  // tiles would need 192 for the three sums and 32 more for ds
  constexpr int BN = 64;
  using L = HopSmem<D, BN, 2>;
  extern __shared__ __align__(128) unsigned char hop_smem[];
  const uint32_t base = (hop::smem_u32(hop_smem) + 1023u) & ~1023u;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kHopRows;  // longest first
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  const int c_end = a.causal ? min(a.Sk, q0 + kHopRows) : a.Sk;
  const int n_tiles = (c_end + BN - 1) / BN;
  hop_init<L>(base);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    hop::setmaxnreg_dec<24>();
    const CUtensorMap* rm[2] = {&tq, &tdo};
    if (threadIdx.x == 2 * 128)
      hop_produce<D, BN, 2>(base, rm, &tk, &tv, h, b, q0, 0, n_tiles);
    return;
  }
  hop::setmaxnreg_inc<240>();
  const int w = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int r0 = q0 + 64 * wg;
  const int row[2] = {r0 + 16 * w + g, r0 + 16 * w + g + 8};
  const float c = a.scale * kLog2e;
  const uint32_t qa = base + wg * 64 * 128;               // Q rows
  const uint32_t oa = base + L::kRowTile + wg * 64 * 128;  // dO rows
  const long long loff = ((long long)b * a.H + h) * a.Sq;
  // p = exp(s * scale - lse) = 2^(s * c - lse * log2e)
  float lse2[2], dl[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    lse2[i] = row[i] < a.Sq ? a.lse[loff + row[i]] * kLog2e : 0.f;
    dl[i] = row[i] < a.Sq ? a.delta[loff + row[i]] : 0.f;
  }
  float dq[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
  hop::mbar_wait(base + L::kRowBar, 0);
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kHopStages;
    const uint32_t sk = base + L::kRing + s * 2 * L::kTile;
    hop::mbar_wait(base + L::kBars + 8 * s, (it / kHopStages) & 1);
    float sc[BN / 2], dp[BN / 2];
    hop::wgmma_fence();
    hop::wgmma_xyt<D, BN, kHopRows, BN>(sc, qa, sk);       // q . k
    hop::wgmma_xyt<D, BN, kHopRows, BN>(dp, oa, sk + L::kTile);  // dO . v
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);
    hop::fence_regs(dp);

    const int c0 = it * BN;
    const bool edge = c0 + BN > a.Sk || (a.causal && c0 + BN - 1 > r0);
#pragma unroll
    for (int j = 0; j < BN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = e >> 1;
        float p = hop::exp2_approx(fmaf(sc[4 * j + e], c, -lse2[i]));
        if (edge) {
          const int col = c0 + 8 * j + 2 * t + (e & 1);
          if (col >= a.Sk || (a.causal && col > row[i])) p = 0.f;
        }
        dp[4 * j + e] = p * (dp[4 * j + e] - dl[i]) * a.scale;  // ds
      }
    // ds is cast to k's dtype before the product; K is the same ring
    // tile, read as the MN-major operand
    hop::wgmma_pz<D, BN>(dq, dp, sk);
    hop::mbar_arrive(base + L::kBars + 8 * (kHopStages + s));
  }
  const float one[2] = {1.f, 1.f};
  hop_store<D>(static_cast<bf16*>(a.out) +
                   ((long long)b * a.Sq * a.H + h) * D,
               (long long)a.H * D, row, a.Sq, dq, one, t);
}

// --------------------------------------------------------- B2, bf16
// Keys of a B2 CTA and queries of its ring tiles. ptxas allocates the
// consumers within the entry's 168 registers (not setmaxnreg's 240): one
// warpgroup holding both dK and dV (D registers) beside the transposed S
// and dP spilled and serialized its wgmma at D = 128, with 64- or
// 32-query tiles. So the two consumer warpgroups share one
// 64-key tile and split the work instead: warpgroup 0 computes S^T, p and
// dV += p^T dO and hands p to warpgroup 1 through shared memory, which
// computes dP^T, ds and dK += ds^T q. Each holds one D-wide sum and one
// 64 x 64 score tile: four products a tile, none twice.
constexpr int kDkvKeys = 64;
constexpr int kDkvBQ = 64;

// B2's shared memory: HopSmem's (K and V row tiles of kDkvKeys rows, the
// ring of Q and dO tiles, the barriers), then from kP two slots of p as
// warpgroup 0's threads hold it (32 floats a thread), then from kRows
// each warpgroup's two slots (the tile in use and the next) of kDkvBQ
// f32: lse * log2(e) for warpgroup 0, delta for warpgroup 1.
template <int D>
struct DkvSmem {
  using L = HopSmem<D, kDkvBQ, 2, kDkvKeys>;
  static constexpr int kP = (L::kBytes + 15) & ~15;
  static constexpr int kPSlot = kDkvKeys * kDkvBQ * 4;
  static constexpr int kRows = kP + 2 * kPSlot;
  static constexpr int kBytes = kRows + 2 * 2 * kDkvBQ * 4;
};

// named barriers (0 is __syncthreads): p of slot s written (kBarPFull + s)
// and read (kBarPFree + s) across the two warpgroups; warpgroup wg's row
// values staged (kBarRows + wg)
constexpr int kBarPFull = 1, kBarPFree = 3, kBarRows = 5;

template <int D>
__global__ void __launch_bounds__(kHopThreads, 1)
    flash_bwd_dkv_wgmma_kernel(const __grid_constant__ CUtensorMap tk,
                               const __grid_constant__ CUtensorMap tv,
                               const __grid_constant__ CUtensorMap tq,
                               const __grid_constant__ CUtensorMap tdo,
                               const FlashArgs a) {
  constexpr int BQ = kDkvBQ;
  constexpr int NP = BQ / 2;  // score registers of a thread
  using L = HopSmem<D, BQ, 2, kDkvKeys>;
  using S = DkvSmem<D>;
  extern __shared__ __align__(128) unsigned char hop_smem[];
  const uint32_t base = (hop::smem_u32(hop_smem) + 1023u) & ~1023u;
  unsigned char* gbase = hop_smem + (base - hop::smem_u32(hop_smem));
  const int k0 = blockIdx.z * kDkvKeys;  // key tile 0 is the longest
  const int h = blockIdx.x;
  const int b = blockIdx.y;
  // under the causal mask query rows before k0 see none of these keys; a
  // key tile that no query sees streams nothing and writes zeros
  const int q_begin = a.causal ? k0 : 0;
  const int n_tiles = q_begin < a.Sq ? (a.Sq - q_begin + BQ - 1) / BQ : 0;
  hop_init<L>(base);
  const int wg = threadIdx.x / 128;
  if (wg == 2) {
    hop::setmaxnreg_dec<24>();
    const CUtensorMap* rm[2] = {&tk, &tv};
    if (threadIdx.x == 2 * 128 && n_tiles > 0)
      hop_produce<D, BQ, 2, kDkvKeys>(base, rm, &tq, &tdo, h, b, k0,
                                      q_begin, n_tiles);
    return;
  }
  hop::setmaxnreg_inc<240>();
  const int w = (threadIdx.x / 32) % 4;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const int li = threadIdx.x % 128;
  const int key[2] = {k0 + 16 * w + g, k0 + 16 * w + g + 8};
  const float c = a.scale * kLog2e;
  // warpgroup 0: K rows and lse; warpgroup 1: V rows and delta
  const uint32_t xa = base + wg * L::kRowTile;
  float4* pbuf = reinterpret_cast<float4*>(gbase + S::kP);
  float* rows = reinterpret_cast<float*>(gbase + S::kRows) + wg * 2 * BQ;
  // thread li < BQ stages query li of a tile: lse * log2(e) (p = 2^(s * c
  // - lse * log2(e)) = exp(s * scale - lse)) or delta; 0 past Sq
  const long long loff = ((long long)b * a.H + h) * a.Sq;
  auto row_val = [&](int it) {
    const int q = q_begin + it * BQ + li;
    if (li >= BQ || it >= n_tiles || q >= a.Sq) return 0.f;
    return wg == 0 ? a.lse[loff + q] * kLog2e : a.delta[loff + q];
  };
  float acc[D / 2];  // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
  if (n_tiles > 0) {
    if (li < BQ) rows[li] = row_val(0);
    hop::bar_sync(kBarRows + wg, 128);
    hop::mbar_wait(base + L::kRowBar, 0);
  }
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kHopStages;
    const int slot = it & 1;
    const uint32_t sq = base + L::kRing + s * 2 * L::kTile;  // Q, then dO
    const float next = row_val(it + 1);  // loaded a tile ahead
    const float* rv = rows + slot * BQ;
    float4* ps = pbuf + slot * (S::kPSlot / 16);
    const int q0 = q_begin + it * BQ;
    hop::mbar_wait(base + L::kBars + 8 * s, (it / kHopStages) & 1);
    // the transposed scores: rows are the tile's keys, columns its
    // queries (Q and dO as K-major B operands): k . q or v . dO
    float sc[NP];
    hop::wgmma_fence();
    hop::wgmma_xyt<D, BQ, kDkvKeys, BQ>(sc, xa, sq + wg * L::kTile);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);
    if (wg == 0) {
      // only a tile that crosses the diagonal or the end of the queries
      // masks: a query past Sq (zero-filled, lse 0) would give p = 1
      const bool edge =
          q0 + BQ > a.Sq || (a.causal && q0 < k0 + kDkvKeys - 1);
#pragma unroll
      for (int j = 0; j < BQ / 8; ++j) {
        const float2 l2 =
            *reinterpret_cast<const float2*>(rv + 8 * j + 2 * t);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int odd = e & 1;
          float p = hop::exp2_approx(
              fmaf(sc[4 * j + e], c, odd ? -l2.y : -l2.x));
          if (edge) {
            const int col = q0 + 8 * j + 2 * t + odd;
            if (col >= a.Sq || (a.causal && col < key[e >> 1])) p = 0.f;
          }
          sc[4 * j + e] = p;
        }
      }
      // hand p (unrounded) to warpgroup 1, once it has read this slot's
      // last p, two tiles back
      if (it >= 2) hop::bar_sync(kBarPFree + slot, 256);
#pragma unroll
      for (int i = 0; i < NP / 4; ++i)
        ps[i * 128 + li] = make_float4(sc[4 * i], sc[4 * i + 1],
                                       sc[4 * i + 2], sc[4 * i + 3]);
      hop::bar_arrive(kBarPFull + slot, 256);
      // dV += p^T dO, p cast to dO's dtype: the stage's dO tile read as
      // the MN-major operand
      hop::wgmma_pz<D, BQ>(acc, sc, sq + L::kTile);
    } else {
      hop::bar_sync(kBarPFull + slot, 256);
#pragma unroll
      for (int i = 0; i < NP / 4; ++i) {
        const float4 p = ps[i * 128 + li];
        // elements 4i .. 4i + 3: rows g, g, g + 8, g + 8 of columns
        // 8i + 2t and 8i + 2t + 1
        const float2 d0 = *reinterpret_cast<const float2*>(rv + 8 * i + 2 * t);
        sc[4 * i] = p.x * (sc[4 * i] - d0.x) * a.scale;  // ds
        sc[4 * i + 1] = p.y * (sc[4 * i + 1] - d0.y) * a.scale;
        sc[4 * i + 2] = p.z * (sc[4 * i + 2] - d0.x) * a.scale;
        sc[4 * i + 3] = p.w * (sc[4 * i + 3] - d0.y) * a.scale;
      }
      if (it + 2 < n_tiles) hop::bar_arrive(kBarPFree + slot, 256);
      // dK += ds^T q, ds cast to q's dtype: the stage's Q tile read as
      // the MN-major operand
      hop::wgmma_pz<D, BQ>(acc, sc, sq);
    }
    hop::mbar_arrive(base + L::kBars + 8 * (kHopStages + s));
    // the other slot was last read in tile it - 1, before the barrier
    // that ended it
    if (li < BQ) rows[(slot ^ 1) * BQ + li] = next;
    hop::bar_sync(kBarRows + wg, 128);
  }
  const float one[2] = {1.f, 1.f};
  const long long koff = ((long long)b * a.Sk * a.H + h) * D;
  hop_store<D>(static_cast<bf16*>(wg == 0 ? a.out2 : a.out) + koff,
               (long long)a.H * D, key, a.Sk, acc, one, t);
}

// ------------------------------------------------------------ launch
template <int KIND, int D>
constexpr size_t smem_bytes() {
  // f32 tiles of kB x (D + 1), score tiles of kB x kLDP, row values
  return sizeof(float) *
         (KIND == kFwd ? 2 * kB * (D + 1) + kB * D + kB * kLDP
          : KIND == kDkv ? 4 * kB * (D + 1) + 2 * kB * kLDP + 2 * kB
                         : 4 * kB * (D + 1) + kB * kLDP + 2 * kB);
}

// The plain FMA kernels (f32).
template <int KIND, int D>
cudaError_t launch(const FlashArgs& a, int B, cudaStream_t stream) {
  void (*kern)(const FlashArgs);
  if constexpr (KIND == kFwd)
    kern = flash_fwd_kernel<D>;
  else if constexpr (KIND == kDkv)
    kern = flash_bwd_dkv_kernel<D>;
  else
    kern = flash_bwd_dq_kernel<D>;
  const size_t nbytes = smem_bytes<KIND, D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(nbytes));
  if (e != cudaSuccess) return e;
  const int rows = KIND == kDkv ? a.Sk : a.Sq;
  const dim3 grid((rows + kB - 1) / kB, a.H, B);
  kern<<<grid, kThreads, nbytes, stream>>>(a);
  return cudaGetLastError();
}

// The TMA map of one (B, S, H, D) bf16 tensor as the 4-D tensor (D, H,
// S, B), innermost first, with byte strides (2 D, 2 H D, 2 S H D); a box
// is 64 columns x 1 head x `rows` rows x 1 batch row, 128-byte swizzled.
// Rows past S read as zeros and never as the next batch row's.
bool tma_map(CUtensorMap* map, const void* ptr, int D, int H, int S, int B,
             int rows) {
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(H),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {2ull * D, 2ull * H * D, 2ull * S * H * D};
  const cuuint32_t box[4] = {64, 1, static_cast<cuuint32_t>(rows), 1};
  return hop::tma_map_4d(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, ptr, dims,
                         strides, box, CU_TENSOR_MAP_SWIZZLE_128B);
}

// bf16 B1 (KIND kFwd) or B3 (kDq) on Hopper: grid (H, B, query tiles),
// the maps built here on the host and passed by value.
template <int KIND, int D>
cudaError_t launch_hopper(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr bool kDQ = KIND == kDq;
  constexpr int BN = kDQ ? 64 : 128;
  const int tiles = (a.Sq + kHopRows - 1) / kHopRows;
  if (tiles > 65535) return cudaErrorInvalidValue;
  CUtensorMap tq, tdo, tk, tv;
  if (!tma_map(&tq, a.q, D, a.H, a.Sq, B, kHopRows) ||
      !tma_map(&tk, a.k, D, a.H, a.Sk, B, BN) ||
      !tma_map(&tv, a.v, D, a.H, a.Sk, B, BN) ||
      (kDQ && !tma_map(&tdo, a.dout, D, a.H, a.Sq, B, kHopRows)))
    return cudaErrorInvalidValue;
  const size_t nbytes = HopSmem<D, BN, kDQ ? 2 : 1>::kBytes + 1024;
  const dim3 grid(a.H, B, tiles);
  cudaError_t e;
  if constexpr (kDQ) {
    e = cudaFuncSetAttribute(flash_bwd_dq_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(nbytes));
    if (e != cudaSuccess) return e;
    flash_bwd_dq_wgmma_kernel<D>
        <<<grid, kHopThreads, nbytes, stream>>>(tq, tdo, tk, tv, a);
  } else {
    e = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(nbytes));
    if (e != cudaSuccess) return e;
    flash_fwd_wgmma_kernel<D>
        <<<grid, kHopThreads, nbytes, stream>>>(tq, tk, tv, a);
  }
  return cudaGetLastError();
}

// bf16 B2 on Hopper: grid (H, B, key tiles of kDkvKeys), K and V the row
// tiles, Q and dO streamed in tiles of kDkvBQ rows.
template <int D>
cudaError_t launch_dkv_hopper(const FlashArgs& a, int B, cudaStream_t stream) {
  const int tiles = (a.Sk + kDkvKeys - 1) / kDkvKeys;
  if (tiles > 65535) return cudaErrorInvalidValue;
  CUtensorMap tk, tv, tq, tdo;
  if (!tma_map(&tk, a.k, D, a.H, a.Sk, B, kDkvKeys) ||
      !tma_map(&tv, a.v, D, a.H, a.Sk, B, kDkvKeys) ||
      !tma_map(&tq, a.q, D, a.H, a.Sq, B, kDkvBQ) ||
      !tma_map(&tdo, a.dout, D, a.H, a.Sq, B, kDkvBQ))
    return cudaErrorInvalidValue;
  const size_t nbytes = DkvSmem<D>::kBytes + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      flash_bwd_dkv_wgmma_kernel<D>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(nbytes));
  if (e != cudaSuccess) return e;
  const dim3 grid(a.H, B, tiles);
  flash_bwd_dkv_wgmma_kernel<D>
      <<<grid, kHopThreads, nbytes, stream>>>(tk, tv, tq, tdo, a);
  return cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16; D: 64 or 128.
template <int KIND>
cudaError_t dispatch(const FlashArgs& a, int B, int D, int dtype,
                     cudaStream_t stream) {
  if (B <= 0 || B > 65535 || a.H <= 0 || a.H > 65535 || a.Sq <= 0 ||
      a.Sk <= 0)
    return cudaErrorInvalidValue;
  if (dtype == 1) {
    if constexpr (KIND == kDkv) {
      if (D == 128) return launch_dkv_hopper<128>(a, B, stream);
      if (D == 64) return launch_dkv_hopper<64>(a, B, stream);
    } else {
      if (D == 128) return launch_hopper<KIND, 128>(a, B, stream);
      if (D == 64) return launch_hopper<KIND, 64>(a, B, stream);
    }
  } else if (dtype == 0) {
    if (D == 128) return launch<KIND, 128>(a, B, stream);
    if (D == 64) return launch<KIND, 64>(a, B, stream);
  }
  return cudaErrorInvalidValue;
}

FlashArgs make_args(const void* q, const void* k, const void* v, int H,
                    int Sq, int Sk, float scale, int causal) {
  FlashArgs a = {};
  a.q = q;
  a.k = k;
  a.v = v;
  a.H = H;
  a.Sq = Sq;
  a.Sk = Sk;
  a.scale = scale;
  a.causal = causal != 0;
  return a;
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// B1: out (B, Sq, H, D) model dtype, lse (B, H, Sq) f32.
extern "C" int ptt_flash_fwd(const void* q, const void* k, const void* v,
                             void* out, void* lse, int B, int H, int Sq,
                             int Sk, int D, float scale, int causal,
                             int dtype, void* stream) {
  FlashArgs a = make_args(q, k, v, H, Sq, Sk, scale, causal);
  a.out = out;
  a.out2 = lse;
  return static_cast<int>(
      dispatch<kFwd>(a, B, D, dtype, static_cast<cudaStream_t>(stream)));
}

// B2: dk, dv (B, Sk, H, D) model dtype.
extern "C" int ptt_flash_bwd_dkv(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dk, void* dv,
                                 int B, int H, int Sq, int Sk, int D,
                                 float scale, int causal, int dtype,
                                 void* stream) {
  FlashArgs a = make_args(q, k, v, H, Sq, Sk, scale, causal);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dk;
  a.out2 = dv;
  return static_cast<int>(
      dispatch<kDkv>(a, B, D, dtype, static_cast<cudaStream_t>(stream)));
}

// B3: dq (B, Sq, H, D) model dtype.
extern "C" int ptt_flash_bwd_dq(const void* q, const void* k, const void* v,
                                const void* dout, const void* lse,
                                const void* delta, void* dq, int B, int H,
                                int Sq, int Sk, int D, float scale,
                                int causal, int dtype, void* stream) {
  FlashArgs a = make_args(q, k, v, H, Sq, Sk, scale, causal);
  a.dout = dout;
  a.lse = static_cast<const float*>(lse);
  a.delta = static_cast<const float*>(delta);
  a.out = dq;
  return static_cast<int>(
      dispatch<kDq>(a, B, D, dtype, static_cast<cudaStream_t>(stream)));
}
