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
// What bounds them on the H100: operations. A causal forward at the
// training shape (S = 4096, D = 128) does 2*D*S^2 flops per head on
// 8*S*D bytes of q, k, v and O, about S/4 = 1024 flops per byte against
// the card's ~295 (989 TFLOP/s over 3.35 TB/s); the backward passes do
// 1.5x (B3) and 2x (B2) the forward's flops on a few more bytes. So the
// products belong on the tensor cores.
//
// What the design does about it (a first version: right before fast):
// - the TPU's sequential grid axis, which carries the softmax state (B1)
//   or the dK/dV (B2) and dQ (B3) sums in VMEM from one grid step to the
//   next, becomes a loop inside one CTA, so no sum crosses CTAs and no
//   atomics are needed: B1 and B3 run one CTA per (64-row query tile,
//   head, batch row) and loop over 64-row key tiles up to the tile's
//   causal limit; B2 runs one CTA per (64-row key tile, head, batch row)
//   and loops over the query tiles from the diagonal on. Tiles past the
//   causal limit cost nothing;
// - the causal grid is uneven (a tile's work grows with its distance
//   from the first row), so the longest CTAs are launched first: B1 and
//   B3 take their query tiles from the last, B2's key tile 0 is its
//   longest;
// - bf16, the training dtype: every product runs on the tensor cores
//   with mma.sync.m16n8k16 (bf16 in, f32 sums; mma.cuh). Four warps
//   each own 16 rows of the CTA's 64 (queries in B1 and B3, keys in
//   B2); the score tile and the online softmax state stay in registers,
//   and the score fragments become the A operand of the next product
//   without a trip through shared memory (p, or ds, rounded to bf16 as
//   the TPU kernels cast them). Tiles sit in shared memory as bf16 with
//   rows padded by 16 bytes, so every fragment load hits 32 distinct
//   banks; an operand that a product needs with its rows as the
//   contraction axis (V in B1, K in B3, Q and dO in B2) is also stored
//   transposed as it is loaded;
// - float32 (the tests' dtype) keeps plain f32 FMA: each of 256 threads
//   computes a 4 x 4 block of a 64 x 64 score tile and a 4 x (D/16)
//   block of its output from f32 tiles in shared memory;
// - rows past the end are loaded as zeros and masked, as the TPU
//   kernels' _zero_pad_rows does, so no unwritten memory reaches a sum.
// Left for later: wgmma (the only path to the full tensor-core rate),
// TMA and cp.async loads that overlap the products, and warp
// specialisation.

#include "common.cuh"
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


// ------------------------------------------------ bf16: tensor cores
using bf16 = __nv_bfloat16;
constexpr int kMmaThreads = 128;  // 4 warps x 16 rows
constexpr int kLdT = kB + 8;      // row of a transposed (D x kB) tile

// Rows [row0, row0 + kB) of one head of a (B, S, H, D) bf16 tensor into
// shared memory: row-major into `rows` (kB x (D + 8)) and/or transposed
// into `cols` (D x kLdT); either may be null. Rows at or past `limit`
// are zero.
template <int D>
__device__ __forceinline__ void load_bf16(bf16* rows, bf16* cols,
                                          const bf16* src,
                                          long long row_stride, int row0,
                                          int limit) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int idx = threadIdx.x; idx < kB * CPR; idx += kMmaThreads) {
    const int r = idx % kB;   // neighbouring threads, neighbouring rows
    const int c = idx / kB;
    uint4 v = {0u, 0u, 0u, 0u};
    if (row0 + r < limit)
      v = *reinterpret_cast<const uint4*>(
          src + (long long)(row0 + r) * row_stride + c * 8);
    if (rows != nullptr)
      *reinterpret_cast<uint4*>(rows + r * (D + 8) + c * 8) = v;
    if (cols != nullptr) {
      const bf16* e = reinterpret_cast<const bf16*>(&v);
#pragma unroll
      for (int j = 0; j < 8; ++j) cols[(c * 8 + j) * kLdT + r] = e[j];
    }
  }
}

// s[nt] += X[r0 .. r0+16) . Y[nt*8 .. nt*8+8)^T over the D columns of two
// row-major bf16 tiles (row stride LD): the warp's 16 x 64 block of
// X Y^T, 8 n-tiles of 8 columns.
template <int D>
__device__ __forceinline__ void warp_dot(float (&s)[8][4], const bf16* X,
                                         const bf16* Y, int r0, int g,
                                         int t) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[nt][e] = 0.f;
#pragma unroll
  for (int k = 0; k < D; k += 16) {
    uint32_t a[4];
    a[0] = ptt::ld_pair(X + (r0 + g) * LD + k + 2 * t);
    a[1] = ptt::ld_pair(X + (r0 + g + 8) * LD + k + 2 * t);
    a[2] = ptt::ld_pair(X + (r0 + g) * LD + k + 8 + 2 * t);
    a[3] = ptt::ld_pair(X + (r0 + g + 8) * LD + k + 8 + 2 * t);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* y = Y + (nt * 8 + g) * LD + k + 2 * t;
      ptt::mma_bf16_16816(s[nt], a, ptt::ld_pair(y), ptt::ld_pair(y + 8));
    }
  }
}

// acc[dt] += P Z, P the warp's 16 x 64 block held as score fragments
// (rounded to bf16 here), Z a 64 x D operand stored transposed in `Zt`
// (D x kLdT): the A operand comes straight from the C fragments.
template <int D>
__device__ __forceinline__ void warp_pv(float (&acc)[D / 8][4],
                                        const float (&p)[8][4],
                                        const bf16* Zt, int g, int t) {
#pragma unroll
  for (int j = 0; j < 4; ++j) {  // 16-column slices of P
    uint32_t a[4];
    a[0] = ptt::pack_bf16(p[2 * j][0], p[2 * j][1]);
    a[1] = ptt::pack_bf16(p[2 * j][2], p[2 * j][3]);
    a[2] = ptt::pack_bf16(p[2 * j + 1][0], p[2 * j + 1][1]);
    a[3] = ptt::pack_bf16(p[2 * j + 1][2], p[2 * j + 1][3]);
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt) {
      const bf16* z = Zt + (dt * 8 + g) * kLdT + j * 16 + 2 * t;
      ptt::mma_bf16_16816(acc[dt], a, ptt::ld_pair(z), ptt::ld_pair(z + 8));
    }
  }
}

// The warp's 16 x D block of acc, scaled per row by inv[0] (row g) and
// inv[1] (row g + 8), into rows row0.. of one head; rows past Sq skip.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, long long row_stride,
                                           int row0, int limit,
                                           const float (&acc)[D / 8][4],
                                           const float (&inv)[2], int g,
                                           int t) {
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = row0 + g + 8 * i;
    if (row >= limit) continue;
#pragma unroll
    for (int dt = 0; dt < D / 8; ++dt)
      *reinterpret_cast<uint32_t*>(dst + row * row_stride + dt * 8 + 2 * t) =
          ptt::pack_bf16(acc[dt][2 * i] * inv[i], acc[dt][2 * i + 1] * inv[i]);
  }
}

// --------------------------------------------------------- B1, bf16
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_fwd_mma_kernel(const FlashArgs a) {
  constexpr int LD = D + 8;
  extern __shared__ float smem[];
  bf16* sQ = reinterpret_cast<bf16*>(smem);  // [kB][LD]
  bf16* sK = sQ + kB * LD;                   // [kB][LD]
  bf16* sVt = sK + kB * LD;                  // [D][kLdT]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wr = (threadIdx.x / 32) * 16;  // the warp's first row
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const long long rs = (long long)a.H * D;
  const bf16* qb = static_cast<const bf16*>(a.q) +
                   ((long long)b * a.Sq * a.H + h) * D;
  const bf16* kb = static_cast<const bf16*>(a.k) +
                   ((long long)b * a.Sk * a.H + h) * D;
  const bf16* vb = static_cast<const bf16*>(a.v) +
                   ((long long)b * a.Sk * a.H + h) * D;

  load_bf16<D>(sQ, nullptr, qb, rs, q0, a.Sq);
  float o[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[dt][e] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  const int c_end = a.causal ? min(a.Sk, q0 + kB) : a.Sk;
  for (int c0 = 0; c0 < c_end; c0 += kB) {
    load_bf16<D>(sK, nullptr, kb, rs, c0, a.Sk);
    load_bf16<D>(nullptr, sVt, vb, rs, c0, a.Sk);
    __syncthreads();

    float s[8][4];
    warp_dot<D>(s, sQ, sK, wr, g, t);
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // rows g and g + 8
      const int row = q0 + wr + g + 8 * i;
      float mx = -INFINITY;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * i + e];
          x = visible(a, row, c0 + nt * 8 + 2 * t + e) ? x * a.scale
                                                       : -INFINITY;
          mx = fmaxf(mx, x);
        }
      // the 4 threads of a row are 4 consecutive lanes
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[i], mx);
      float alpha = 1.f, rsum = 0.f;
#pragma unroll
      for (int nt = 0; nt < 8; ++nt)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[nt][2 * i + e];
          x = mn == -INFINITY ? 0.f : expf(x - mn);  // masked: exp(-inf) = 0
          rsum += x;
        }
      if (mn != -INFINITY) alpha = expf(m[i] - mn);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 1);
      rsum += __shfl_xor_sync(0xffffffffu, rsum, 2);
      l[i] = l[i] * alpha + rsum;
      m[i] = mn;
#pragma unroll
      for (int dt = 0; dt < D / 8; ++dt) {
        o[dt][2 * i] *= alpha;
        o[dt][2 * i + 1] *= alpha;
      }
    }
    // p is cast to V's dtype before the product, l sums it unrounded
    warp_pv<D>(o, s, sVt, g, t);
    __syncthreads();
  }

  const float inv[2] = {l[0] > 0.f ? 1.f / l[0] : 0.f,
                        l[1] > 0.f ? 1.f / l[1] : 0.f};
  store_rows<D>(static_cast<bf16*>(a.out) +
                    ((long long)b * a.Sq * a.H + h) * D,
                rs, q0 + wr, a.Sq, o, inv, g, t);
  if (t == 0) {
    float* lse = static_cast<float*>(a.out2) + ((long long)b * a.H + h) * a.Sq;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int row = q0 + wr + g + 8 * i;
      if (row < a.Sq) lse[row] = l[i] > 0.f ? m[i] + logf(l[i]) : -INFINITY;
    }
  }
}

// p = exp(s * scale - lse) where visible, else 0, and ds = p * (dp -
// delta) * scale, in place of the score fragments: s -> p, dp -> ds.
// `qrow`/`kcol` give a fragment element's query and key; lse/delta come
// per query from sL/sD (indexed by query - q_base).
template <bool KEYS_ARE_ROWS>
__device__ __forceinline__ void warp_probs(const FlashArgs& a,
                                           float (&s)[8][4],
                                           float (&dp)[8][4],
                                           const float* sL, const float* sD,
                                           int row0, int col0, int g,
                                           int t) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int r = g + 8 * (e / 2);          // row within the warp
      const int c = nt * 8 + 2 * t + (e % 2); // column within the tile
      // scores are (query, key) pairs: rows are queries in B3, keys in B2
      const int qi = KEYS_ARE_ROWS ? c : row0 % kB + r;
      const int query = KEYS_ARE_ROWS ? col0 + c : row0 + r;
      const int key = KEYS_ARE_ROWS ? row0 + r : col0 + c;
      const float p = visible(a, query, key)
                          ? expf(s[nt][e] * a.scale - sL[qi]) : 0.f;
      s[nt][e] = p;
      dp[nt][e] = p * (dp[nt][e] - sD[qi]) * a.scale;
    }
}

// --------------------------------------------------------- B3, bf16
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dq_mma_kernel(const FlashArgs a) {
  constexpr int LD = D + 8;
  extern __shared__ float smem[];
  float* sL = smem;                              // [kB] lse
  float* sD = sL + kB;                           // [kB] delta
  bf16* sQ = reinterpret_cast<bf16*>(sD + kB);   // [kB][LD]
  bf16* sO = sQ + kB * LD;                       // [kB][LD] dO
  bf16* sK = sO + kB * LD;                       // [kB][LD]
  bf16* sV = sK + kB * LD;                       // [kB][LD]
  bf16* sKt = sV + kB * LD;                      // [D][kLdT]

  const int q0 = (gridDim.x - 1 - blockIdx.x) * kB;  // longest tiles first
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wr = (threadIdx.x / 32) * 16;
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const long long rs = (long long)a.H * D;
  const long long qoff = ((long long)b * a.Sq * a.H + h) * D;
  const long long koff = ((long long)b * a.Sk * a.H + h) * D;
  const long long loff = ((long long)b * a.H + h) * a.Sq;

  load_bf16<D>(sQ, nullptr, static_cast<const bf16*>(a.q) + qoff, rs, q0,
               a.Sq);
  load_bf16<D>(sO, nullptr, static_cast<const bf16*>(a.dout) + qoff, rs, q0,
               a.Sq);
  for (int r = threadIdx.x; r < kB; r += kMmaThreads) {
    sL[r] = q0 + r < a.Sq ? a.lse[loff + q0 + r] : 0.f;
    sD[r] = q0 + r < a.Sq ? a.delta[loff + q0 + r] : 0.f;
  }
  float dq[D / 8][4];
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[dt][e] = 0.f;

  const int c_end = a.causal ? min(a.Sk, q0 + kB) : a.Sk;
  for (int c0 = 0; c0 < c_end; c0 += kB) {
    load_bf16<D>(sK, sKt, static_cast<const bf16*>(a.k) + koff, rs, c0,
                 a.Sk);
    load_bf16<D>(sV, nullptr, static_cast<const bf16*>(a.v) + koff, rs, c0,
                 a.Sk);
    __syncthreads();
    float s[8][4], dp[8][4];
    warp_dot<D>(s, sQ, sK, wr, g, t);
    warp_dot<D>(dp, sO, sV, wr, g, t);
    warp_probs<false>(a, s, dp, sL, sD, q0 + wr, c0, g, t);
    // ds is cast to k's dtype before the product
    warp_pv<D>(dq, dp, sKt, g, t);
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(static_cast<bf16*>(a.out) + qoff, rs, q0 + wr, a.Sq, dq, one,
                g, t);
}

// --------------------------------------------------------- B2, bf16
template <int D>
__global__ void __launch_bounds__(kMmaThreads)
    flash_bwd_dkv_mma_kernel(const FlashArgs a) {
  constexpr int LD = D + 8;
  extern __shared__ float smem[];
  float* sL = smem;                              // [kB] lse
  float* sD = sL + kB;                           // [kB] delta
  bf16* sK = reinterpret_cast<bf16*>(sD + kB);   // [kB][LD]
  bf16* sV = sK + kB * LD;                       // [kB][LD]
  bf16* sQ = sV + kB * LD;                       // [kB][LD]
  bf16* sO = sQ + kB * LD;                       // [kB][LD] dO
  bf16* sQt = sO + kB * LD;                      // [D][kLdT]
  bf16* sOt = sQt + D * kLdT;                    // [D][kLdT]

  const int k0 = blockIdx.x * kB;  // key tile 0 is the longest
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int wr = (threadIdx.x / 32) * 16;  // the warp's first key
  const int g = (threadIdx.x % 32) / 4;
  const int t = threadIdx.x % 4;
  const long long rs = (long long)a.H * D;
  const long long qoff = ((long long)b * a.Sq * a.H + h) * D;
  const long long koff = ((long long)b * a.Sk * a.H + h) * D;
  const long long loff = ((long long)b * a.H + h) * a.Sq;

  load_bf16<D>(sK, nullptr, static_cast<const bf16*>(a.k) + koff, rs, k0,
               a.Sk);
  load_bf16<D>(sV, nullptr, static_cast<const bf16*>(a.v) + koff, rs, k0,
               a.Sk);
  float dk[D / 8][4], dv[D / 8][4];  // the warp's 16 keys x D
#pragma unroll
  for (int dt = 0; dt < D / 8; ++dt)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[dt][e] = dv[dt][e] = 0.f;

  // under the causal mask query rows before k0 see none of these keys
  for (int r0 = a.causal ? k0 : 0; r0 < a.Sq; r0 += kB) {
    load_bf16<D>(sQ, sQt, static_cast<const bf16*>(a.q) + qoff, rs, r0,
                 a.Sq);
    load_bf16<D>(sO, sOt, static_cast<const bf16*>(a.dout) + qoff, rs, r0,
                 a.Sq);
    for (int r = threadIdx.x; r < kB; r += kMmaThreads) {
      sL[r] = r0 + r < a.Sq ? a.lse[loff + r0 + r] : 0.f;
      sD[r] = r0 + r < a.Sq ? a.delta[loff + r0 + r] : 0.f;
    }
    __syncthreads();
    // the transposed products: rows are the warp's keys, columns queries
    float s[8][4], dp[8][4];
    warp_dot<D>(s, sK, sQ, wr, g, t);    // (q . k)^T
    warp_dot<D>(dp, sV, sO, wr, g, t);   // (dO . v)^T
    warp_probs<true>(a, s, dp, sL, sD, k0 + wr, r0, g, t);
    // p is cast to dO's dtype, ds to q's, before the products
    warp_pv<D>(dv, s, sOt, g, t);        // p^T dO
    warp_pv<D>(dk, dp, sQt, g, t);       // ds^T q
    __syncthreads();
  }
  const float one[2] = {1.f, 1.f};
  store_rows<D>(static_cast<bf16*>(a.out) + koff, rs, k0 + wr, a.Sk, dk, one,
                g, t);
  store_rows<D>(static_cast<bf16*>(a.out2) + koff, rs, k0 + wr, a.Sk, dv,
                one, g, t);
}

// ------------------------------------------------------------ launch
template <int KIND, typename T, int D>
constexpr size_t smem_bytes() {
  if constexpr (std::is_same<T, float>::value)
    // f32 tiles of kB x (D + 1), score tiles of kB x kLDP, row values
    return sizeof(float) *
           (KIND == kFwd ? 2 * kB * (D + 1) + kB * D + kB * kLDP
            : KIND == kDkv ? 4 * kB * (D + 1) + 2 * kB * kLDP + 2 * kB
                           : 4 * kB * (D + 1) + kB * kLDP + 2 * kB);
  else
    // bf16 row-major tiles of kB x (D + 8), transposed of D x kLdT, and
    // two f32 rows of kB (lse, delta) in the backward kernels
    return sizeof(bf16) *
               (KIND == kFwd ? 2 * kB * (D + 8) + D * kLdT
                : KIND == kDkv ? 4 * kB * (D + 8) + 2 * D * kLdT
                               : 4 * kB * (D + 8) + D * kLdT) +
           (KIND == kFwd ? 0 : 2 * kB * sizeof(float));
}

template <int KIND, typename T, int D>
cudaError_t launch(const FlashArgs& a, int B, cudaStream_t stream) {
  constexpr bool kMma = std::is_same<T, bf16>::value;
  void (*kern)(const FlashArgs);
  if constexpr (KIND == kFwd)
    kern = kMma ? flash_fwd_mma_kernel<D> : flash_fwd_kernel<D>;
  else if constexpr (KIND == kDkv)
    kern = kMma ? flash_bwd_dkv_mma_kernel<D>
                : flash_bwd_dkv_kernel<D>;
  else
    kern = kMma ? flash_bwd_dq_mma_kernel<D> : flash_bwd_dq_kernel<D>;
  const size_t nbytes = smem_bytes<KIND, T, D>();
  cudaError_t e = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(nbytes));
  if (e != cudaSuccess) return e;
  const int rows = KIND == kDkv ? a.Sk : a.Sq;
  const dim3 grid((rows + kB - 1) / kB, a.H, B);
  kern<<<grid, kMma ? kMmaThreads : kThreads, nbytes, stream>>>(a);
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
    if (D == 128) return launch<KIND, bf16, 128>(a, B, stream);
    if (D == 64) return launch<KIND, bf16, 64>(a, B, stream);
  } else if (dtype == 0) {
    if (D == 128) return launch<KIND, float, 128>(a, B, stream);
    if (D == 64) return launch<KIND, float, 64>(a, B, stream);
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
