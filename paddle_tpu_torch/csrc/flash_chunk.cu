// B11 flash chunk attention: the multi-token ragged attention of a
// prefill or verify chunk against its dense temp cache, in a linear and
// a tree form.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/serving_fused.py
// `_chunk_kernel` / `_chunk_kernel_rowq` (B11-linear) and
// `_chunk_kernel_tree` / `_chunk_kernel_rowq_tree` (B11-tree, tree
// speculative verify), all reached through `flash_chunk_attention_kernel`.
//
// Semantics: q (B, T, H, D), cache ck/cv (B, W, HK, D) with W the static
// length; linear: query t of row b sees columns [kstart_b, W - T + t].
// Tree (TREE = true): the T chunk lanes are token-tree nodes and node t
// carries an int32 bitmask tree_bits[b, t] whose bit j is set iff chunk
// node j lies on t's root path; node t sees column c iff c >= kstart_b
// and either c < W - T (committed context) or bit (c - (W - T)) is set.
// Only that predicate differs from the linear form: the online softmax,
// the dequant and the blocking are the same code, chosen by shape alone,
// so a chain tree (bits (2 << t) - 1) gives the linear kernel's bits.
// int8 caches carry per-row f32 scales (B, W, HK); a row is dequantized
// and rounded to bf16 before its product (dequant-then-cast), p is
// rounded to bf16 before p.v while l sums it unrounded, and a row that
// sees no column writes 0, as the TPU kernels do.
//
// As the TPU kernel does, the T * rep query rows of one kv head (rep =
// H / HK) are packed into one tile, row r = t * rep + j for head
// g * rep + j, so each K/V byte is read once per kv head, not rep times.
// The packed row count M = T * rep picks one of two designs:
//
// 1. Prefill chunk, M >= 64 (the engine's T = 256): near the card's
//    balance point. A 64-row tile does 4 * 64 * D flops per key column on
//    4 D bytes of bf16 K and V (64 flops a byte, under the card's ~295:
//    989 TFLOP/s over 3.35 TB/s), but the M / 64 tiles of a head read the
//    same K/V from L2, so from HBM the chunk does M flops a byte: 256 at
//    T = 256, bound by bytes in bf16 (7.4 us at ctx 1024 over Llama-2-7B's
//    32 heads) and by operations in int8 (4.8 us). Either way the
//    products must run on the tensor cores. The design is B1's
//    (hopper.cuh):
//    - one CTA per (64 packed rows, kv head, batch row): the engine's
//      prefill has B = 1, and 128-row tiles would give 64 CTAs on 132
//      SMs at T = 256, H = 32; 64-row tiles give 128, one wave. So a CTA
//      is one consumer warpgroup and one producer warpgroup (256
//      threads), 1 CTA an SM at up to 255 registers (no setmaxnreg);
//    - K and V (B, W, HK, D) are read as the 4-D TMA tensor (D, HK, W, B):
//      bf16 boxes of 64 columns x 64 keys with the 128-byte swizzle that
//      wgmma reads, columns past W zero-filled. They stream through a
//      3-stage mbarrier ring: one producer thread keeps TMA in flight;
//    - int8 K/V arrive by TMA as int8 boxes (D x 64 keys, no swizzle)
//      into a 2-stage staging ring; the 128 producer threads dequantize
//      them into the swizzled bf16 ring tiles (the dequantized copy never
//      touches HBM), fence the generic proxy against wgmma's, and arrive
//      on the ring's full barrier. The producers are the int8 path's
//      bound, so a thread loads its rows' scales before the tile lands
//      and converts int8 exactly by a byte permute and an add (the
//      int-to-float unit runs at a quarter of the FMA rate);
//    - q.k^T is an SS wgmma (m64n64k16) on the Q tile (loaded once by
//      the consumers into the same swizzled layout) and K-major K; p.v
//      an RS wgmma with p packed to bf16 from the accumulator and V as
//      the MN-major operand of the same ring tile: no transposed copy;
//    - the key loop starts at kstart's tile and ends at the tile's
//      causal limit W - T + (last row's t) + 1 (linear) or at W (tree);
//      masks are applied only to tiles that cross kstart, W or the
//      chunk's columns; longest tiles are launched first.
// 2. Verify chunk, M < 64 (T = 5 and 9 in the engine, up to 32 tree
//    nodes): bound by bytes. 4 D flops a column per query row on 4 D K/V
//    bytes: M flops a byte, far under 295, so the design keeps bytes in
//    flight and spreads them over the card:
//    - the key axis is split across CTAs, flash-decoding style, into 1,
//      2, 4 or 8 splits of at least 256 columns (rounded to 64), chosen
//      from the shape alone (B, HK, W) so that the grid holds about two
//      CTAs an SM: a CTA's fixed costs (its first tile's latency, the
//      merge) outweigh the parallelism of more, shorter splits, so 8 rows
//      x 32 kv heads take 1 split and 8 x 8 take 4. A CTA is one (split,
//      kv head, batch row); a split wholly below kstart_b loads nothing
//      and leaves an empty partial, so short rows cost next to nothing.
//      The splits of one (row, kv head) form a thread block cluster and
//      merge their partial (m, l, acc) through distributed shared memory
//      in split order, so the merge is deterministic and needs no
//      workspace in HBM (the C entry has none to offer). The split rule,
//      the cluster launch and the merges are keysplit.cuh's, shared with
//      B8's decode (decode_attention.cu);
//    - K/V stream through a 3-stage cp.async ring of 64-key tiles (int8
//      with their row scales), rows past W zero-filled; 16-byte chunks
//      sit XOR-swizzled in shared memory so that the fragment reads below
//      spread over the banks (conflict-free for bf16 K/V);
//    - products are mma.sync.m16n8k16 (mma.cuh): the M packed rows fill
//      one, two or four 16-row tiles; 4 warps split each 64-key tile by
//      keys (16 each; with four row tiles, 2 row groups x 32 keys). The
//      contraction axes are permuted so a thread reads whole 16-byte
//      chunks: for q.k its d's of a k16 step are 4 consecutive columns
//      (one 8- or 4-byte piece of a K chunk), for p.v its 4 keys are 4
//      consecutive rows and its n8 columns are D / 8 consecutive d of a
//      row (output column (2t + e) * D / 8 + j); int8 K and V are
//      dequantized from shared memory into the bf16 fragments;
//    - each warp keeps an online softmax over its keys; the warps of a
//      CTA merge in warp order through shared memory, then the cluster.
// The float32 path (tests, not the card's main path) keeps plain f32 FMA:
// one CTA per (64 query rows, head, batch row), 64-column key blocks in
// shared memory, a 4 x 4 block of scores per thread.
// The page -> temp-cache gather stays in PyTorch, as it stays in XLA in
// the JAX package.

#include "common.cuh"
#include "hopper.cuh"
#include "keysplit.cuh"
#include "mma.cuh"

namespace {

namespace ksp = ptt::keysplit;
using bf16 = __nv_bfloat16;
using ptt::deq2;
using ptt::i8f;
using ptt::keysplit::swz;
constexpr float kLog2e = 1.4426950408889634f;

struct ChunkArgs {
  const void* q;          // (B, T, H, D) model dtype, contiguous
  const void* ck;         // (B, W, HK, D) model dtype or int8
  const void* cv;
  const float* k_rows;    // (B, W, HK) f32, int8 caches only
  const float* v_rows;
  const int* kstart;      // (B,) int32
  const int* tree_bits;   // (B, T) int32 ancestor bitmasks, tree only
  void* out;              // (B, T, H, D) model dtype, contiguous
  int T, H, HK, W;
  long long c_sb, c_sw, c_sh;  // element strides of ck/cv
  long long r_sb, r_sw, r_sh;  // element strides of k_rows/v_rows
  float scale;
};

// Whether packed row (query t, valid) sees column col, given kstart and
// the chunk's first column qoff: the one place the two forms differ.
template <bool TREE>
__device__ __forceinline__ bool sees(int col, int t, bool valid,
                                     unsigned anc, int kst, int qoff,
                                     int W) {
  if (!valid || col < kst || col >= W) return false;
  if (TREE) return col < qoff || ((anc >> (col - qoff)) & 1u);
  return col <= qoff + t;
}

// ==================================================== float32: plain FMA
constexpr int kF32Rows = 64;     // query rows per CTA
constexpr int kF32Keys = 64;     // key columns per block
constexpr int kF32Threads = 256; // 16 x 16

template <typename E, int D, bool QUANT>
__device__ __forceinline__ void load_rows(float* dst, int ld, const E* src,
                                          const float* rows, long long sw,
                                          long long rsw,
                                          int row0, int nrows, int limit) {
  constexpr int EPC = 16 / sizeof(E);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;         // chunks per row
  for (int idx = threadIdx.x; idx < nrows * CPR; idx += kF32Threads) {
    const int r = idx / CPR;
    const int c = idx % CPR;
    float v[EPC];
    if (row0 + r < limit) {
      ptt::load_vec<E, EPC>(src + (long long)(row0 + r) * sw + c * EPC, v);
      if (QUANT) {
        const float sc = rows[(long long)(row0 + r) * rsw];
#pragma unroll
        for (int e = 0; e < EPC; ++e) v[e] *= sc;
      }
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPC; ++e) dst[r * ld + c * EPC + e] = v[e];
  }
}

template <typename KV, int D, bool TREE>
__global__ void __launch_bounds__(kF32Threads)
    flash_chunk_f32_kernel(const ChunkArgs a) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int LDQ = D + 1;    // padded rows: conflict-free column walks
  constexpr int LDP = kF32Keys + 1;
  constexpr int DPT = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                     // [kF32Rows][LDQ]
  float* sK = sQ + kF32Rows * LDQ;      // [kF32Keys][LDQ]
  float* sV = sK + kF32Keys * LDQ;      // [kF32Keys][D]
  float* sP = sV + kF32Keys * D;        // [kF32Rows][LDP]

  const int q0 = blockIdx.x * kF32Rows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = a.H / a.HK;
  const int g = h / rep;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int qoff = a.W - a.T;
  const int kst = a.kstart[b];
  const int qend = min(q0 + kF32Rows, a.T);  // exclusive

  // Q tile: rows q0.. of head h (row stride H*D in the (B, T, H, D) q)
  load_rows<float, D, false>(
      sQ, LDQ,
      static_cast<const float*>(a.q) + ((long long)b * a.T * a.H + h) * D +
          (long long)q0 * a.H * D,
      nullptr, (long long)a.H * D, 0, 0, kF32Rows, a.T - q0);

  float m[4], l[4], acc[4][DPT];
  unsigned anc[4];  // this thread's rows' ancestor bits (tree only)
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    anc[i] = TREE && t < a.T
                 ? static_cast<unsigned>(a.tree_bits[b * a.T + t])
                 : 0u;
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DPT; ++j) acc[i][j] = 0.f;
  }

  const KV* kb = static_cast<const KV*>(a.ck) + (long long)b * a.c_sb +
                 (long long)g * a.c_sh;
  const KV* vb = static_cast<const KV*>(a.cv) + (long long)b * a.c_sb +
                 (long long)g * a.c_sh;
  const float* ksb = QUANT ? a.k_rows + (long long)b * a.r_sb +
                                 (long long)g * a.r_sh
                           : nullptr;
  const float* vsb = QUANT ? a.v_rows + (long long)b * a.r_sb +
                                 (long long)g * a.r_sh
                           : nullptr;
  const int c_begin = (max(kst, 0) / kF32Keys) * kF32Keys;
  // exclusive limit: the tile's causal limit, or W for a tree
  const int c_end = TREE ? a.W : min(a.W, qoff + qend);

  for (int c0 = c_begin; c0 < c_end; c0 += kF32Keys) {
    load_rows<KV, D, QUANT>(sK, LDQ, kb, ksb, a.c_sw, a.r_sw, c0, kF32Keys,
                            a.W);
    load_rows<KV, D, QUANT>(sV, D, vb, vsb, a.c_sw, a.r_sw, c0, kF32Keys,
                            a.W);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float qa[4], kc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[i] = sQ[(ty * 4 + i) * LDQ + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kc[j] = sK[(tx + 16 * j) * LDQ + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] += qa[i] * kc[j];
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int t = q0 + ty * 4 + i;
      bool ok[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        ok[j] = sees<TREE>(c0 + tx + 16 * j, t, t < a.T, anc[i], kst, qoff,
                           a.W);
        s[i][j] = ok[j] ? s[i][j] * a.scale : -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      // the 16 threads of a row group are 16 consecutive lanes
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, o));
      const float mn = fmaxf(m[i], mx);
      float alpha = 1.f, rs = 0.f;
      float p[4];
      if (mn == -INFINITY) {  // nothing visible to this row yet
#pragma unroll
        for (int j = 0; j < 4; ++j) p[j] = 0.f;
      } else {
        alpha = expf(m[i] - mn);
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          p[j] = ok[j] ? expf(s[i][j] - mn) : 0.f;
          rs += p[j];
        }
      }
#pragma unroll
      for (int o = 8; o > 0; o >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, o);
      l[i] = l[i] * alpha + rs;
      m[i] = mn;
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) acc[i][jj] *= alpha;
#pragma unroll
      for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * LDP + tx + 16 * j] = p[j];
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kF32Keys; ++c) {
      float pa[4], vc[DPT];
#pragma unroll
      for (int i = 0; i < 4; ++i) pa[i] = sP[(ty * 4 + i) * LDP + c];
#pragma unroll
      for (int jj = 0; jj < DPT; ++jj) vc[jj] = sV[c * D + tx + 16 * jj];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int jj = 0; jj < DPT; ++jj) acc[i][jj] += pa[i] * vc[jj];
    }
    __syncthreads();
  }

  float* ob = static_cast<float*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= a.T) continue;
    float* orow = ob + (((long long)b * a.T + t) * a.H + h) * D;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj)
      orow[tx + 16 * jj] = l[i] > 0.f ? acc[i][jj] / l[i] : 0.f;
  }
}

// ========================================= prefill chunk (M >= 64): wgmma
constexpr int kPreRows = 64;      // packed query rows of a CTA
constexpr int kPreBN = 64;        // keys of a ring tile
constexpr int kPreStages = 3;     // bf16 ring depth
constexpr int kPreStaging = 2;    // int8 staging ring depth
constexpr int kPreThreads = 256;  // consumer warpgroup, producer warpgroup

// Shared memory of a prefill CTA, byte offsets from a 1024-aligned base:
// the Q tile (D / 64 boxes of 64 rows x 128 bytes), the ring of bf16
// (K, V) tile pairs (D / 64 boxes of kPreBN rows each), for int8 the
// staging ring of (K, V) int8 tile pairs (kPreBN rows of D bytes), then
// the barriers full[kPreStages], empty[kPreStages], staged[kPreStaging].
template <int D, bool QUANT>
struct PreSmem {
  static constexpr int kQ = kPreRows * D * 2;
  static constexpr int kTile = kPreBN * D * 2;
  static constexpr int kTile8 = kPreBN * D;
  static constexpr int kRing = kQ;
  static constexpr int kStaging = kRing + kPreStages * 2 * kTile;
  static constexpr int kBars =
      kStaging + (QUANT ? kPreStaging * 2 * kTile8 : 0);
  static constexpr int kBytes = kBars + 8 * (2 * kPreStages + kPreStaging);
};

// The int8 producers' share of a tile: thread pt takes 16-byte chunk
// pt % CPR of rows pt / CPR + k * (128 / CPR), k < kDeqRows.
template <int D>
struct Deq {
  static constexpr int CPR = D / 16;                // int8 chunks of a row
  static constexpr int kRows = kPreBN * CPR / 128;  // rows a thread takes
  static __device__ __forceinline__ int row(int pt, int k) {
    return pt / CPR + k * (128 / CPR);
  }
};

// One staged int8 tile (kPreBN rows of D bytes at `src`) into the swizzled
// bf16 tile at `dst` (hopper.cuh's layout law): the thread's rows times
// their scales sc[k] (0 past W), rounded to bf16.
template <int D>
__device__ __forceinline__ void dequant_tile(unsigned char* dst,
                                             const unsigned char* src,
                                             const float (&sc)[Deq<D>::kRows],
                                             int pt) {
  const int c = pt % Deq<D>::CPR;
#pragma unroll
  for (int k = 0; k < Deq<D>::kRows; ++k) {
    const int r = Deq<D>::row(pt, k);
    const uint4 raw = *reinterpret_cast<const uint4*>(src + r * D + c * 16);
    const uint32_t* x = reinterpret_cast<const uint32_t*>(&raw);
    uint32_t w[8];
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      w[2 * q] = deq2(i8f(x[q], 0), sc[k], i8f(x[q], 1), sc[k]);
      w[2 * q + 1] = deq2(i8f(x[q], 2), sc[k], i8f(x[q], 3), sc[k]);
    }
    // bf16 columns 16c .. 16c + 15 are 16-byte chunks 2c and 2c + 1
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const int cc = 2 * c + hh;
      *reinterpret_cast<uint4*>(dst + (cc / 8) * kPreBN * 128 + r * 128 +
                                (((cc % 8) ^ (r % 8)) * 16)) =
          make_uint4(w[4 * hh], w[4 * hh + 1], w[4 * hh + 2], w[4 * hh + 3]);
    }
  }
}

// Barriers of a prefill CTA after its ring and staging bytes.
template <int D, bool QUANT>
struct PreBars {
  using L = PreSmem<D, QUANT>;
  static __device__ __forceinline__ uint32_t full(uint32_t base, int s) {
    return base + L::kBars + 8 * s;
  }
  static __device__ __forceinline__ uint32_t empty(uint32_t base, int s) {
    return base + L::kBars + 8 * (kPreStages + s);
  }
  static __device__ __forceinline__ uint32_t staged(uint32_t base, int s) {
    return base + L::kBars + 8 * (2 * kPreStages + s);
  }
};

// bf16 producer (one thread): keys c_begin .. of K and V through the
// ring by TMA; a stage is refilled once the consumers released it.
template <int D>
__device__ __forceinline__ void pre_produce_bf16(uint32_t base,
                                                 const CUtensorMap* tk,
                                                 const CUtensorMap* tv, int b,
                                                 int g, int c_begin,
                                                 int n_tiles) {
  using L = PreSmem<D, false>;
  using Bar = PreBars<D, false>;
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kPreStages;
    const uint32_t sk = base + L::kRing + s * 2 * L::kTile;
    const int c0 = c_begin + it * kPreBN;
    hop::mbar_wait(Bar::empty(base, s), ((it / kPreStages) & 1) ^ 1);
    hop::mbar_arrive_expect_tx(Bar::full(base, s), 2 * L::kTile);
    for (int j = 0; j < D / 64; ++j) {
      hop::tma_load_4d(sk + j * kPreBN * 128, tk, Bar::full(base, s), 64 * j,
                       g, c0, b);
      hop::tma_load_4d(sk + L::kTile + j * kPreBN * 128, tv,
                       Bar::full(base, s), 64 * j, g, c0, b);
    }
  }
}

// int8 producers (128 threads, pt the thread's index): thread 0 keeps the
// int8 tiles' TMA loads in flight through the staging ring; all of them
// dequantize each staged pair into the bf16 ring stage, fence the
// generic proxy against wgmma's, and arrive on the stage's full barrier.
template <int D>
__device__ __forceinline__ void pre_produce_int8(
    const ChunkArgs& a, uint32_t base, unsigned char* gbase,
    const CUtensorMap* tk, const CUtensorMap* tv, int b, int g, int c_begin,
    int n_tiles, int pt) {
  using L = PreSmem<D, true>;
  using Bar = PreBars<D, true>;
  const float* ksb = a.k_rows + (long long)b * a.r_sb + (long long)g * a.r_sh;
  const float* vsb = a.v_rows + (long long)b * a.r_sb + (long long)g * a.r_sh;
  auto stage_in = [&](int it) {
    const int ss = it % kPreStaging;
    const uint32_t dst = base + L::kStaging + ss * 2 * L::kTile8;
    const int c0 = c_begin + it * kPreBN;
    hop::mbar_arrive_expect_tx(Bar::staged(base, ss), 2 * L::kTile8);
    hop::tma_load_4d(dst, tk, Bar::staged(base, ss), 0, g, c0, b);
    hop::tma_load_4d(dst + L::kTile8, tv, Bar::staged(base, ss), 0, g, c0, b);
  };
  if (pt == 0)
    for (int it = 0; it < min(kPreStaging, n_tiles); ++it) stage_in(it);
  for (int it = 0; it < n_tiles; ++it) {
    const int ss = it % kPreStaging;
    const int s = it % kPreStages;
    const int c0 = c_begin + it * kPreBN;
    // the thread's row scales, loaded while the tile is still in flight
    float ksc[Deq<D>::kRows], vsc[Deq<D>::kRows];
#pragma unroll
    for (int k = 0; k < Deq<D>::kRows; ++k) {
      const int col = c0 + Deq<D>::row(pt, k);
      ksc[k] = col < a.W ? ksb[(long long)col * a.r_sw] : 0.f;
      vsc[k] = col < a.W ? vsb[(long long)col * a.r_sw] : 0.f;
    }
    hop::mbar_wait(Bar::staged(base, ss), (it / kPreStaging) & 1);
    hop::mbar_wait(Bar::empty(base, s), ((it / kPreStages) & 1) ^ 1);
    const unsigned char* src = gbase + L::kStaging + ss * 2 * L::kTile8;
    unsigned char* dst = gbase + L::kRing + s * 2 * L::kTile;
    dequant_tile<D>(dst, src, ksc, pt);
    dequant_tile<D>(dst + L::kTile, src + L::kTile8, vsc, pt);
    hop::fence_proxy_async();  // the bf16 tiles are wgmma operands
    hop::mbar_arrive(Bar::full(base, s));
    hop::bar_sync(1, 128);     // every producer is done with stage ss
    if (pt == 0 && it + kPreStaging < n_tiles) {
      hop::fence_proxy_async();
      stage_in(it + kPreStaging);
    }
  }
}

template <typename KV, int D, bool TREE>
__global__ void __launch_bounds__(kPreThreads, 1)
    flash_chunk_prefill_kernel(const __grid_constant__ CUtensorMap tk,
                         const __grid_constant__ CUtensorMap tv,
                         const ChunkArgs a) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  using L = PreSmem<D, QUANT>;
  extern __shared__ __align__(128) unsigned char pre_smem[];
  const uint32_t raw = hop::smem_u32(pre_smem);
  const uint32_t base = (raw + 1023u) & ~1023u;
  unsigned char* gbase = pre_smem + (base - raw);  // generic view of base
  const int rep = a.H / a.HK;
  const int M = a.T * rep;
  const int row0 = (gridDim.x - 1 - blockIdx.x) * kPreRows;  // longest first
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int qoff = a.W - a.T;
  const int kst = max(a.kstart[b], 0);
  const int t_first = row0 / rep;
  const int t_last = min(a.T - 1, (row0 + kPreRows - 1) / rep);
  const int c_begin = (kst / kPreBN) * kPreBN;
  const int c_end = TREE ? a.W : min(a.W, qoff + t_last + 1);
  const int n_tiles =
      c_end > c_begin ? (c_end - c_begin + kPreBN - 1) / kPreBN : 0;
  using Bar = PreBars<D, QUANT>;
  if (threadIdx.x == 0) {
    for (int s = 0; s < kPreStages; ++s) {
      // full: the TMA bytes (bf16) or every producer thread (int8)
      hop::mbar_init(Bar::full(base, s), QUANT ? 128 : 1);
      hop::mbar_init(Bar::empty(base, s), 128);
    }
    if (QUANT)
      for (int s = 0; s < kPreStaging; ++s)
        hop::mbar_init(Bar::staged(base, s), 1);
    hop::fence_barrier_init();
  }
  __syncthreads();

  if (threadIdx.x >= 128) {  // ------------------------------ producer
    if constexpr (QUANT)
      pre_produce_int8<D>(a, base, gbase, &tk, &tv, b, g, c_begin, n_tiles,
                          threadIdx.x - 128);
    else if (threadIdx.x == 128)
      pre_produce_bf16<D>(base, &tk, &tv, b, g, c_begin, n_tiles);
    return;
  }

  // ------------------------------------------------------------ consumer
  const int w = threadIdx.x / 32;
  const int gq = (threadIdx.x % 32) / 4;
  const int tq = threadIdx.x % 4;
  {  // the Q tile: packed rows row0.. of kv head g, swizzled as TMA would
    const bf16* qb = static_cast<const bf16*>(a.q) +
                     (long long)b * a.T * a.H * D;
    for (int i = threadIdx.x; i < kPreRows * (D / 8); i += 128) {
      const int r = i / (D / 8);
      const int c = i % (D / 8);
      const int pr = row0 + r;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (pr < M)
        v = *reinterpret_cast<const uint4*>(
            qb + ((long long)(pr / rep) * a.H + g * rep + pr % rep) * D +
            c * 8);
      *reinterpret_cast<uint4*>(gbase + (c / 8) * kPreRows * 128 + r * 128 +
                                (((c % 8) ^ (r % 8)) * 16)) = v;
    }
    hop::fence_proxy_async();
    hop::bar_sync(2, 128);
  }
  int row[2], tr[2];
  unsigned anc[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    row[i] = row0 + 16 * w + gq + 8 * i;
    tr[i] = row[i] < M ? row[i] / rep : 0;
    anc[i] = TREE && row[i] < M
                 ? static_cast<unsigned>(a.tree_bits[b * a.T + tr[i]])
                 : 0u;
  }
  const float c = a.scale * kLog2e;  // exp(x * scale) = 2^(x * c)
  float o[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
  // m: the row's running max of the raw scores q.k; l: this thread's
  // share of its running sum of p (the quad's four shares add up last)
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  for (int it = 0; it < n_tiles; ++it) {
    const int s = it % kPreStages;
    const uint32_t sk = base + L::kRing + s * 2 * L::kTile;
    const int c0 = c_begin + it * kPreBN;
    hop::mbar_wait(Bar::full(base, s), (it / kPreStages) & 1);
    float sc[kPreBN / 2];
    hop::wgmma_fence();
    hop::wgmma_xyt<D, kPreBN, kPreRows, kPreBN>(sc, base, sk);
    hop::wgmma_commit();
    hop::wgmma_wait<0>();
    hop::fence_regs(sc);

    // only a tile that crosses kstart, W or the chunk's columns masks
    const bool edge = c0 < kst || c0 + kPreBN > a.W ||
                      (TREE ? c0 + kPreBN > qoff
                            : c0 + kPreBN - 1 > qoff + t_first);
    if (edge) {
#pragma unroll
      for (int j = 0; j < kPreBN / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = e >> 1;
          const int col = c0 + 8 * j + 2 * tq + (e & 1);
          if (!sees<TREE>(col, tr[i], row[i] < M, anc[i], kst, qoff, a.W))
            sc[4 * j + e] = -INFINITY;
        }
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {  // rows g and g + 8
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < kPreBN / 8; ++j)
        mx = fmaxf(mx, fmaxf(sc[4 * j + 2 * i], sc[4 * j + 2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[i], mx);
      const float mc = mn == -INFINITY ? 0.f : mn * c;
      const float alpha = hop::exp2_approx(m[i] * c - mc);  // 0 from -inf
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < kPreBN / 8; ++j)
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
    hop::wgmma_pz<D, kPreBN>(o, sc, sk + L::kTile);
    hop::mbar_arrive(Bar::empty(base, s));
  }

  bf16* ob = static_cast<bf16*>(a.out);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 1);
    l[i] += __shfl_xor_sync(0xffffffffu, l[i], 2);
    if (row[i] >= M) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    bf16* dst = ob + (((long long)b * a.T + tr[i]) * a.H + g * rep +
                      row[i] % rep) * D;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      *reinterpret_cast<uint32_t*>(dst + 8 * j + 2 * tq) =
          ptt::pack_bf16(o[4 * j + 2 * i] * inv, o[4 * j + 2 * i + 1] * inv);
  }
}

// ======================================== verify chunk (M < 64): split keys
constexpr int kVerBN = ksp::kTile;          // keys of a ring tile
constexpr int kVerStages = ksp::kStages;    // cp.async ring depth
constexpr int kVerThreads = ksp::kThreads;  // four warps

// Shared memory of a verify CTA, byte offsets: the packed Q rows (MT * 16
// rows of D bf16, swizzled), the ring (kVerStages x (K, V) tiles, and for
// int8 their 2 x kVerBN row scales); after the key loop the ring's bytes
// hold the warps' partials (KS slices x MT * 16 rows: D acc, m, l) and
// then the CTA's merged partial, which the cluster reads.
template <typename KV, int D, int MT>
struct VerSmem {
  static constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
  static constexpr int CPR = kRowBytes / 16;
  static constexpr int kTile = kVerBN * kRowBytes;
  static constexpr int kStage = 2 * kTile + (QUANT ? 2 * kVerBN * 4 : 0);
  static constexpr int kQ = MT * 16 * D * 2;
  static constexpr int kRing = kQ;
  static constexpr int MTW = MT < 2 ? MT : 2;  // row tiles of a warp
  static constexpr int KS = 4 / (MT / MTW);    // key slices of a tile
  static constexpr int kRowsP = MT * 16;
  static constexpr int kPart = KS * kRowsP * (D + 2) * 4;
  static constexpr int kMerged = kRing + kPart;  // CTA partial: o, m, l
  static constexpr int kEnd = kMerged + kRowsP * (D + 2) * 4;
  static constexpr int kRingEnd = kRing + kVerStages * kStage;
  static constexpr int kBytes = kEnd > kRingEnd ? kEnd : kRingEnd;
};

// K/V tile (columns c0 .. c0 + kVerBN of kv head g, row b) and its row
// scales into ring stage `st`: one 16-byte cp.async a chunk, rows past W
// zero-filled.
template <typename KV, int D, int MT>
__device__ __forceinline__ void ver_load(const ChunkArgs& a, uint32_t st,
                                         int b, int g, int c0) {
  using L = VerSmem<KV, D, MT>;
  constexpr int CPR = L::CPR;
  constexpr int EPC = 16 / static_cast<int>(sizeof(KV));
  const KV* kb = static_cast<const KV*>(a.ck) + (long long)b * a.c_sb +
                 (long long)g * a.c_sh;
  const KV* vb = static_cast<const KV*>(a.cv) + (long long)b * a.c_sb +
                 (long long)g * a.c_sh;
#pragma unroll 4
  for (int i = threadIdx.x; i < 2 * kVerBN * CPR; i += kVerThreads) {
    const int which = i / (kVerBN * CPR);
    const int r = (i / CPR) % kVerBN;
    const int ch = i % CPR;
    const int col = c0 + r;
    const KV* src = (which ? vb : kb) +
                    (long long)min(col, a.W - 1) * a.c_sw + ch * EPC;
    hop::cp_async16(st + which * L::kTile + r * L::kRowBytes +
                        ((ch ^ swz<CPR>(r)) * 16),
                    src, col < a.W ? 16 : 0);
  }
  if constexpr (L::QUANT) {
    const long long off = (long long)b * a.r_sb + (long long)g * a.r_sh;
    for (int i = threadIdx.x; i < 2 * kVerBN; i += kVerThreads) {
      const int r = i % kVerBN;
      const int col = c0 + r;
      const float* src = (i < kVerBN ? a.k_rows : a.v_rows) + off +
                         (long long)min(col, a.W - 1) * a.r_sw;
      hop::cp_async4(st + 2 * L::kTile + i * 4, src, col < a.W ? 4 : 0);
    }
  }
}

template <typename KV, int D, bool TREE, int MT>
__global__ void __launch_bounds__(kVerThreads)
    flash_chunk_verify_kernel(const ChunkArgs a, int split) {
  using L = VerSmem<KV, D, MT>;
  constexpr bool QUANT = L::QUANT;
  constexpr int CPR = L::CPR;
  constexpr int MTW = L::MTW;
  constexpr int KS = L::KS;
  constexpr int KPW = kVerBN / KS;  // keys of a tile a warp takes
  constexpr int NT = D / 8;         // n8 tiles of p.v
  constexpr int QCPR = D / 8;       // 16-byte chunks of a Q row
  extern __shared__ __align__(128) unsigned char ver_smem[];
  const uint32_t base = hop::smem_u32(ver_smem);

  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = a.H / a.HK;
  const int M = a.T * rep;
  const int qoff = a.W - a.T;
  const int kst = max(a.kstart[b], 0);
  const int s_begin = blockIdx.x * split;
  const int s_end = min(a.W, s_begin + split);
  const int c_begin = max(s_begin, (kst / kVerBN) * kVerBN);
  const int n_tiles =
      s_end > c_begin ? (s_end - c_begin + kVerBN - 1) / kVerBN : 0;

  const int w = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;
  const int rg = w / KS;   // row group: row tiles rg * MTW ..
  const int ks = w % KS;   // key slice: keys ks * KPW .. of each tile

  {  // the packed Q rows (ordinary stores; read after the first barrier)
    const bf16* qb = static_cast<const bf16*>(a.q) +
                     (long long)b * a.T * a.H * D;
    for (int i = threadIdx.x; i < MT * 16 * QCPR; i += kVerThreads) {
      const int r = i / QCPR;
      const int ch = i % QCPR;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < M)
        v = *reinterpret_cast<const uint4*>(
            qb + ((long long)(r / rep) * a.H + g * rep + r % rep) * D +
            ch * 8);
      *reinterpret_cast<uint4*>(ver_smem + r * D * 2 +
                                ((ch ^ swz<QCPR>(r)) * 16)) = v;
    }
  }
#pragma unroll
  for (int st = 0; st < kVerStages - 1; ++st) {  // the ring's prologue
    if (st < n_tiles)
      ver_load<KV, D, MT>(a, base + L::kRing + st * L::kStage, b, g,
                          c_begin + st * kVerBN);
    hop::cp_async_commit();
  }

  // this thread's rows: row tile rg * MTW + mi, rows gq and gq + 8
  int prow[MTW][2], trow[MTW][2];
  unsigned anc[MTW][2];
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = (rg * MTW + mi) * 16 + gq + 8 * i;
      prow[mi][i] = r;
      trow[mi][i] = r < M ? r / rep : 0;
      anc[mi][i] = TREE && r < M ? static_cast<unsigned>(
                                       a.tree_bits[b * a.T + trow[mi][i]])
                                 : 0u;
    }
  const float c = a.scale * kLog2e;
  float acc[MTW][NT][4];
  float m[MTW][2], l[MTW][2];
#pragma unroll
  for (int mi = 0; mi < MTW; ++mi) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[mi][i] = -INFINITY;
      l[mi][i] = 0.f;
    }
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][j][e] = 0.f;
  }

  for (int it = 0; it < n_tiles; ++it) {
    hop::cp_async_wait<kVerStages - 2>();
    __syncthreads();
    const int ahead = it + kVerStages - 1;  // the tile to prefetch
    if (ahead < n_tiles)
      ver_load<KV, D, MT>(
          a, base + L::kRing + (ahead % kVerStages) * L::kStage, b, g,
          c_begin + ahead * kVerBN);
    hop::cp_async_commit();
    const unsigned char* stg =
        ver_smem + L::kRing + (it % kVerStages) * L::kStage;
    const unsigned char* sK = stg;
    const unsigned char* sV = stg + L::kTile;
    const float* kscale = reinterpret_cast<const float*>(stg + 2 * L::kTile);
    const float* vscale = kscale + kVerBN;
    const int c0 = c_begin + it * kVerBN;

#pragma unroll
    for (int kc = 0; kc < KPW / 16; ++kc) {
      const int kb = ks * KPW + kc * 16;  // the 16 keys' first tile row
      // ---- s = q . k^T over the warp's row tiles and 16 keys. n8 tile
      // j, column gq is key kb + 4 (gq / 2) + 2 j + gq % 2; a thread's
      // d's of a k16 step are 4 consecutive columns of one chunk
      float s[MTW][2][4];
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
        for (int j = 0; j < 2; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[mi][j][e] = 0.f;
      int krow[2];
      float ksc[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        krow[j] = kb + 4 * (gq >> 1) + 2 * j + (gq & 1);
        ksc[j] = QUANT ? kscale[krow[j]] : 0.f;
      }
      // a block: 32 columns (bf16: one K chunk, 2 steps) or 64 (int8:
      // one K chunk, 4 steps); the thread's chunk is t of the block's 4
      constexpr int BLK = QUANT ? 64 : 32;
      constexpr int SPB = BLK / 16;
#pragma unroll
      for (int blk = 0; blk < D / BLK; ++blk) {
        uint4 kw[2];
#pragma unroll
        for (int j = 0; j < 2; ++j)
          kw[j] = *reinterpret_cast<const uint4*>(
              sK + krow[j] * L::kRowBytes +
              (((4 * blk + tq) ^ swz<CPR>(krow[j])) * 16));
        // the Q columns blk * BLK + t * BLK / 4 .. of rows gq, gq + 8
        uint4 qw[MTW][2][SPB / 2];
#pragma unroll
        for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
          for (int i = 0; i < 2; ++i)
#pragma unroll
            for (int h = 0; h < SPB / 2; ++h) {
              const int r = prow[mi][i];
              const int ch = (blk * BLK + tq * (BLK / 4)) / 8 + h;
              qw[mi][i][h] = *reinterpret_cast<const uint4*>(
                  ver_smem + r * D * 2 + ((ch ^ swz<QCPR>(r)) * 16));
            }
#pragma unroll
        for (int sp = 0; sp < SPB; ++sp) {
          uint32_t b0[2], b1[2];
#pragma unroll
          for (int j = 0; j < 2; ++j) {
            const uint32_t* kwj = reinterpret_cast<const uint32_t*>(&kw[j]);
            if constexpr (QUANT) {
              const uint32_t x = kwj[sp];
              b0[j] = deq2(i8f(x, 0), ksc[j], i8f(x, 1), ksc[j]);
              b1[j] = deq2(i8f(x, 2), ksc[j], i8f(x, 3), ksc[j]);
            } else {
              b0[j] = kwj[2 * sp];
              b1[j] = kwj[2 * sp + 1];
            }
          }
#pragma unroll
          for (int mi = 0; mi < MTW; ++mi) {
            const uint32_t* q0w =
                reinterpret_cast<const uint32_t*>(&qw[mi][0][sp / 2]);
            const uint32_t* q1w =
                reinterpret_cast<const uint32_t*>(&qw[mi][1][sp / 2]);
            const int o = 2 * (sp % 2);
            const uint32_t af[4] = {q0w[o], q1w[o], q0w[o + 1], q1w[o + 1]};
#pragma unroll
            for (int j = 0; j < 2; ++j)
              ptt::mma_bf16_16816(s[mi][j], af, b0[j], b1[j]);
          }
        }
      }

      // ---- online softmax: element (j, e) is row gq + 8 (e / 2), key
      // kb + 4 t + 2 j + e % 2
      const int cc0 = c0 + kb;
      const bool edge = cc0 < kst || cc0 + 16 > a.W || cc0 + 16 > qoff;
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi) {
        if (edge) {
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              const int i = e >> 1;
              const int col = cc0 + 4 * tq + 2 * j + (e & 1);
              if (!sees<TREE>(col, trow[mi][i], prow[mi][i] < M,
                              anc[mi][i], kst, qoff, a.W))
                s[mi][j][e] = -INFINITY;
            }
        }
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float mx = fmaxf(fmaxf(s[mi][0][2 * i], s[mi][0][2 * i + 1]),
                           fmaxf(s[mi][1][2 * i], s[mi][1][2 * i + 1]));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
          mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
          const float mn = fmaxf(m[mi][i], mx);
          const float mc = mn == -INFINITY ? 0.f : mn * c;
          const float alpha = hop::exp2_approx(m[mi][i] * c - mc);
          float rsum = 0.f;
#pragma unroll
          for (int j = 0; j < 2; ++j)
#pragma unroll
            for (int e = 0; e < 2; ++e) {
              float& x = s[mi][j][2 * i + e];
              x = hop::exp2_approx(fmaf(x, c, -mc));
              rsum += x;
            }
          l[mi][i] = l[mi][i] * alpha + rsum;
          m[mi][i] = mn;
#pragma unroll
          for (int jd = 0; jd < NT; ++jd) {
            acc[mi][jd][2 * i] *= alpha;
            acc[mi][jd][2 * i + 1] *= alpha;
          }
        }
      }

      // ---- acc += p v: k slots 2t, 2t + 1, 2t + 8, 2t + 9 are keys
      // kb + 4t .. + 3 (tile rows vr[0..3]); the n8 tile jd's column gq is
      // d = gq * NT + jd, so a thread reads NT consecutive d of 4 rows
      uint32_t pa[MTW][4];
#pragma unroll
      for (int mi = 0; mi < MTW; ++mi) {
        pa[mi][0] = ptt::pack_bf16(s[mi][0][0], s[mi][0][1]);
        pa[mi][1] = ptt::pack_bf16(s[mi][0][2], s[mi][0][3]);
        pa[mi][2] = ptt::pack_bf16(s[mi][1][0], s[mi][1][1]);
        pa[mi][3] = ptt::pack_bf16(s[mi][1][2], s[mi][1][3]);
      }
      const int vr0 = kb + 4 * tq;
      if constexpr (QUANT) {
        float vsc[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) vsc[r] = vscale[vr0 + r];
        // NT bytes of each row: one chunk (D = 128) or half of one
#pragma unroll
        for (int h = 0; h < NT / 4; ++h) {  // 4 d (one word) at a time
          uint32_t x[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int vr = vr0 + r;
            const int byte = gq * NT + 4 * h;
            x[r] = *reinterpret_cast<const uint32_t*>(
                sV + vr * L::kRowBytes + (((byte / 16) ^ swz<CPR>(vr)) * 16) +
                byte % 16);
          }
#pragma unroll
          for (int k = 0; k < 4; ++k) {
            const uint32_t v0 =
                deq2(i8f(x[0], k), vsc[0], i8f(x[1], k), vsc[1]);
            const uint32_t v1 =
                deq2(i8f(x[2], k), vsc[2], i8f(x[3], k), vsc[3]);
#pragma unroll
            for (int mi = 0; mi < MTW; ++mi)
              ptt::mma_bf16_16816(acc[mi][4 * h + k], pa[mi], v0, v1);
          }
        }
      } else {
        // 2 NT bytes of each row: NT / 4 chunks (D = 128: 2, D = 64: 1)
#pragma unroll
        for (int h = 0; h < NT / 8; ++h) {
          uint4 x[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            const int vr = vr0 + r;
            x[r] = *reinterpret_cast<const uint4*>(
                sV + vr * L::kRowBytes +
                (((gq * (NT / 8) + h) ^ swz<CPR>(vr)) * 16));
          }
          const uint32_t* x0 = reinterpret_cast<const uint32_t*>(&x[0]);
          const uint32_t* x1 = reinterpret_cast<const uint32_t*>(&x[1]);
          const uint32_t* x2 = reinterpret_cast<const uint32_t*>(&x[2]);
          const uint32_t* x3 = reinterpret_cast<const uint32_t*>(&x[3]);
#pragma unroll
          for (int k = 0; k < 4; ++k) {  // d pair 2k, 2k + 1 of the chunk
            const uint32_t lo0 = __byte_perm(x0[k], x1[k], 0x5410);
            const uint32_t hi0 = __byte_perm(x0[k], x1[k], 0x7632);
            const uint32_t lo1 = __byte_perm(x2[k], x3[k], 0x5410);
            const uint32_t hi1 = __byte_perm(x2[k], x3[k], 0x7632);
            const int jd = 8 * h + 2 * k;
#pragma unroll
            for (int mi = 0; mi < MTW; ++mi) {
              ptt::mma_bf16_16816(acc[mi][jd], pa[mi], lo0, lo1);
              ptt::mma_bf16_16816(acc[mi][jd + 1], pa[mi], hi0, hi1);
            }
          }
        }
      }
    }
  }
  hop::cp_async_wait<0>();
  __syncthreads();  // the ring's bytes now hold the partials

  float* part = reinterpret_cast<float*>(ver_smem + L::kRing);
  float* mo = reinterpret_cast<float*>(ver_smem + L::kMerged);
  float* mml = mo + L::kRowsP * D;
  constexpr int RP = L::kRowsP;
  if (n_tiles == 0) {  // a split below kstart: an empty partial
    ksp::empty_partial(mml, M);
  } else {
    // ---- the warp's partial into slice ks, then the CTA's: the slices
    // merged in order
    float* pml = part + (long long)KS * RP * D;
#pragma unroll
    for (int mi = 0; mi < MTW; ++mi)
#pragma unroll
      for (int i = 0; i < 2; ++i)
        ksp::put_partial<D>(part, pml, ks * RP + prow[mi][i], prow[mi][i],
                            tq, acc[mi], i, m[mi][i], l[mi][i]);
    __syncthreads();
    ksp::merge_slices<D, KS, RP>(part, pml, mo, mml, M, c);
  }
  // ---- the splits merged in order, into the (B, T, H, D) output
  bf16* ob = static_cast<bf16*>(a.out);
  ksp::merge_cluster<D>(mo, mml, M, c, [&](int r, int d, float v) {
    ob[(((long long)b * a.T + r / rep) * a.H + g * rep + r % rep) * D + d] =
        ptt::from_f<bf16>(v);
  });
}

// ------------------------------------------------------------ launch
template <typename KV, int D, bool TREE>
cudaError_t launch_f32(const ChunkArgs& a, int B, cudaStream_t stream) {
  const size_t smem = sizeof(float) * ((kF32Rows + kF32Keys) * (D + 1) +
                                       kF32Keys * D +
                                       kF32Rows * (kF32Keys + 1));
  cudaError_t e = cudaFuncSetAttribute(
      flash_chunk_f32_kernel<KV, D, TREE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.T + kF32Rows - 1) / kF32Rows, a.H, B);
  flash_chunk_f32_kernel<KV, D, TREE>
      <<<grid, kF32Threads, smem, stream>>>(a);
  return cudaGetLastError();
}

// The cache (B, W, HK, D) as the TMA tensor (D, HK, W, B): bf16 boxes of
// 64 columns x kPreBN keys, 128-byte swizzled; int8 boxes of D columns x
// kPreBN keys, unswizzled (the producers swizzle as they dequantize).
template <typename KV, int D>
bool cache_map(CUtensorMap* map, const void* ptr, const ChunkArgs& a, int B) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  const unsigned long long esz = QUANT ? 1 : 2;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(a.HK),
                              static_cast<cuuint64_t>(a.W),
                              static_cast<cuuint64_t>(B)};
  const cuuint64_t strides[3] = {esz * a.c_sh, esz * a.c_sw, esz * a.c_sb};
  const cuuint32_t box[4] = {QUANT ? static_cast<cuuint32_t>(D) : 64u, 1,
                             static_cast<cuuint32_t>(kPreBN), 1};
  return hop::tma_map_4d(
      map,
      QUANT ? CU_TENSOR_MAP_DATA_TYPE_UINT8 : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
      ptr, dims, strides, box,
      QUANT ? CU_TENSOR_MAP_SWIZZLE_NONE : CU_TENSOR_MAP_SWIZZLE_128B);
}

template <typename KV, int D, bool TREE>
cudaError_t launch_prefill(const ChunkArgs& a, int B, cudaStream_t stream) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  const int M = a.T * (a.H / a.HK);
  CUtensorMap tk, tv;
  if (!cache_map<KV, D>(&tk, a.ck, a, B) || !cache_map<KV, D>(&tv, a.cv, a, B))
    return cudaErrorInvalidValue;
  const size_t nbytes = PreSmem<D, QUANT>::kBytes + 1024;
  cudaError_t e = cudaFuncSetAttribute(
      flash_chunk_prefill_kernel<KV, D, TREE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(nbytes));
  if (e != cudaSuccess) return e;
  const dim3 grid((M + kPreRows - 1) / kPreRows, a.HK, B);
  flash_chunk_prefill_kernel<KV, D, TREE>
      <<<grid, kPreThreads, nbytes, stream>>>(tk, tv, a);
  return cudaGetLastError();
}

// The verify grid: (splits, HK, B) from the shape alone (keysplit.cuh).
template <typename KV, int D, bool TREE, int MT>
cudaError_t launch_verify_mt(const ChunkArgs& a, int B, cudaStream_t stream) {
  const int nsplit = ksp::split_count((long long)B * a.HK, a.W);
  return ksp::launch(flash_chunk_verify_kernel<KV, D, TREE, MT>, nsplit,
                     a.HK, B, VerSmem<KV, D, MT>::kBytes, stream, a,
                     ksp::split_length(a.W, nsplit));
}

template <typename KV, int D, bool TREE>
cudaError_t launch_verify(const ChunkArgs& a, int B, cudaStream_t stream) {
  const int M = a.T * (a.H / a.HK);
  if (M <= 16) return launch_verify_mt<KV, D, TREE, 1>(a, B, stream);
  if (M <= 32) return launch_verify_mt<KV, D, TREE, 2>(a, B, stream);
  return launch_verify_mt<KV, D, TREE, 4>(a, B, stream);
}

// bf16: the regime from the packed row count M = T * rep alone
template <typename KV, int D, bool TREE>
cudaError_t launch_bf16(const ChunkArgs& a, int B, cudaStream_t stream) {
  const int M = a.T * (a.H / a.HK);
  return M >= kPreRows ? launch_prefill<KV, D, TREE>(a, B, stream)
                       : launch_verify<KV, D, TREE>(a, B, stream);
}

template <typename KV, int D, bool TREE>
cudaError_t launch_typed(const ChunkArgs& a, int B, bool bf,
                         cudaStream_t stream) {
  if (bf) {
    if constexpr (std::is_same<KV, float>::value)
      return launch_bf16<bf16, D, TREE>(a, B, stream);
    else
      return launch_bf16<KV, D, TREE>(a, B, stream);
  }
  return launch_f32<KV, D, TREE>(a, B, stream);
}

template <int D, bool TREE>
cudaError_t launch_kv(const ChunkArgs& a, int B, bool bf, bool kv_int8,
                      cudaStream_t stream) {
  return kv_int8 ? launch_typed<int8_t, D, TREE>(a, B, bf, stream)
                 : launch_typed<float, D, TREE>(a, B, bf, stream);
}

cudaError_t launch_d(const ChunkArgs& a, int B, int D, bool bf, bool kv_int8,
                     cudaStream_t stream) {
  const bool tree = a.tree_bits != nullptr;
  if (D == 128)
    return tree ? launch_kv<128, true>(a, B, bf, kv_int8, stream)
                : launch_kv<128, false>(a, B, bf, kv_int8, stream);
  if (D == 64)
    return tree ? launch_kv<64, true>(a, B, bf, kv_int8, stream)
                : launch_kv<64, false>(a, B, bf, kv_int8, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// q_dtype: 0 = float32, 1 = bfloat16; k_rows/v_rows are read only when
// kv_int8 != 0. tree_bits NULL runs the linear form (B11-linear); else it
// is the (B, T) int32 ancestor bitmasks of the tree form (B11-tree),
// which takes T <= 32.
extern "C" int ptt_flash_chunk(
    const void* q, const void* ck, const void* cv, const void* k_rows,
    const void* v_rows, const void* kstart, const void* tree_bits,
    void* out, int B, int T, int H,
    int HK, int D, int W, long long c_sb, long long c_sw, long long c_sh,
    long long r_sb, long long r_sw, long long r_sh, float scale,
    int q_dtype, int kv_int8, void* stream) {
  if (B <= 0 || B > 65535 || T <= 0 || HK <= 0 || HK > 65535 ||
      H % HK != 0 || W < T || (tree_bits != nullptr && T > 32) ||
      (q_dtype != 0 && q_dtype != 1))
    return cudaErrorInvalidValue;
  ChunkArgs a;
  a.q = q;
  a.ck = ck;
  a.cv = cv;
  a.k_rows = static_cast<const float*>(k_rows);
  a.v_rows = static_cast<const float*>(v_rows);
  a.kstart = static_cast<const int*>(kstart);
  a.tree_bits = static_cast<const int*>(tree_bits);
  a.out = out;
  a.T = T;
  a.H = H;
  a.HK = HK;
  a.W = W;
  a.c_sb = c_sb;
  a.c_sw = c_sw;
  a.c_sh = c_sh;
  a.r_sb = r_sb;
  a.r_sw = r_sw;
  a.r_sh = r_sh;
  a.scale = scale;
  return static_cast<int>(launch_d(a, B, D, q_dtype == 1, kv_int8 != 0,
                                   static_cast<cudaStream_t>(stream)));
}
