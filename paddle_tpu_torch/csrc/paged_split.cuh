// One-token decode attention for bf16 queries over a KV cache read in
// place: the key-split kernel shared by B7 (decode_attention.cu: a dense,
// padded (B, S, HK, D) cache, a layer of the (L, B, S, HK, D) cache of
// dense `generate`, int8 rows with one scale per token), B8 (the same
// file: a head-major (P, HK, page, D) pool, int8 pages with one dequant
// scale per (row, kv head)) and B9/B10 (paged_decode.cu: a token-major
// (P, page, HK, D) pool, int8 pages with one scale per token; B10
// rotates q by RoPE in the kernel). The pools are read in place through
// three element strides (page, kv head, token in page), so one body
// serves both page layouts; a dense cache (DENSE) is the same three
// strides with the batch row in place of the page and no block table:
// no table is read and no token index is divided by a page size. The
// template flags choose where the scales live (TOKEN_SCALES), whether q
// is rotated (ROPE) and whether the cache is dense (DENSE).
//
// What bounds it on the H100: bytes. Each live K and V row is read once
// and feeds 4 * D flops per query head: about 1 flop per byte in bf16 with
// no GQA, against the ~295 flops/byte at which the tensor cores would
// become the limit.
//
// What the design does about it:
// - the token axis is split across CTAs, flash-decoding style: a CTA is
//   one (split, kv head, row), with 1, 2, 4 or 8 splits of at least 256
//   tokens (rounded to 64) chosen from the shape alone (B, HK and the
//   capacity: the table's ppseq * page, or a dense cache's S) so that the
//   grid holds about two CTAs an SM: 8 rows x 32 kv heads (Llama-2-7B)
//   take 1 split, 8 x 8 (GQA) take 4, a single row x 32 take 8. A split
//   wholly past a row's length loads nothing and leaves an empty partial,
//   so short rows cost next to nothing and the longest row does not rest
//   on one CTA. The splits of
//   one (row, kv head) form a thread block cluster and merge their partial
//   (m, l, acc) in split order through distributed shared memory:
//   deterministic, and no workspace (the C entries have none to offer).
//   The split rule, the cluster launch and the merges are keysplit.cuh's,
//   shared with B11's verify (flash_chunk.cu);
// - K and V stream through a 3-stage cp.async ring of 64-token tiles,
//   16-byte chunks XOR-swizzled in shared memory against bank conflicts,
//   each token's page looked up in the CTA (the block table's -1 entries
//   read page 0, as the TPU kernels clamp them). A head-major page of one
//   kv head is contiguous; in the token-major pool and the dense cache a
//   tile is 64 rows of D elements, HK * D apart (over 64 / page pages in
//   the pool): every row is still whole 128-byte lines. No token at or
//   past the row's length (clamped to the capacity) is read, so NaN
//   there never reaches the output;
// - int8 pages dequantize from shared memory into the bf16 fragments as
//   `round_to<bf16>(float(x) * s)` with an exact byte-permute int8-to-float
//   (mma.cuh). A per-token scale is staged in the ring stage beside its
//   tile (one 4-byte cp.async a scale); q.k's B fragment holds one key a
//   thread per n8 tile, p.v's keys 4t .. 4t + 3 of the warp's slice, each
//   dequantized by its own token's scale. V's scale is not folded into p,
//   which would round differently from the reference;
// - q.k and p.v are mma.sync.m16n8k16 (mma.cuh): the rep <= 8 query rows
//   of a kv head padded to one 16-row tile (the idle rows cost no bytes),
//   4 warps taking 16 tokens of each tile with their own online softmax
//   (exp2, the max in raw q.k units) and merging in warp order;
// - B10's rotation happens as the q rows are staged into shared memory,
//   in f32 with round-to-nearest products and sums (no fma contraction)
//   and the partner half read from q itself: the plain rotation bit for
//   bit, where the TPU kernel took rotate_half(q) as a second input;
// - p is rounded to bf16 before p.v while l sums it unrounded, and a row
//   of length 0 writes zeros, as the TPU kernels do.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include <type_traits>

#include "common.cuh"
#include "hopper.cuh"
#include "keysplit.cuh"
#include "mma.cuh"

namespace ptt {
namespace paged_split {

namespace ksp = ptt::keysplit;
using ksp::swz;

constexpr float kLog2e = 1.4426950408889634f;
static_assert(ksp::kThreads == 2 * ksp::kTile,
              "a thread stages one K or V scale of a tile");

// The arguments of every paged decode body (this kernel and the f32 FMA
// bodies of B8 and B9/B10 beside it). Token j of batch row b and kv head
// h lies at bt[b, j / page] * kv_sp + h * kv_sh + (j % page) * kv_st; in
// a dense cache (B7) at b * kv_sp + h * kv_sh + j * kv_st, where page is
// the capacity S, ppseq 1 and block_tables unused.
struct Args {
  const void* q;           // (B, H, D) model dtype, contiguous
  const float* cos_row;    // (B, D/2) f32, B10 only
  const float* sin_row;    // (B, D/2) f32, B10 only
  const void* k;           // K/V pools, model dtype or int8, strided
  const void* v;
  const float* k_scales;   // f32, int8 pools only
  const float* v_scales;
  const int* block_tables; // (B, ppseq) int32, contiguous
  const int* lengths;      // (B,) int32, current token included
  void* out;               // (B, H, D) model dtype, contiguous
  int H, HK, page, ppseq;
  long long kv_sp, kv_sh, kv_st;  // element strides of the pools
  // element strides of the scales: per (row, kv head) sc_sb and sc_sh;
  // per token sc_sp (the batch row's in a dense cache), sc_sh and sc_st
  long long sc_sb, sc_sp, sc_sh, sc_st;
  float scale;
};

// Shared memory of a split CTA, byte offsets: the query rows (16 rows of
// D bf16, swizzled; rows past rep zero), the ring (kStages x (K, V) tiles
// of kTile tokens, and for per-token int8 scales their 2 x kTile scales);
// after the token loop the ring's bytes hold the warps' partials (4
// slices x 16 rows: D acc, m, l) and then the CTA's merged partial, which
// the cluster reads.
template <typename KV, int D, bool TOKEN_SCALES>
struct Smem {
  static constexpr bool kScaled =
      TOKEN_SCALES && std::is_same<KV, int8_t>::value;
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
  static constexpr int CPR = kRowBytes / 16;
  static constexpr int kTile = ksp::kTile * kRowBytes;
  static constexpr int kStage = 2 * kTile + (kScaled ? 2 * ksp::kTile * 4 : 0);
  static constexpr int kRing = 16 * D * 2;
  static constexpr int kPart = 4 * 16 * (D + 2) * 4;
  static constexpr int kMerged = kRing + kPart;  // CTA partial: o, m, l
  static constexpr int kEnd = kMerged + 16 * (D + 2) * 4;
  static constexpr int kRingEnd = kRing + ksp::kStages * kStage;
  static constexpr int kBytes = kEnd > kRingEnd ? kEnd : kRingEnd;
};

// Tokens [c0, c0 + kTile) of kv head g of batch row b (block table bt;
// a dense cache has none: the row is the page) into ring stage `st`: one
// 16-byte cp.async a chunk of K and one of V from the same address, and
// with per-token int8 scales one 4-byte cp.async a scale; tokens at or
// past c_end are zero-filled and never read. page_shift is log2(page)
// for a power-of-two page, else -1.
template <typename KV, int D, bool TOKEN_SCALES, bool DENSE>
__device__ __forceinline__ void split_load(const Args& a, const int* bt,
                                           int b, int page_shift,
                                           uint32_t st, int g, int c0,
                                           int c_end) {
  using L = Smem<KV, D, TOKEN_SCALES>;
  constexpr int CPR = L::CPR;
  constexpr int EPC = 16 / static_cast<int>(sizeof(KV));
  const KV* kb = static_cast<const KV*>(a.k) + (long long)g * a.kv_sh;
  const KV* vb = static_cast<const KV*>(a.v) + (long long)g * a.kv_sh;
  // token j's (page, row in page): (b, j) in a dense cache, else from
  // the table; a dead token reads (page 0 or b, row 0) with size 0
  auto locate = [&](int j, bool live, int& pg, int& row) {
    if constexpr (DENSE) {
      pg = b;
      row = live ? j : 0;
    } else {
      const int pi = page_shift >= 0 ? j >> page_shift : j / a.page;
      pg = live ? bt[pi] : 0;
      pg = pg < 0 ? 0 : pg;  // a -1 entry reads page 0, as the TPU clamps
      row = live ? j - pi * a.page : 0;
    }
  };
#pragma unroll 4
  for (int i = threadIdx.x; i < ksp::kTile * CPR; i += ksp::kThreads) {
    const int r = i / CPR;
    const int ch = i % CPR;
    const int j = c0 + r;
    const bool live = j < c_end;
    int pg, row;
    locate(j, live, pg, row);
    const long long off =
        (long long)pg * a.kv_sp + (long long)row * a.kv_st + ch * EPC;
    const uint32_t dst = st + r * L::kRowBytes + ((ch ^ swz<CPR>(r)) * 16);
    hop::cp_async16(dst, kb + off, live ? 16 : 0);
    hop::cp_async16(dst + L::kTile, vb + off, live ? 16 : 0);
  }
  if constexpr (L::kScaled) {  // thread i: token i % kTile's K or V scale
    const int r = threadIdx.x % ksp::kTile;
    const int j = c0 + r;
    const bool live = j < c_end;
    int pg, row;
    locate(j, live, pg, row);
    const long long off = (long long)pg * a.sc_sp +
                          (long long)row * a.sc_st +
                          (long long)g * a.sc_sh;
    hop::cp_async4(st + 2 * L::kTile + threadIdx.x * 4,
                   (threadIdx.x < ksp::kTile ? a.k_scales : a.v_scales) + off,
                   live ? 4 : 0);
  }
}

// Chunk ch (dims 8 ch .. 8 ch + 7) of the query row `row`, whose chunk is
// x, rotated by RoPE at the row's position (cos cs, sin sn: D / 2 f32):
// the first half x1 c - x2 s, the second x2 c + x1 s, each product and
// sum rounded to f32 and the result to bf16, as the plain rotation does.
template <int D>
__device__ __forceinline__ uint4 rope_chunk(uint4 x,
                                            const __nv_bfloat16* row, int ch,
                                            const float* cs,
                                            const float* sn) {
  constexpr int half = D / 2;
  const int d0 = ch * 8;
  const bool lo = d0 < half;
  const int j0 = lo ? d0 : d0 - half;
  const uint4 y = *reinterpret_cast<const uint4*>(row + (lo ? d0 + half
                                                            : d0 - half));
  const __nv_bfloat16* xe = reinterpret_cast<const __nv_bfloat16*>(&x);
  const __nv_bfloat16* ye = reinterpret_cast<const __nv_bfloat16*>(&y);
  uint4 o;
  __nv_bfloat16* oe = reinterpret_cast<__nv_bfloat16*>(&o);
#pragma unroll
  for (int e = 0; e < 8; ++e) {
    const float xc = __fmul_rn(__bfloat162float(xe[e]), cs[j0 + e]);
    const float ys = __fmul_rn(__bfloat162float(ye[e]), sn[j0 + e]);
    oe[e] = __float2bfloat16_rn(lo ? __fsub_rn(xc, ys) : __fadd_rn(xc, ys));
  }
  return o;
}

namespace {

// One CTA per (split, kv head, batch row): the rep query rows of kv head
// g, padded to one 16-row mma tile, against tokens [blockIdx.x * split,
// +split) of the row's live [0, len), len clamped to the capacity; the
// splits of a (row, kv head) form a thread block cluster and merge in
// split order.
template <typename KV, int D, bool TOKEN_SCALES, bool ROPE, bool DENSE>
__global__ void __launch_bounds__(ksp::kThreads)
    paged_decode_split_kernel(const Args a, int split) {
  using L = Smem<KV, D, TOKEN_SCALES>;
  using bf16 = __nv_bfloat16;
  constexpr int kBN = ksp::kTile;
  constexpr int kStages = ksp::kStages;
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int CPR = L::CPR;
  constexpr int NT = D / 8;    // n8 tiles of p.v
  constexpr int QCPR = D / 8;  // 16-byte chunks of a query row
  extern __shared__ __align__(128) unsigned char spl_smem[];
  const uint32_t base = hop::smem_u32(spl_smem);

  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = a.H / a.HK;
  const int cap = a.ppseq * a.page;
  int len = a.lengths[b];
  len = len < 0 ? 0 : (len > cap ? cap : len);
  const int s_begin = blockIdx.x * split;
  const int s_end = min(len, s_begin + split);
  // a split wholly past the row's length loads nothing
  const int n_tiles = s_end > s_begin ? (s_end - s_begin + kBN - 1) / kBN : 0;
  const int* bt =
      DENSE ? nullptr : a.block_tables + (long long)b * a.ppseq;
  const int page_shift =
      DENSE || (a.page & (a.page - 1)) != 0 ? -1 : __ffs(a.page) - 1;

  const int w = threadIdx.x / 32;  // key slice: tokens 16 w .. of a tile
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;

  {  // the query rows (ordinary stores; read after the first barrier),
     // rotated first for B10
    const bf16* qb = static_cast<const bf16*>(a.q) +
                     ((long long)b * a.H + (long long)g * rep) * D;
    for (int i = threadIdx.x; i < 16 * QCPR; i += ksp::kThreads) {
      const int r = i / QCPR;
      const int ch = i % QCPR;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rep) {
        const bf16* row = qb + (long long)r * D;
        v = *reinterpret_cast<const uint4*>(row + ch * 8);
        if constexpr (ROPE)
          v = rope_chunk<D>(v, row, ch, a.cos_row + (long long)b * (D / 2),
                            a.sin_row + (long long)b * (D / 2));
      }
      *reinterpret_cast<uint4*>(spl_smem + r * D * 2 +
                                ((ch ^ swz<QCPR>(r)) * 16)) = v;
    }
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {  // the ring's prologue
    if (st < n_tiles)
      split_load<KV, D, TOKEN_SCALES, DENSE>(
          a, bt, b, page_shift, base + L::kRing + st * L::kStage, g,
          s_begin + st * kBN, s_end);
    hop::cp_async_commit();
  }
  // per (row, kv head) scales: the same for every token
  float ksc_row = 0.f, vsc_row = 0.f;
  if constexpr (QUANT && !TOKEN_SCALES) {
    const long long so = (long long)b * a.sc_sb + (long long)g * a.sc_sh;
    ksc_row = a.k_scales[so];
    vsc_row = a.v_scales[so];
  }

  const float c = a.scale * kLog2e;
  float acc[NT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    hop::cp_async_wait<kStages - 2>();
    __syncthreads();
    const int ahead = it + kStages - 1;  // the tile to prefetch
    if (ahead < n_tiles)
      split_load<KV, D, TOKEN_SCALES, DENSE>(
          a, bt, b, page_shift,
          base + L::kRing + (ahead % kStages) * L::kStage, g,
          s_begin + ahead * kBN, s_end);
    hop::cp_async_commit();
    const unsigned char* sK = spl_smem + L::kRing + (it % kStages) * L::kStage;
    const unsigned char* sV = sK + L::kTile;
    const float* kscale = reinterpret_cast<const float*>(sK + 2 * L::kTile);
    const float* vscale = kscale + kBN;
    const int kb = 16 * w;  // the warp's 16 tokens' first tile row

    // ---- s = q . k^T over the 16 rows and 16 tokens. n8 tile j, column
    // gq is token kb + 4 (gq / 2) + 2 j + gq % 2; a thread's d's of a k16
    // step are 4 consecutive columns of one chunk
    float s[2][4];
#pragma unroll
    for (int j = 0; j < 2; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
    int krow[2];
    float ksc[2];
#pragma unroll
    for (int j = 0; j < 2; ++j) {
      krow[j] = kb + 4 * (gq >> 1) + 2 * j + (gq & 1);
      ksc[j] = L::kScaled ? kscale[krow[j]] : ksc_row;
    }
    // a block: 32 columns (bf16: one K chunk, 2 steps) or 64 (int8: one
    // K chunk, 4 steps); the thread's chunk is t of the block's 4
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
      // the query columns blk * BLK + t * BLK / 4 .. of rows gq, gq + 8
      uint4 qw[2][SPB / 2];
#pragma unroll
      for (int i = 0; i < 2; ++i)
#pragma unroll
        for (int hh = 0; hh < SPB / 2; ++hh) {
          const int r = gq + 8 * i;
          const int ch = (blk * BLK + tq * (BLK / 4)) / 8 + hh;
          qw[i][hh] = *reinterpret_cast<const uint4*>(
              spl_smem + r * D * 2 + ((ch ^ swz<QCPR>(r)) * 16));
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
        const uint32_t* q0w = reinterpret_cast<const uint32_t*>(&qw[0][sp / 2]);
        const uint32_t* q1w = reinterpret_cast<const uint32_t*>(&qw[1][sp / 2]);
        const int o = 2 * (sp % 2);
        const uint32_t af[4] = {q0w[o], q1w[o], q0w[o + 1], q1w[o + 1]};
#pragma unroll
        for (int j = 0; j < 2; ++j) mma_bf16_16816(s[j], af, b0[j], b1[j]);
      }
    }

    // ---- online softmax: element (j, e) is row gq + 8 (e / 2), token
    // kb + 4 t + 2 j + e % 2; only the split's last tile has tokens at or
    // past s_end, and they are masked
    const int cc0 = s_begin + it * kBN + kb;
    if (cc0 + 16 > s_end) {
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (cc0 + 4 * tq + 2 * j + (e & 1) >= s_end) s[j][e] = -INFINITY;
    }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      float mx = fmaxf(fmaxf(s[0][2 * i], s[0][2 * i + 1]),
                       fmaxf(s[1][2 * i], s[1][2 * i + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
      const float mn = fmaxf(m[i], mx);
      const float mc = mn == -INFINITY ? 0.f : mn * c;
      const float alpha = hop::exp2_approx(m[i] * c - mc);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 2; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          float& x = s[j][2 * i + e];
          x = hop::exp2_approx(fmaf(x, c, -mc));
          rsum += x;
        }
      l[i] = l[i] * alpha + rsum;
      m[i] = mn;
#pragma unroll
      for (int jd = 0; jd < NT; ++jd) {
        acc[jd][2 * i] *= alpha;
        acc[jd][2 * i + 1] *= alpha;
      }
    }

    // ---- acc += p v (p rounded to bf16, l summed it unrounded): k slots
    // 2t, 2t + 1, 2t + 8, 2t + 9 are tokens kb + 4t .. + 3 (tile rows
    // vr0 ..); the n8 tile jd's column gq is d = gq * NT + jd, so a thread
    // reads NT consecutive d of 4 rows
    uint32_t pa[4];
    pa[0] = pack_bf16(s[0][0], s[0][1]);
    pa[1] = pack_bf16(s[0][2], s[0][3]);
    pa[2] = pack_bf16(s[1][0], s[1][1]);
    pa[3] = pack_bf16(s[1][2], s[1][3]);
    const int vr0 = kb + 4 * tq;
    if constexpr (QUANT) {
      float vsc[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        vsc[r] = L::kScaled ? vscale[vr0 + r] : vsc_row;
      // NT bytes of each row: one chunk (D = 128) or half of one
#pragma unroll
      for (int hh = 0; hh < NT / 4; ++hh) {  // 4 d (one word) at a time
        uint32_t x[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int vr = vr0 + r;
          const int byte = gq * NT + 4 * hh;
          x[r] = *reinterpret_cast<const uint32_t*>(
              sV + vr * L::kRowBytes + (((byte / 16) ^ swz<CPR>(vr)) * 16) +
              byte % 16);
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {
          const uint32_t v0 = deq2(i8f(x[0], k), vsc[0], i8f(x[1], k), vsc[1]);
          const uint32_t v1 = deq2(i8f(x[2], k), vsc[2], i8f(x[3], k), vsc[3]);
          mma_bf16_16816(acc[4 * hh + k], pa, v0, v1);
        }
      }
    } else {
      // 2 NT bytes of each row: NT / 8 chunks (D = 128: 2, D = 64: 1)
#pragma unroll
      for (int hh = 0; hh < NT / 8; ++hh) {
        uint4 x[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int vr = vr0 + r;
          x[r] = *reinterpret_cast<const uint4*>(
              sV + vr * L::kRowBytes +
              (((gq * (NT / 8) + hh) ^ swz<CPR>(vr)) * 16));
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
          const int jd = 8 * hh + 2 * k;
          mma_bf16_16816(acc[jd], pa, lo0, lo1);
          mma_bf16_16816(acc[jd + 1], pa, hi0, hi1);
        }
      }
    }
  }
  hop::cp_async_wait<0>();
  __syncthreads();  // the ring's bytes now hold the partials

  float* part = reinterpret_cast<float*>(spl_smem + L::kRing);
  float* mo = reinterpret_cast<float*>(spl_smem + L::kMerged);
  float* mml = mo + 16 * D;
  if (n_tiles == 0) {  // a split past the row's length: an empty partial
    ksp::empty_partial(mml, rep);
  } else {
    // ---- the warp's partial into slice w, then the CTA's: the slices
    // merged in order
    float* pml = part + 4 * 16 * D;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      ksp::put_partial<D>(part, pml, w * 16 + gq + 8 * i, gq + 8 * i, tq,
                          acc, i, m[i], l[i]);
    __syncthreads();
    ksp::merge_slices<D, 4, 16>(part, pml, mo, mml, rep, c);
  }
  // ---- the splits merged in order; a row of length 0 writes zeros, as
  // the TPU kernels do
  bf16* ob = static_cast<bf16*>(a.out) +
             ((long long)b * a.H + (long long)g * rep) * D;
  ksp::merge_cluster<D>(mo, mml, rep, c, [&](int r, int d, float v) {
    ob[r * D + d] = from_f<bf16>(v);
  });
}

}  // namespace

// The split grid: (splits, HK, B), the split count from the shape alone
// (B, HK and the capacity ppseq * page: the table's, or a dense cache's
// S; keysplit.cuh), or `nsplit` splits where it is given (a power of two
// up to 8).
template <typename KV, int D, bool TOKEN_SCALES, bool ROPE, bool DENSE>
cudaError_t launch(const Args& a, int B, int nsplit, cudaStream_t stream) {
  const int cap = a.ppseq * a.page;
  if (nsplit == 0) nsplit = ksp::split_count((long long)B * a.HK, cap);
  return ksp::launch(
      paged_decode_split_kernel<KV, D, TOKEN_SCALES, ROPE, DENSE>, nsplit,
      a.HK, B, Smem<KV, D, TOKEN_SCALES>::kBytes, stream, a,
      ksp::split_length(cap, nsplit));
}

// Whether `nsplit` is a split count the C entries take: 0 (the shape's
// choice) or a power of two up to kMaxSplits, and a forced count only for
// bf16 queries (q_dtype 1).
inline bool valid_splits(int nsplit, int q_dtype) {
  return nsplit >= 0 && nsplit <= ksp::kMaxSplits &&
         (nsplit & (nsplit - 1)) == 0 && (nsplit == 0 || q_dtype == 1);
}

}  // namespace paged_split
}  // namespace ptt
