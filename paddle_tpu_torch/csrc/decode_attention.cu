// B7 one-token decode attention against a contiguous, padded KV cache:
// dense `generate` and `beam_search` decode steps. B8, below, the same
// over a head-major page pool: `incubate`'s `block_multihead_attention`.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/fused.py
// `_decode_kernel` / `_decode_kernel_qrow` (shared step
// `_decode_softmax_step`, wrapper `decode_attention`): each query row of
// q (B, H, D) attends to the first cache_len[b] rows of its batch row of
// a (B, S, HK, D) cache, with optional int8 rows and per-row f32 dequant
// scales (B, S, HK).
//
// What bounds it on the H100: bytes. Each live K and V row is read once
// and feeds 4*D flops per query head: about 1 flop per byte in bf16 with
// no GQA, against the ~295 flops/byte at which the tensor cores would
// become the limit.
//
// What the design does about it:
// - one CTA per (batch row, kv head) serves the whole GQA group of
//   rep = H/HK query heads, so each K/V row is read from HBM once for all
//   of them, with no repeated copy of the cache (the TPU kernel's one
//   grid row per kv-head group);
// - the CTA walks only the row's live columns [0, cache_len[b]) and
//   reads nothing at or past cache_len[b], where the TPU kernel fetched
//   every block of the padded cache and masked (and zeroed V past the
//   length so NaNs there could not leak): here a NaN tail is never read;
// - the cache is read in place through its strides (a layer slice of the
//   dense (L, B, S, HK, D) cache is a strided view), where the TPU
//   wrapper transposed the whole cache to (B*HK, S, D) on every call;
// - int8 rows dequantize in registers, so HBM traffic stays 1 byte an
//   element; 8 warps keep 4 tokens' K and V loads each in flight, and
//   the online softmax lives in registers (decode_step.cuh, the core
//   shared with B9/B10).
// One CTA per (row, kv head) gives B*HK CTAs: 256 at the Llama-2-7B
// decode shape (B = 8, HK = 32), 96 on 132 SMs at the JAX bench model's
// (HK = 12); B7 keeps that design (a split of the sequence, as B8 below
// has, is later work for B7, B9 and B10).
//
// A row with cache_len 0 outputs zeros (the TPU kernel divides by 1 when
// l == 0); the plain composition softmaxes a row of -1e30 scores into
// the mean of V instead. No path of the port decodes with length 0.
// cache_len larger than S clamps to S, which is what the plain
// composition's mask does.

// B8 replaces paddle_tpu/ops/pallas/fused.py `_paged_decode_kernel` /
// `_paged_decode_kernel_q` (op `paged_decode_attention`, shared step
// `_decode_softmax_step`): q (B, H, D) against a head-major (P, HK,
// page, D) pool through (B, ppseq) block tables, the Paddle
// block-attention cache layout. Token j of batch row b and kv head h
// sits at ((bt[b, j / page] * HK + h) * page + j % page) * D; a -1 table
// entry reads page 0, as the TPU kernel clamps it. int8 pages carry one
// f32 dequant scale per (row, kv head): (HK,) or (B, HK) scales, read
// with stride 0 over the tokens, where B7 and B9 have one per token
// row. Bound by bytes, as B7. The pool is read in place through its
// strides (the TPU wrapper transposed the whole pool to (HK, P, page, D)
// on every call), only the live tokens [0, cache_len[b]) are read (the
// TPU kernel fetched every page of the table and masked, zeroing V past
// the length), and each CTA reads its own block-table row where the TPU
// prefetched it as scalars. bf16 queries (the card's path):
// - the token axis is split across CTAs, flash-decoding style: a CTA is
//   one (split, kv head, row), with 1, 2, 4 or 8 splits of at least 256
//   tokens (rounded to 64) chosen from the shape alone (B, HK and the
//   table's capacity ppseq * page) so that the grid holds about two
//   CTAs an SM: 8 rows x 32 kv heads (Llama-2-7B) take 1 split, 8 x 8
//   (GQA) take 4, a single row x 32 take 8. A split wholly past a row's
//   length loads nothing and leaves an empty partial, so short rows cost
//   next to nothing and the longest row no longer rests on one CTA. The
//   splits of one (row, kv head) form a thread block cluster and merge
//   their partial (m, l, acc) in split order through distributed shared
//   memory: deterministic, and no workspace (the C entry has none to
//   offer). The split rule, the cluster launch and the merges are
//   keysplit.cuh's, shared with B11's verify (flash_chunk.cu);
// - the head-major layout makes a page of one kv head contiguous (64
//   tokens x D, 16 KB in bf16): K and V stream through a 3-stage cp.async
//   ring of 64-token tiles, 16-byte chunks XOR-swizzled in shared memory
//   against bank conflicts, each token's page looked up in the CTA; no
//   token at or past the row's length is read, so NaN there never
//   reaches the output;
// - q.k and p.v are mma.sync.m16n8k16 (mma.cuh): the rep <= 8 query rows
//   of a kv head padded to one 16-row tile (the idle rows cost no bytes),
//   4 warps taking 16 tokens of each tile with their own online softmax
//   (exp2, the max in raw q.k units) and merging in warp order; no
//   per-token shuffle reduction. int8 pages dequantize from shared memory
//   into the bf16 fragments as `round_to<bf16>(float(k) * s)`, with an
//   exact byte-permute int8-to-float;
// - p is rounded to bf16 before p.v while l sums it unrounded, and a row
//   of length 0 writes zeros, as the TPU kernel does.
// float32 queries (the tests' dtype) keep the plain-FMA body that B7
// shares (decode_step.cuh): one CTA of 8 warps per (row, kv head).

#include "decode_step.cuh"
#include "hopper.cuh"
#include "keysplit.cuh"
#include "mma.cuh"

namespace {

namespace ksp = ptt::keysplit;
using ptt::deq2;
using ptt::i8f;
using ptt::keysplit::swz;
using ptt::decode::kMaxRep;
using ptt::decode::kWarps;

struct Args {
  const void* q;          // (B, H, D) model dtype, contiguous
  const void* k;          // (B, S, HK, D) model dtype or int8, strided
  const void* v;
  const float* k_scales;  // (B, S, HK) f32, int8 caches only, strided
  const float* v_scales;
  const int* lengths;     // (B,) int32, or NULL: every row has len_all
  int len_all;
  void* out;              // (B, H, D) model dtype, contiguous
  int H, HK, S;
  long long kv_sb, kv_ss, kv_sh;  // element strides of the caches
  long long sc_sb, sc_ss, sc_sh;  // element strides of the scales
  float scale;
};

// Token j of one (batch row, kv head): row j of the row's cache slice.
struct DenseAddr {
  long long kv_ss, kv_off, sc_ss, sc_off;
  __device__ __forceinline__ void at(int j, long long& kv,
                                     long long& sc) const {
    kv = (long long)j * kv_ss + kv_off;
    sc = (long long)j * sc_ss + sc_off;
  }
};

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kWarps * 32)
    decode_attention_kernel(const Args a) {
  constexpr int DPL = D / 32;  // dims per lane
  const int g = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // batch row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rep = a.H / a.HK;
  const int d0 = lane * DPL;
  int len = a.lengths != nullptr ? a.lengths[b] : a.len_all;
  len = len < 0 ? 0 : (len > a.S ? a.S : len);

  const T* qb = static_cast<const T*>(a.q) +
                ((long long)b * a.H + (long long)g * rep) * D;
  float q[kMaxRep][DPL];
  ptt::decode::load_q<T, D>(qb, rep, d0, q);
  const DenseAddr addr{
      a.kv_ss, (long long)b * a.kv_sb + (long long)g * a.kv_sh + d0,
      a.sc_ss, (long long)b * a.sc_sb + (long long)g * a.sc_sh};
  float m[kMaxRep], l[kMaxRep], acc[kMaxRep][DPL];
  ptt::decode::attend<T, KV, D>(
      q, rep, len, a.scale, static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.k_scales, a.v_scales, addr, warp, m,
      l, acc);
  T* ob = static_cast<T*>(a.out) +
          ((long long)b * a.H + (long long)g * rep) * D;
  ptt::decode::merge_store<T, D>(m, l, acc, rep, warp, lane, ob);
}

template <typename T, typename KV, int D>
cudaError_t launch_typed(const Args& a, int B, cudaStream_t stream) {
  const dim3 grid(a.HK, B);
  decode_attention_kernel<T, KV, D>
      <<<grid, kWarps * 32, ptt::decode::merge_smem_bytes<D>(a.H / a.HK),
         stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_kv(const Args& a, int B, int D, bool kv_int8,
                      cudaStream_t stream) {
  if (D == 128)
    return kv_int8 ? launch_typed<T, int8_t, 128>(a, B, stream)
                   : launch_typed<T, T, 128>(a, B, stream);
  if (D == 64)
    return kv_int8 ? launch_typed<T, int8_t, 64>(a, B, stream)
                   : launch_typed<T, T, 64>(a, B, stream);
  return cudaErrorInvalidValue;
}

struct HeadMajorArgs {
  const void* q;           // (B, H, D) model dtype, contiguous
  const void* k;           // (P, HK, page, D) model dtype or int8
  const void* v;
  const float* k_scales;   // (HK,) or (B, HK) f32, int8 pools only
  const float* v_scales;
  const int* block_tables; // (B, ppseq) int32, contiguous
  const int* lengths;      // (B,) int32, current token included
  void* out;               // (B, H, D) model dtype, contiguous
  int H, HK, page, ppseq;
  long long kv_sp, kv_sh, kv_st;  // element strides of the pools
  long long sc_sb, sc_sh;         // element strides of the scales
  float scale;
};

// Token j of one (batch row, kv head) of a head-major pool: its page
// from the block table (-1 entries clamp to page 0), then the row inside
// the page; the scale is the (row, kv head)'s for every token.
struct HeadMajorPagedAddr {
  const int* bt;
  int page;
  long long kv_sp, kv_st, kv_off, sc_off;
  __device__ __forceinline__ void at(int j, long long& kv,
                                     long long& sc) const {
    int pg = bt[j / page];
    pg = pg < 0 ? 0 : pg;
    kv = (long long)pg * kv_sp + (long long)(j % page) * kv_st + kv_off;
    sc = sc_off;
  }
};

template <typename T, typename KV, int D>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_hm_kernel(const HeadMajorArgs a) {
  constexpr int DPL = D / 32;  // dims per lane
  const int g = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // batch row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rep = a.H / a.HK;
  const int d0 = lane * DPL;
  const int cap = a.ppseq * a.page;
  int len = a.lengths[b];
  len = len < 0 ? 0 : (len > cap ? cap : len);

  const T* qb = static_cast<const T*>(a.q) +
                ((long long)b * a.H + (long long)g * rep) * D;
  float q[kMaxRep][DPL];
  ptt::decode::load_q<T, D>(qb, rep, d0, q);
  const HeadMajorPagedAddr addr{
      a.block_tables + (long long)b * a.ppseq, a.page, a.kv_sp, a.kv_st,
      (long long)g * a.kv_sh + d0,
      (long long)b * a.sc_sb + (long long)g * a.sc_sh};
  float m[kMaxRep], l[kMaxRep], acc[kMaxRep][DPL];
  ptt::decode::attend<T, KV, D>(
      q, rep, len, a.scale, static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.k_scales, a.v_scales, addr, warp, m,
      l, acc);
  T* ob = static_cast<T*>(a.out) +
          ((long long)b * a.H + (long long)g * rep) * D;
  ptt::decode::merge_store<T, D>(m, l, acc, rep, warp, lane, ob);
}

// ------------------------------------------ B8 in bf16: split key axis
constexpr int kSplBN = ksp::kTile;          // tokens of a ring tile
constexpr int kSplStages = ksp::kStages;    // cp.async ring depth
constexpr int kSplThreads = ksp::kThreads;  // four warps, 16 tokens each
constexpr float kLog2e = 1.4426950408889634f;

// Shared memory of a split CTA, byte offsets: the query rows (16 rows of
// D bf16, swizzled; rows past rep zero), the ring (kSplStages x (K, V)
// tiles of kSplBN tokens); after the token loop the ring's bytes hold the
// warps' partials (4 slices x 16 rows: D acc, m, l) and then the CTA's
// merged partial, which the cluster reads.
template <typename KV, int D>
struct SplitSmem {
  static constexpr int kRowBytes = D * static_cast<int>(sizeof(KV));
  static constexpr int CPR = kRowBytes / 16;
  static constexpr int kTile = kSplBN * kRowBytes;
  static constexpr int kStage = 2 * kTile;
  static constexpr int kRing = 16 * D * 2;
  static constexpr int kPart = 4 * 16 * (D + 2) * 4;
  static constexpr int kMerged = kRing + kPart;  // CTA partial: o, m, l
  static constexpr int kEnd = kMerged + 16 * (D + 2) * 4;
  static constexpr int kRingEnd = kRing + kSplStages * kStage;
  static constexpr int kBytes = kEnd > kRingEnd ? kEnd : kRingEnd;
};

// Tokens [c0, c0 + kSplBN) of kv head g of one row (block table bt) into
// ring stage `st`: one 16-byte cp.async a chunk of K and one of V from
// the same address; tokens at or past c_end are zero-filled and never
// read. page_shift is log2(page) for a power-of-two page, else -1.
template <typename KV, int D>
__device__ __forceinline__ void split_load(const HeadMajorArgs& a,
                                           const int* bt, int page_shift,
                                           uint32_t st, int g, int c0,
                                           int c_end) {
  using L = SplitSmem<KV, D>;
  constexpr int CPR = L::CPR;
  constexpr int EPC = 16 / static_cast<int>(sizeof(KV));
  const KV* kb = static_cast<const KV*>(a.k) + (long long)g * a.kv_sh;
  const KV* vb = static_cast<const KV*>(a.v) + (long long)g * a.kv_sh;
#pragma unroll 4
  for (int i = threadIdx.x; i < kSplBN * CPR; i += kSplThreads) {
    const int r = i / CPR;
    const int ch = i % CPR;
    const int j = c0 + r;
    const bool live = j < c_end;
    const int pi = page_shift >= 0 ? j >> page_shift : j / a.page;
    int pg = live ? bt[pi] : 0;
    pg = pg < 0 ? 0 : pg;  // a -1 entry reads page 0, as the TPU clamps
    const long long off =
        (long long)pg * a.kv_sp +
        (long long)(live ? j - pi * a.page : 0) * a.kv_st + ch * EPC;
    const uint32_t dst = st + r * L::kRowBytes + ((ch ^ swz<CPR>(r)) * 16);
    hop::cp_async16(dst, kb + off, live ? 16 : 0);
    hop::cp_async16(dst + L::kTile, vb + off, live ? 16 : 0);
  }
}

// One CTA per (split, kv head, batch row): the rep query rows of kv head
// g, padded to one 16-row mma tile, against tokens [blockIdx.x * split,
// +split) of the row's live [0, len); the splits of a (row, kv head) form
// a thread block cluster and merge in split order.
template <typename KV, int D>
__global__ void __launch_bounds__(kSplThreads)
    paged_decode_split_kernel(const HeadMajorArgs a, int split) {
  using L = SplitSmem<KV, D>;
  using bf16 = __nv_bfloat16;
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
  const int n_tiles =
      s_end > s_begin ? (s_end - s_begin + kSplBN - 1) / kSplBN : 0;
  const int* bt = a.block_tables + (long long)b * a.ppseq;
  const int page_shift =
      (a.page & (a.page - 1)) == 0 ? __ffs(a.page) - 1 : -1;

  const int w = threadIdx.x / 32;  // key slice: tokens 16 w .. of a tile
  const int lane = threadIdx.x % 32;
  const int gq = lane / 4;
  const int tq = lane % 4;

  {  // the query rows (ordinary stores; read after the first barrier)
    const bf16* qb = static_cast<const bf16*>(a.q) +
                     ((long long)b * a.H + (long long)g * rep) * D;
    for (int i = threadIdx.x; i < 16 * QCPR; i += kSplThreads) {
      const int r = i / QCPR;
      const int ch = i % QCPR;
      uint4 v = make_uint4(0u, 0u, 0u, 0u);
      if (r < rep)
        v = *reinterpret_cast<const uint4*>(qb + (long long)r * D + ch * 8);
      *reinterpret_cast<uint4*>(spl_smem + r * D * 2 +
                                ((ch ^ swz<QCPR>(r)) * 16)) = v;
    }
  }
#pragma unroll
  for (int st = 0; st < kSplStages - 1; ++st) {  // the ring's prologue
    if (st < n_tiles)
      split_load<KV, D>(a, bt, page_shift, base + L::kRing + st * L::kStage,
                        g, s_begin + st * kSplBN, s_end);
    hop::cp_async_commit();
  }
  // the (row, kv head)'s dequant scales, the same for every token
  const long long so = (long long)b * a.sc_sb + (long long)g * a.sc_sh;
  const float ksc = QUANT ? a.k_scales[so] : 0.f;
  const float vsc = QUANT ? a.v_scales[so] : 0.f;

  const float c = a.scale * kLog2e;
  float acc[NT][4];
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    hop::cp_async_wait<kSplStages - 2>();
    __syncthreads();
    const int ahead = it + kSplStages - 1;  // the tile to prefetch
    if (ahead < n_tiles)
      split_load<KV, D>(a, bt, page_shift,
                        base + L::kRing + (ahead % kSplStages) * L::kStage, g,
                        s_begin + ahead * kSplBN, s_end);
    hop::cp_async_commit();
    const unsigned char* sK =
        spl_smem + L::kRing + (it % kSplStages) * L::kStage;
    const unsigned char* sV = sK + L::kTile;
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
#pragma unroll
    for (int j = 0; j < 2; ++j) krow[j] = kb + 4 * (gq >> 1) + 2 * j + (gq & 1);
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
            b0[j] = deq2(i8f(x, 0), ksc, i8f(x, 1), ksc);
            b1[j] = deq2(i8f(x, 2), ksc, i8f(x, 3), ksc);
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
        for (int j = 0; j < 2; ++j) ptt::mma_bf16_16816(s[j], af, b0[j], b1[j]);
      }
    }

    // ---- online softmax: element (j, e) is row gq + 8 (e / 2), token
    // kb + 4 t + 2 j + e % 2; only the split's last tile has tokens at or
    // past s_end, and they are masked
    const int cc0 = s_begin + it * kSplBN + kb;
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
    pa[0] = ptt::pack_bf16(s[0][0], s[0][1]);
    pa[1] = ptt::pack_bf16(s[0][2], s[0][3]);
    pa[2] = ptt::pack_bf16(s[1][0], s[1][1]);
    pa[3] = ptt::pack_bf16(s[1][2], s[1][3]);
    const int vr0 = kb + 4 * tq;
    if constexpr (QUANT) {
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
          const uint32_t v0 = deq2(i8f(x[0], k), vsc, i8f(x[1], k), vsc);
          const uint32_t v1 = deq2(i8f(x[2], k), vsc, i8f(x[3], k), vsc);
          ptt::mma_bf16_16816(acc[4 * hh + k], pa, v0, v1);
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
          ptt::mma_bf16_16816(acc[jd], pa, lo0, lo1);
          ptt::mma_bf16_16816(acc[jd + 1], pa, hi0, hi1);
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
  // the TPU kernel does
  bf16* ob = static_cast<bf16*>(a.out) +
             ((long long)b * a.H + (long long)g * rep) * D;
  ksp::merge_cluster<D>(mo, mml, rep, c, [&](int r, int d, float v) {
    ob[r * D + d] = ptt::from_f<bf16>(v);
  });
}

// The split grid: (splits, HK, B), the split count from the shape alone
// (B, HK and the table's capacity ppseq * page; keysplit.cuh), or
// `nsplit` splits where it is given (a power of two up to 8).
template <typename KV, int D>
cudaError_t launch_split(const HeadMajorArgs& a, int B, int nsplit,
                         cudaStream_t stream) {
  const int cap = a.ppseq * a.page;
  if (nsplit == 0) nsplit = ksp::split_count((long long)B * a.HK, cap);
  return ksp::launch(paged_decode_split_kernel<KV, D>, nsplit, a.HK, B,
                     SplitSmem<KV, D>::kBytes, stream, a,
                     ksp::split_length(cap, nsplit));
}

// float32 queries: the plain-FMA body (decode_step.cuh); bf16: the split
template <typename T, typename KV, int D>
cudaError_t launch_hm_typed(const HeadMajorArgs& a, int B, int nsplit,
                            cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid(a.HK, B);
    paged_decode_hm_kernel<T, KV, D>
        <<<grid, kWarps * 32, ptt::decode::merge_smem_bytes<D>(a.H / a.HK),
           stream>>>(a);
    return cudaGetLastError();
  } else {
    return launch_split<KV, D>(a, B, nsplit, stream);
  }
}

template <typename T>
cudaError_t launch_hm_kv(const HeadMajorArgs& a, int B, int D,
                         bool kv_int8, int nsplit, cudaStream_t stream) {
  if (D == 128)
    return kv_int8 ? launch_hm_typed<T, int8_t, 128>(a, B, nsplit, stream)
                   : launch_hm_typed<T, T, 128>(a, B, nsplit, stream);
  if (D == 64)
    return kv_int8 ? launch_hm_typed<T, int8_t, 64>(a, B, nsplit, stream)
                   : launch_hm_typed<T, T, 64>(a, B, nsplit, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// q_dtype: 0 = float32, 1 = bfloat16. lengths == NULL gives every row
// len_all live columns. k_scales/v_scales are read only when
// kv_int8 != 0.
extern "C" int ptt_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scales,
    const void* v_scales, const void* lengths, int len_all, void* out,
    int B, int H, int HK, int D, int S, long long kv_sb, long long kv_ss,
    long long kv_sh, long long sc_sb, long long sc_ss, long long sc_sh,
    float scale, int q_dtype, int kv_int8, void* stream) {
  if (B <= 0 || HK <= 0 || H % HK != 0 || H / HK > kMaxRep || S <= 0)
    return cudaErrorInvalidValue;
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  a.lengths = static_cast<const int*>(lengths);
  a.len_all = len_all;
  a.out = out;
  a.H = H;
  a.HK = HK;
  a.S = S;
  a.kv_sb = kv_sb;
  a.kv_ss = kv_ss;
  a.kv_sh = kv_sh;
  a.sc_sb = sc_sb;
  a.sc_ss = sc_ss;
  a.sc_sh = sc_sh;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_dtype == 1)
    e = launch_kv<__nv_bfloat16>(a, B, D, kv_int8 != 0, s);
  else if (q_dtype == 0)
    e = launch_kv<float>(a, B, D, kv_int8 != 0, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// B8 with `nsplit` key splits for bf16 queries: 0 chooses them from the
// shape, as ptt_paged_decode_hm does; 1, 2, 4 or 8 force them (to time
// the split rule against its alternatives). float32 queries take 0 only.
extern "C" int ptt_paged_decode_hm_splits(
    const void* q, const void* k, const void* v, const void* k_scales,
    const void* v_scales, const void* block_tables, const void* lengths,
    void* out, int B, int H, int HK, int D, int page, int ppseq,
    long long kv_sp, long long kv_sh, long long kv_st, long long sc_sb,
    long long sc_sh, float scale, int q_dtype, int kv_int8, int nsplit,
    void* stream) {
  if (B <= 0 || HK <= 0 || H % HK != 0 || H / HK > kMaxRep || page <= 0 ||
      ppseq <= 0 || nsplit < 0 || nsplit > ksp::kMaxSplits ||
      (nsplit & (nsplit - 1)) != 0 || (nsplit != 0 && q_dtype != 1))
    return cudaErrorInvalidValue;
  HeadMajorArgs a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  a.block_tables = static_cast<const int*>(block_tables);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.H = H;
  a.HK = HK;
  a.page = page;
  a.ppseq = ppseq;
  a.kv_sp = kv_sp;
  a.kv_sh = kv_sh;
  a.kv_st = kv_st;
  a.sc_sb = sc_sb;
  a.sc_sh = sc_sh;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_dtype == 1)
    e = launch_hm_kv<__nv_bfloat16>(a, B, D, kv_int8 != 0, nsplit, s);
  else if (q_dtype == 0)
    e = launch_hm_kv<float>(a, B, D, kv_int8 != 0, 0, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// B8. q_dtype: 0 = float32, 1 = bfloat16. k_scales/v_scales are read
// only when kv_int8 != 0: element (b * sc_sb + h * sc_sh) is row b's
// scale for kv head h (sc_sb = 0 for (HK,) scales).
extern "C" int ptt_paged_decode_hm(
    const void* q, const void* k, const void* v, const void* k_scales,
    const void* v_scales, const void* block_tables, const void* lengths,
    void* out, int B, int H, int HK, int D, int page, int ppseq,
    long long kv_sp, long long kv_sh, long long kv_st, long long sc_sb,
    long long sc_sh, float scale, int q_dtype, int kv_int8, void* stream) {
  return ptt_paged_decode_hm_splits(
      q, k, v, k_scales, v_scales, block_tables, lengths, out, B, H, HK, D,
      page, ppseq, kv_sp, kv_sh, kv_st, sc_sb, sc_sh, scale, q_dtype,
      kv_int8, 0, stream);
}
