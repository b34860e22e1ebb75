// B7 one-token decode attention against a contiguous, padded KV cache:
// the decode steps of dense `generate`, `beam_search` and generation from
// a prompt cache. B8, below, the same over a head-major page pool:
// `incubate`'s `block_multihead_attention`.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/fused.py
// `_decode_kernel` / `_decode_kernel_qrow` (shared step
// `_decode_softmax_step`, wrapper `decode_attention`): each query row of
// q (B, H, D) attends to the first lengths[b] rows of its batch row of a
// (B, S, HK, D) cache, with optional int8 rows and per-row f32 dequant
// scales (B, S, HK).
//
// What bounds it on the H100: bytes. Each live K and V row is read once
// and feeds 4*D flops per query head: about 1 flop per byte in bf16 with
// no GQA, against the ~295 flops/byte at which the tensor cores would
// become the limit. A CTA that walks a whole (row, kv head) alone keeps
// too few loads in flight to stream it at the card's rate, and a few
// long rows leave most SMs idle; the bytes are laid out as in B9's
// token-major pool, so B7 takes B9's design.
//
// What the design does about it: bf16 queries (the card's path) take the
// key-split kernel of paged_split.cuh, shared with B8 and B9/B10, with
// its dense addressing (DENSE): token j of (row b, kv head g) at
// b * kv_sb + g * kv_sh + j * kv_ss, its int8 scale at b * sc_sb +
// j * sc_ss + g * sc_sh, the capacity S; no block table is read and no
// token index is divided by a page size.
// - the token axis is split over a thread block cluster by keysplit.cuh's
//   rule from (B * HK, S): 1 split for 8 rows x 32 kv heads at S = 2048
//   or the JAX bench model's 8 x 12 at 192, 4 for GQA's 8 x 8 at 2048, 8
//   for one row of 4,096, so a long row no longer rests on one CTA;
// - K and V stream through the 3-stage cp.async ring of 64-token tiles
//   (a tile is 64 rows of D elements, HK * D apart: whole 128-byte
//   lines), int8 rows with each token's two scales staged beside them
//   (one 4-byte cp.async a scale, HK floats apart), and q.k and p.v run
//   on mma.sync with the GQA group padded to one 16-row tile;
// - the cache is read in place through its strides (a layer slice of the
//   dense (L, B, S, HK, D) cache is a strided view), where the TPU
//   wrapper transposed the whole cache to (B*HK, S, D) on every call, and
//   only a row's live columns [0, min(lengths[b], S)) are read, where the
//   TPU kernel fetched every block of the padded cache and masked (and
//   zeroed V past the length so NaN there could not leak): here a NaN
//   tail is never read;
// - the lengths are a (B,) int32 device tensor, read by the kernel: the
//   caller never reads one on the host.
// float32 queries (the tests' dtype) keep the plain-FMA body that B8 and
// B9/B10 keep for them (decode_step.cuh): one CTA of 8 warps per (row,
// kv head) serving its GQA group, int8 rows dequantized in registers.
//
// A row with length 0 outputs zeros (the TPU kernel divides by 1 when
// l == 0); the plain composition softmaxes a row of -1e30 scores into
// the mean of V instead. No path of the port decodes with length 0. A
// length larger than S clamps to S, which is what the plain
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
// prefetched it as scalars. bf16 queries (the card's path) take the
// key-split kernel of paged_split.cuh, shared with B9/B10: the token axis
// split over a thread block cluster by the shape, a cp.async ring of
// 64-token tiles, mma.sync products with the GQA group padded to one
// 16-row tile; here with one scale per (row, kv head). float32 queries
// (the tests' dtype) keep the plain-FMA body that B7 shares
// (decode_step.cuh): one CTA of 8 warps per (row, kv head).

#include "decode_step.cuh"
#include "paged_split.cuh"

namespace {

namespace psp = ptt::paged_split;
using ptt::decode::kMaxRep;
using ptt::decode::kWarps;

// Token j of one (batch row, kv head): row j of the row's cache slice.
struct DenseAddr {
  long long kv_ss, kv_off, sc_ss, sc_off;
  __device__ __forceinline__ void at(int j, long long& kv,
                                     long long& sc) const {
    kv = (long long)j * kv_ss + kv_off;
    sc = (long long)j * sc_ss + sc_off;
  }
};

// float32 queries: one CTA of kWarps warps per (kv head, batch row) of
// a dense cache in psp::Args (kv_sp / sc_sp the batch row's strides,
// kv_st / sc_st the token's, page the capacity S).
template <typename KV, int D>
__global__ void __launch_bounds__(kWarps * 32)
    decode_attention_kernel(const psp::Args a) {
  constexpr int DPL = D / 32;  // dims per lane
  const int g = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // batch row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rep = a.H / a.HK;
  const int d0 = lane * DPL;
  int len = a.lengths[b];
  len = len < 0 ? 0 : (len > a.page ? a.page : len);

  const float* qb = static_cast<const float*>(a.q) +
                    ((long long)b * a.H + (long long)g * rep) * D;
  float q[kMaxRep][DPL];
  ptt::decode::load_q<float, D>(qb, rep, d0, q);
  const DenseAddr addr{
      a.kv_st, (long long)b * a.kv_sp + (long long)g * a.kv_sh + d0,
      a.sc_st, (long long)b * a.sc_sp + (long long)g * a.sc_sh};
  float m[kMaxRep], l[kMaxRep], acc[kMaxRep][DPL];
  ptt::decode::attend<float, KV, D>(
      q, rep, len, a.scale, static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.k_scales, a.v_scales, addr, warp, m,
      l, acc);
  float* ob = static_cast<float*>(a.out) +
              ((long long)b * a.H + (long long)g * rep) * D;
  ptt::decode::merge_store<float, D>(m, l, acc, rep, warp, lane, ob);
}

// float32 queries: the plain-FMA body (decode_step.cuh); bf16: the split
// kernel with the dense addressing and per-token scales
template <typename T, typename KV, int D>
cudaError_t launch_typed(const psp::Args& a, int B, int nsplit,
                         cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid(a.HK, B);
    decode_attention_kernel<KV, D>
        <<<grid, kWarps * 32, ptt::decode::merge_smem_bytes<D>(a.H / a.HK),
           stream>>>(a);
    return cudaGetLastError();
  } else {
    return psp::launch<KV, D, true, false, true>(a, B, nsplit, stream);
  }
}

template <typename T>
cudaError_t launch_kv(const psp::Args& a, int B, int D, bool kv_int8,
                      int nsplit, cudaStream_t stream) {
  if (D == 128)
    return kv_int8 ? launch_typed<T, int8_t, 128>(a, B, nsplit, stream)
                   : launch_typed<T, T, 128>(a, B, nsplit, stream);
  if (D == 64)
    return kv_int8 ? launch_typed<T, int8_t, 64>(a, B, nsplit, stream)
                   : launch_typed<T, T, 64>(a, B, nsplit, stream);
  return cudaErrorInvalidValue;
}

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
    paged_decode_hm_kernel(const psp::Args a) {
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

// float32 queries: the plain-FMA body (decode_step.cuh); bf16: the split
template <typename T, typename KV, int D>
cudaError_t launch_hm_typed(const psp::Args& a, int B, int nsplit,
                            cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid(a.HK, B);
    paged_decode_hm_kernel<T, KV, D>
        <<<grid, kWarps * 32, ptt::decode::merge_smem_bytes<D>(a.H / a.HK),
           stream>>>(a);
    return cudaGetLastError();
  } else {
    return psp::launch<KV, D, false, false, false>(a, B, nsplit, stream);
  }
}

template <typename T>
cudaError_t launch_hm_kv(const psp::Args& a, int B, int D,
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

// B7 with `nsplit` key splits for bf16 queries: 0 chooses them from the
// shape, as ptt_decode_attention does; 1, 2, 4 or 8 force them (to time
// the split rule against its alternatives). float32 queries take 0 only.
// q_dtype: 0 = float32, 1 = bfloat16. lengths: (B,) int32 on the device.
// k_scales/v_scales are read only when kv_int8 != 0.
extern "C" int ptt_decode_attention_splits(
    const void* q, const void* k, const void* v, const void* k_scales,
    const void* v_scales, const void* lengths, void* out, int B, int H,
    int HK, int D, int S, long long kv_sb, long long kv_ss,
    long long kv_sh, long long sc_sb, long long sc_ss, long long sc_sh,
    float scale, int q_dtype, int kv_int8, int nsplit, void* stream) {
  if (B <= 0 || HK <= 0 || H % HK != 0 || H / HK > kMaxRep || S <= 0 ||
      lengths == nullptr || !psp::valid_splits(nsplit, q_dtype))
    return cudaErrorInvalidValue;
  psp::Args a = {};  // a dense cache: the batch row is the page of S
  a.q = q;
  a.k = k;
  a.v = v;
  a.k_scales = static_cast<const float*>(k_scales);
  a.v_scales = static_cast<const float*>(v_scales);
  a.lengths = static_cast<const int*>(lengths);
  a.out = out;
  a.H = H;
  a.HK = HK;
  a.page = S;
  a.ppseq = 1;
  a.kv_sp = kv_sb;
  a.kv_sh = kv_sh;
  a.kv_st = kv_ss;
  a.sc_sp = sc_sb;
  a.sc_sh = sc_sh;
  a.sc_st = sc_ss;
  a.scale = scale;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_dtype == 1)
    e = launch_kv<__nv_bfloat16>(a, B, D, kv_int8 != 0, nsplit, s);
  else if (q_dtype == 0)
    e = launch_kv<float>(a, B, D, kv_int8 != 0, 0, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// B7 with the split count chosen from the shape.
extern "C" int ptt_decode_attention(
    const void* q, const void* k, const void* v, const void* k_scales,
    const void* v_scales, const void* lengths, void* out, int B, int H,
    int HK, int D, int S, long long kv_sb, long long kv_ss,
    long long kv_sh, long long sc_sb, long long sc_ss, long long sc_sh,
    float scale, int q_dtype, int kv_int8, void* stream) {
  return ptt_decode_attention_splits(
      q, k, v, k_scales, v_scales, lengths, out, B, H, HK, D, S, kv_sb,
      kv_ss, kv_sh, sc_sb, sc_ss, sc_sh, scale, q_dtype, kv_int8, 0,
      stream);
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
      ppseq <= 0 || !psp::valid_splits(nsplit, q_dtype))
    return cudaErrorInvalidValue;
  psp::Args a = {};
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
