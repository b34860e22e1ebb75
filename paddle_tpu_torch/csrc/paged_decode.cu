// B9 ragged paged decode attention and B10 the same with q's RoPE
// applied in the kernel.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/paged_attention.py
// `_paged_kernel` / `_paged_kernel_rowq` (wrapper
// `paged_attention_kernel`) and paddle_tpu/ops/pallas/serving_fused.py
// `_fused_paged_kernel` / `_fused_paged_kernel_rowq` (wrapper
// `fused_paged_decode_kernel`): each query row of q (B, H, D) attends to
// the first lengths[b] tokens of its request in a token-major (P, page,
// HK, D) pool through its (B, ppseq) block table, int8 pages with one f32
// dequant scale per token (P, page, HK); B10 first rotates q by the
// row's (B, D/2) cos/sin rows.
//
// What bounds it on the H100: bytes. One decode query row per (batch
// row, head) reads every live K and V row of its request once and does
// 4*D flops per head per token: about 1 flop per byte in bf16, against
// the ~295 flops/byte at which the tensor cores would become the limit.
//
// What the design does about it, beside the split kernel's own note:
// - the pool is read in its native (P, page, HK, D) layout through its
//   strides (a layer slice of the engine's (L, P, page, HK, D) pool is a
//   strided view), where the TPU wrapper transposed the whole pool to
//   (HK, P, page, D) on every call; each CTA loads its own block-table
//   row, which is what the TPU's scalar prefetch carried;
// - only the row's live tokens are read: the ragged early-out of the TPU
//   grid, with nothing read past len, so NaN there never reaches the
//   output.
// bf16 queries (the card's path) take the key-split kernel of
// paged_split.cuh, shared with B8: the token axis split over a thread
// block cluster by the shape, a cp.async ring of 64-token tiles with each
// token's int8 scales staged beside it, mma.sync products with the GQA
// group padded to one 16-row tile, and for B10 the rotation done as q is
// staged into shared memory. float32 queries (the tests' dtype) keep the
// plain-FMA body of decode_step.cuh (one CTA of 8 warps per (row, kv
// head)), which rotates q in f32 the same way, with the partner half
// loaded from q itself where the TPU kernel needed rotate_half(q) as a
// second input.

#include "decode_step.cuh"
#include "paged_split.cuh"

namespace {

namespace psp = ptt::paged_split;
using ptt::decode::kMaxRep;
using ptt::decode::kWarps;

// Token j of one (batch row, kv head): its page from the block table
// (-1 entries clamp to page 0), then the row inside the page.
struct PagedAddr {
  const int* bt;
  int page;
  long long kv_sp, kv_st, kv_off, sc_sp, sc_st, sc_off;
  __device__ __forceinline__ void at(int j, long long& kv,
                                     long long& sc) const {
    int pg = bt[j / page];
    pg = pg < 0 ? 0 : pg;
    const int row = j % page;
    kv = (long long)pg * kv_sp + (long long)row * kv_st + kv_off;
    sc = (long long)pg * sc_sp + (long long)row * sc_st + sc_off;
  }
};

// float32 queries: one CTA of kWarps warps per (kv head, batch row).
template <typename KV, int D, bool ROPE>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const psp::Args a) {
  constexpr int DPL = D / 32;  // dims per lane
  const int g = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // batch row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rep = a.H / a.HK;
  const int len = a.lengths[b];
  const int d0 = lane * DPL;

  // this group's query rows (after the in-kernel RoPE for B10)
  const float* qb = static_cast<const float*>(a.q) +
                    ((long long)b * a.H + (long long)g * rep) * D;
  float q[kMaxRep][DPL];
  ptt::decode::load_q<float, D>(qb, rep, d0, q);
  if (ROPE) {
    constexpr int half = D / 2;
    const bool lo = d0 < half;
    const int j0 = lo ? d0 : d0 - half;
    const float* c = a.cos_row + (long long)b * half + j0;
    const float* s = a.sin_row + (long long)b * half + j0;
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= rep) break;
      float y[DPL];
      ptt::load_vec<float, DPL>(qb + r * D + (lo ? d0 + half : d0 - half),
                                y);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        // first half: x1*c - x2*s; second half: x2*c + x1*s
        const float xc = __fmul_rn(q[r][i], c[i]);
        const float ys = __fmul_rn(y[i], s[i]);
        q[r][i] = lo ? __fsub_rn(xc, ys) : __fadd_rn(xc, ys);
      }
    }
  }

  const PagedAddr addr{a.block_tables + (long long)b * a.ppseq, a.page,
                       a.kv_sp, a.kv_st, (long long)g * a.kv_sh + d0,
                       a.sc_sp, a.sc_st, (long long)g * a.sc_sh};
  float m[kMaxRep], l[kMaxRep], acc[kMaxRep][DPL];
  ptt::decode::attend<float, KV, D>(
      q, rep, len, a.scale, static_cast<const KV*>(a.k),
      static_cast<const KV*>(a.v), a.k_scales, a.v_scales, addr, warp, m,
      l, acc);
  float* ob = static_cast<float*>(a.out) +
              ((long long)b * a.H + (long long)g * rep) * D;
  ptt::decode::merge_store<float, D>(m, l, acc, rep, warp, lane, ob);
}

// float32 queries: the plain-FMA body; bf16: the key split (paged_split.cuh)
template <typename T, typename KV, int D, bool ROPE>
cudaError_t launch_typed(const psp::Args& a, int B, int nsplit,
                         cudaStream_t stream) {
  if constexpr (std::is_same<T, float>::value) {
    const dim3 grid(a.HK, B);
    paged_decode_kernel<KV, D, ROPE>
        <<<grid, kWarps * 32, ptt::decode::merge_smem_bytes<D>(a.H / a.HK),
           stream>>>(a);
    return cudaGetLastError();
  } else {
    return psp::launch<KV, D, true, ROPE, false>(a, B, nsplit, stream);
  }
}

template <typename T, int D>
cudaError_t launch_d(const psp::Args& a, int B, bool kv_int8, bool rope,
                     int nsplit, cudaStream_t stream) {
  if (kv_int8)
    return rope ? launch_typed<T, int8_t, D, true>(a, B, nsplit, stream)
                : launch_typed<T, int8_t, D, false>(a, B, nsplit, stream);
  return rope ? launch_typed<T, T, D, true>(a, B, nsplit, stream)
              : launch_typed<T, T, D, false>(a, B, nsplit, stream);
}

template <typename T>
cudaError_t launch_kv(const psp::Args& a, int B, int D, bool kv_int8,
                      bool rope, int nsplit, cudaStream_t stream) {
  if (D == 128) return launch_d<T, 128>(a, B, kv_int8, rope, nsplit, stream);
  if (D == 64) return launch_d<T, 64>(a, B, kv_int8, rope, nsplit, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// B9 / B10 with `nsplit` key splits for bf16 queries: 0 chooses them from
// the shape, as ptt_paged_decode does; 1, 2, 4 or 8 force them (to time
// the split rule against its alternatives). float32 queries take 0 only.
extern "C" int ptt_paged_decode_splits(
    const void* q, const void* cos_row, const void* sin_row,
    const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* block_tables, const void* lengths,
    void* out, int B, int H, int HK, int D, int page, int ppseq,
    long long kv_sp, long long kv_st, long long kv_sh, long long sc_sp,
    long long sc_st, long long sc_sh, float scale, int q_dtype,
    int kv_int8, int nsplit, void* stream) {
  if (B <= 0 || HK <= 0 || H % HK != 0 || H / HK > kMaxRep || page <= 0 ||
      ppseq <= 0 || !psp::valid_splits(nsplit, q_dtype))
    return cudaErrorInvalidValue;
  psp::Args a = {};
  a.q = q;
  a.cos_row = static_cast<const float*>(cos_row);
  a.sin_row = static_cast<const float*>(sin_row);
  a.k = k_pages;
  a.v = v_pages;
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
  a.kv_st = kv_st;
  a.kv_sh = kv_sh;
  a.sc_sp = sc_sp;
  a.sc_st = sc_st;
  a.sc_sh = sc_sh;
  a.scale = scale;
  const bool rope = cos_row != nullptr;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_dtype == 1)
    e = launch_kv<__nv_bfloat16>(a, B, D, kv_int8 != 0, rope, nsplit, s);
  else if (q_dtype == 0)
    e = launch_kv<float>(a, B, D, kv_int8 != 0, rope, 0, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}

// q_dtype: 0 = float32, 1 = bfloat16. cos_row == NULL selects B9, else
// B10. k_scales/v_scales are read only when kv_int8 != 0.
extern "C" int ptt_paged_decode(
    const void* q, const void* cos_row, const void* sin_row,
    const void* k_pages, const void* v_pages, const void* k_scales,
    const void* v_scales, const void* block_tables, const void* lengths,
    void* out, int B, int H, int HK, int D, int page, int ppseq,
    long long kv_sp, long long kv_st, long long kv_sh, long long sc_sp,
    long long sc_st, long long sc_sh, float scale, int q_dtype,
    int kv_int8, void* stream) {
  return ptt_paged_decode_splits(
      q, cos_row, sin_row, k_pages, v_pages, k_scales, v_scales,
      block_tables, lengths, out, B, H, HK, D, page, ppseq, kv_sp, kv_st,
      kv_sh, sc_sp, sc_st, sc_sh, scale, q_dtype, kv_int8, 0, stream);
}
