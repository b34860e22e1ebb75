// B9 ragged paged decode attention and B10 the same with q's RoPE
// applied in the kernel.
//
// Replaces the TPU kernels paddle_tpu/ops/pallas/paged_attention.py
// `_paged_kernel` / `_paged_kernel_rowq` (wrapper
// `paged_attention_kernel`) and paddle_tpu/ops/pallas/serving_fused.py
// `_fused_paged_kernel` / `_fused_paged_kernel_rowq` (wrapper
// `fused_paged_decode_kernel`).
//
// What bounds it on the H100: bytes. One decode query row per (batch
// row, head) reads every live K and V row of its request once and does
// 4*D flops per head per token: about 1 flop per byte in bf16, against
// the ~295 flops/byte at which the tensor cores would become the limit.
//
// What the design does about it:
// - one CTA per (batch row, kv head) serves the whole GQA group of
//   rep = H/HK query heads, so each K/V row is read from HBM once for
//   all of them;
// - the CTA walks the row's LIVE tokens only (ceil(len/page) pages):
//   the ragged early-out of the TPU grid, with nothing read past len;
// - the pool is read in its native (P, page, HK, D) layout through its
//   strides, where the TPU wrapper transposed the whole pool to
//   (HK, P, page, D) on every call; each CTA loads its own block-table
//   row, which is what the TPU's scalar prefetch carried;
// - eight warps each take UNROLL consecutive tokens at a time and issue
//   all of their K and V loads (one vector load per lane per row)
//   before the arithmetic, to keep enough bytes in flight;
// - int8 rows dequantize in registers, `(float(k) * scale)` rounded to
//   q's dtype as in the reference, so HBM traffic stays 1 byte/element;
// - the online softmax (max, sum, f32 accumulator) lives in registers
//   in place of the TPU's scratch carried across the sequential grid
//   axis, and the warps' partial states merge once through shared
//   memory at the end. That core is decode_step.cuh, shared with B7
//   (decode_attention.cu); this file adds the block-table addressing.
//
// B10 rotates q in f32 with round-to-nearest products and sums (no fma
// contraction), so the rotated q equals the plain PyTorch rotation bit
// for bit; the TPU kernel needed rotate_half(q) as a second input
// (a Mosaic workaround), here the partner half is loaded from q itself.

#include "decode_step.cuh"

namespace {

using ptt::decode::kMaxRep;
using ptt::decode::kWarps;

struct DecodeArgs {
  const void* q;           // (B, H, D) model dtype, contiguous
  const float* cos_row;    // (B, D/2) f32, B10 only
  const float* sin_row;    // (B, D/2) f32, B10 only
  const void* k_pages;     // (P, page, HK, D) model dtype or int8
  const void* v_pages;
  const float* k_scales;   // (P, page, HK) f32, int8 pools only
  const float* v_scales;
  const int* block_tables; // (B, ppseq) int32, contiguous
  const int* lengths;      // (B,) int32, current token included
  void* out;               // (B, H, D) model dtype, contiguous
  int H, HK, page, ppseq;
  long long kv_sp, kv_st, kv_sh;  // element strides of the K/V pools
  long long sc_sp, sc_st, sc_sh;  // element strides of the scale pools
  float scale;
};

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

template <typename T, typename KV, int D, bool ROPE>
__global__ void __launch_bounds__(kWarps * 32)
    paged_decode_kernel(const DecodeArgs a) {
  constexpr int DPL = D / 32;  // dims per lane
  const int g = blockIdx.x;  // kv head
  const int b = blockIdx.y;  // batch row
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  const int rep = a.H / a.HK;
  const int len = a.lengths[b];
  const int d0 = lane * DPL;

  // this group's query rows in f32 (after the in-kernel RoPE for B10)
  const T* qb = static_cast<const T*>(a.q) +
                ((long long)b * a.H + (long long)g * rep) * D;
  float q[kMaxRep][DPL];
  ptt::decode::load_q<T, D>(qb, rep, d0, q);
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
      ptt::load_vec<T, DPL>(qb + r * D + (lo ? d0 + half : d0 - half), y);
#pragma unroll
      for (int i = 0; i < DPL; ++i) {
        // first half: x1*c - x2*s; second half: x2*c + x1*s
        const float xc = __fmul_rn(q[r][i], c[i]);
        const float ys = __fmul_rn(y[i], s[i]);
        q[r][i] = ptt::round_to<T>(lo ? __fsub_rn(xc, ys)
                                      : __fadd_rn(xc, ys));
      }
    }
  }

  const PagedAddr addr{a.block_tables + (long long)b * a.ppseq, a.page,
                       a.kv_sp, a.kv_st, (long long)g * a.kv_sh + d0,
                       a.sc_sp, a.sc_st, (long long)g * a.sc_sh};
  float m[kMaxRep], l[kMaxRep], acc[kMaxRep][DPL];
  ptt::decode::attend<T, KV, D>(
      q, rep, len, a.scale, static_cast<const KV*>(a.k_pages),
      static_cast<const KV*>(a.v_pages), a.k_scales, a.v_scales, addr, warp,
      m, l, acc);
  T* ob = static_cast<T*>(a.out) +
          ((long long)b * a.H + (long long)g * rep) * D;
  ptt::decode::merge_store<T, D>(m, l, acc, rep, warp, lane, ob);
}

template <typename T, typename KV, int D>
cudaError_t launch_typed(const DecodeArgs& a, int B, bool rope,
                         cudaStream_t stream) {
  const dim3 grid(a.HK, B);
  const size_t smem = ptt::decode::merge_smem_bytes<D>(a.H / a.HK);
  if (rope)
    paged_decode_kernel<T, KV, D, true>
        <<<grid, kWarps * 32, smem, stream>>>(a);
  else
    paged_decode_kernel<T, KV, D, false>
        <<<grid, kWarps * 32, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_kv(const DecodeArgs& a, int B, int D, bool kv_int8,
                      bool rope, cudaStream_t stream) {
  if (D == 128)
    return kv_int8 ? launch_typed<T, int8_t, 128>(a, B, rope, stream)
                   : launch_typed<T, T, 128>(a, B, rope, stream);
  if (D == 64)
    return kv_int8 ? launch_typed<T, int8_t, 64>(a, B, rope, stream)
                   : launch_typed<T, T, 64>(a, B, rope, stream);
  return cudaErrorInvalidValue;
}

}  // namespace

PTT_EXPORT_ERROR_STRING

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
  if (B <= 0 || HK <= 0 || H % HK != 0 || H / HK > kMaxRep || page <= 0)
    return cudaErrorInvalidValue;
  DecodeArgs a;
  a.q = q;
  a.cos_row = static_cast<const float*>(cos_row);
  a.sin_row = static_cast<const float*>(sin_row);
  a.k_pages = k_pages;
  a.v_pages = v_pages;
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
    e = launch_kv<__nv_bfloat16>(a, B, D, kv_int8 != 0, rope, s);
  else if (q_dtype == 0)
    e = launch_kv<float>(a, B, D, kv_int8 != 0, rope, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
