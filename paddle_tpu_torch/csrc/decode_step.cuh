// The one-token decode attention core shared by B7 (decode_attention.cu,
// a contiguous padded cache, bf16 and float32 queries) and the float32
// bodies of B8 (decode_attention.cu, a head-major page pool) and B9/B10
// (paged_decode.cu, block-table page pools; their bf16 bodies are the key
// split of paged_split.cuh): the online softmax of one CTA's GQA group of
// query rows over the live tokens of one batch row, and the merge of its
// warps' partial states. The kernels differ only in where a token's K/V
// row and scale live, which they pass in as an address functor.
//
// Each of the CTA's kWarps warps takes kUnroll consecutive tokens at a
// time and issues all of their K and V loads (one vector load per lane
// per row) before the arithmetic, to keep enough bytes in flight. No
// token at or past `len` is read. int8 rows dequantize in registers,
// `(float(k) * scale)` rounded to the query's dtype as in the reference,
// and p is rounded to that dtype before the product with V.
#pragma once

#include "common.cuh"

namespace ptt {
namespace decode {

constexpr int kWarps = 8;
constexpr int kMaxRep = 8;
constexpr int kUnroll = 4;

// `rep` query rows of D values starting at qb, DPL = D / 32 per lane, as
// f32 (rows past rep are zero).
template <typename T, int D>
__device__ __forceinline__ void load_q(const T* qb, int rep, int d0,
                                       float (&q)[kMaxRep][D / 32]) {
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r < rep) {
      load_vec<T, D / 32>(qb + r * D + d0, q[r]);
    } else {
#pragma unroll
      for (int i = 0; i < D / 32; ++i) q[r][i] = 0.f;
    }
  }
}

// Online softmax of the rows q against tokens [0, len). addr.at(j, kv,
// sc) gives the element offsets of token j's K/V row (the lane's first
// dimension included) and of its scale. Returns the warp's partial state
// in m, l and acc.
template <typename T, typename KV, int D, typename Addr>
__device__ __forceinline__ void attend(
    const float (&q)[kMaxRep][D / 32], int rep, int len, float scale,
    const KV* kp, const KV* vp, const float* k_scales,
    const float* v_scales, const Addr& addr, int warp, float (&m)[kMaxRep],
    float (&l)[kMaxRep], float (&acc)[kMaxRep][D / 32]) {
  constexpr int DPL = D / 32;
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    m[r] = -INFINITY;
    l[r] = 0.f;
#pragma unroll
    for (int i = 0; i < DPL; ++i) acc[r][i] = 0.f;
  }
  // the loop bounds are uniform across a warp, so every lane joins the
  // shuffles of warp_sum
  for (int j0 = warp * kUnroll; j0 < len; j0 += kWarps * kUnroll) {
    float kk[kUnroll][DPL], vv[kUnroll][DPL], ksc[kUnroll], vsc[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int j = j0 + u;
      ksc[u] = vsc[u] = 0.f;
      if (j < len) {
        long long off, so;
        addr.at(j, off, so);
        load_vec<KV, DPL>(kp + off, kk[u]);
        load_vec<KV, DPL>(vp + off, vv[u]);
        if (QUANT) {
          ksc[u] = k_scales[so];
          vsc[u] = v_scales[so];
        }
      } else {
#pragma unroll
        for (int i = 0; i < DPL; ++i) kk[u][i] = vv[u][i] = 0.f;
      }
    }
    if (QUANT) {
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
#pragma unroll
        for (int i = 0; i < DPL; ++i) {
          kk[u][i] = round_to<T>(kk[u][i] * ksc[u]);
          vv[u][i] = round_to<T>(vv[u][i] * vsc[u]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < kMaxRep; ++r) {
      if (r >= rep) break;
      float s[kUnroll];
      float mg = m[r];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        float part = 0.f;
#pragma unroll
        for (int i = 0; i < DPL; ++i) part += q[r][i] * kk[u][i];
        s[u] = warp_sum(part) * scale;
        if (j0 + u < len) mg = fmaxf(mg, s[u]);
      }
      // token j0 < len is live, so mg is finite here
      const float alpha = expf(m[r] - mg);
      float psum = 0.f;
#pragma unroll
      for (int i = 0; i < DPL; ++i) acc[r][i] *= alpha;
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (j0 + u < len) {
          const float p = expf(s[u] - mg);
          psum += p;
          // p is cast to V's working dtype before the product, as in
          // the TPU kernels
          const float pv = round_to<T>(p);
#pragma unroll
          for (int i = 0; i < DPL; ++i) acc[r][i] += pv * vv[u][i];
        }
      }
      l[r] = l[r] * alpha + psum;
      m[r] = mg;
    }
  }
}

// Dynamic shared memory that merge_store needs for `rep` rows.
template <int D>
inline size_t merge_smem_bytes(int rep) {
  return sizeof(float) * kWarps * rep * (2 + D);
}

// Merge the warps' partial softmax states through shared memory and
// write the rep output rows at ob, each acc / l, or 0 for a row that saw
// no token (len 0).
template <typename T, int D>
__device__ __forceinline__ void merge_store(
    const float (&m)[kMaxRep], const float (&l)[kMaxRep],
    const float (&acc)[kMaxRep][D / 32], int rep, int warp, int lane,
    T* ob) {
  constexpr int DPL = D / 32;
  const int d0 = lane * DPL;
  extern __shared__ float smem[];
  float* sm_m = smem;                       // [kWarps][rep]
  float* sm_l = sm_m + kWarps * rep;        // [kWarps][rep]
  float* sm_acc = sm_l + kWarps * rep;      // [kWarps][rep][D]
#pragma unroll
  for (int r = 0; r < kMaxRep; ++r) {
    if (r >= rep) break;
    if (lane == 0) {
      sm_m[warp * rep + r] = m[r];
      sm_l[warp * rep + r] = l[r];
    }
#pragma unroll
    for (int i = 0; i < DPL; ++i)
      sm_acc[(warp * rep + r) * D + d0 + i] = acc[r][i];
  }
  __syncthreads();
  for (int idx = threadIdx.x; idx < rep * D; idx += blockDim.x) {
    const int r = idx / D;
    const int d = idx % D;
    float M = -INFINITY;
    for (int w = 0; w < kWarps; ++w) M = fmaxf(M, sm_m[w * rep + r]);
    float L = 0.f, o = 0.f;
    for (int w = 0; w < kWarps; ++w) {
      const float mw = sm_m[w * rep + r];
      if (mw == -INFINITY) continue;  // a warp that saw no token
      const float f = expf(mw - M);
      L += sm_l[w * rep + r] * f;
      o += sm_acc[(w * rep + r) * D + d] * f;
    }
    ob[r * D + d] = from_f<T>(L > 0.f ? o / L : 0.f);
  }
}

}  // namespace decode
}  // namespace ptt
