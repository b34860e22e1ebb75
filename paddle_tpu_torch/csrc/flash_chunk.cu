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
// the dequant and the blocking are the same code, so a chain tree
// (bits (2 << t) - 1) gives the linear kernel's bits. int8 caches carry
// per-row f32 scales (B, W, HK).
//
// What bounds it on the H100: it sits near the balance point. A chunk
// of T queries against W >> T context columns does about 4*D*T*W flops
// per head on 2*W*D K/V elements: T flops per bf16 byte, 256 at the
// engine's chunk width, just under the card's ~295 (989 TFLOP/s over
// 3.35 TB/s), so bf16 caches are bound by bytes and int8 caches, at
// half the bytes, by the tensor cores' operations.
//
// What the design does about it (a first, simple version):
// - one CTA per (query tile of 64, head, batch row): the engine's
//   prefill has B = 1, so the grid takes its parallelism from heads x
//   query tiles (32 x 4 = 128 CTAs at Llama-2-7B width and T = 256);
// - each CTA loops over 64-column key blocks from kstart's block up to
//   its tile's causal limit only, so masked blocks cost nothing;
// - the Q tile, the K and V blocks (dequantized and rounded to the
//   working dtype at load) and the probability tile sit in shared
//   memory as f32; each thread computes a 4 x 4 block of scores and a
//   4 x (D/16) block of the output with plain f32 FMA, and keeps the
//   online softmax state of its 4 rows in registers.
// - tree mode runs the column loop to W, not to the tile's causal limit,
//   so any ancestor matrix is honoured (the limits agree for T <= 64).
// It does not reach the tensor-core bound: mma.sync/wgmma tiles and TMA
// loads are later work. A verify chunk (T = 5..32) fills 5..32 of the
// 64 rows of its query tile, so most of the tile's arithmetic is wasted;
// at that shape the K/V read sets the bound. The page -> temp-cache
// gather stays in PyTorch, as it stays in XLA in the JAX package.

#include "common.cuh"

namespace {

constexpr int kBQ = 64;       // query rows per CTA
constexpr int kBK = 64;       // key columns per block
constexpr int kThreads = 256; // 16 x 16

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

template <typename E, typename T, int D, bool QUANT>
__device__ __forceinline__ void load_rows(float* dst, int ld, const E* src,
                                          const float* rows, long long sw,
                                          long long rsw,
                                          int row0, int nrows, int limit) {
  constexpr int EPC = 16 / sizeof(E);  // elements per 16-byte chunk
  constexpr int CPR = D / EPC;         // chunks per row
  for (int idx = threadIdx.x; idx < nrows * CPR; idx += kThreads) {
    const int r = idx / CPR;
    const int c = idx % CPR;
    float v[EPC];
    if (row0 + r < limit) {
      ptt::load_vec<E, EPC>(src + (long long)(row0 + r) * sw + c * EPC, v);
      if (QUANT) {
        const float sc = rows[(long long)(row0 + r) * rsw];
#pragma unroll
        for (int e = 0; e < EPC; ++e) v[e] = ptt::round_to<T>(v[e] * sc);
      }
    } else {
#pragma unroll
      for (int e = 0; e < EPC; ++e) v[e] = 0.f;
    }
#pragma unroll
    for (int e = 0; e < EPC; ++e) dst[r * ld + c * EPC + e] = v[e];
  }
}

template <typename T, typename KV, int D, bool TREE>
__global__ void __launch_bounds__(kThreads)
    flash_chunk_kernel(const ChunkArgs a) {
  constexpr bool QUANT = std::is_same<KV, int8_t>::value;
  constexpr int LDQ = D + 1;    // padded rows: conflict-free column walks
  constexpr int LDP = kBK + 1;
  constexpr int DPT = D / 16;   // output columns per thread
  extern __shared__ float smem[];
  float* sQ = smem;                  // [kBQ][LDQ]
  float* sK = sQ + kBQ * LDQ;        // [kBK][LDQ]
  float* sV = sK + kBK * LDQ;        // [kBK][D]
  float* sP = sV + kBK * D;          // [kBQ][LDP]

  const int q0 = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int rep = a.H / a.HK;
  const int g = h / rep;
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int qoff = a.W - a.T;
  const int kst = a.kstart[b];
  const int qend = min(q0 + kBQ, a.T);  // exclusive

  // Q tile: rows q0.. of head h (row stride H*D in the (B, T, H, D) q)
  load_rows<T, T, D, false>(
      sQ, LDQ,
      static_cast<const T*>(a.q) + ((long long)b * a.T * a.H + h) * D +
          (long long)q0 * a.H * D,
      nullptr, (long long)a.H * D, 0, 0, kBQ, a.T - q0);

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
  const int c_begin = (max(kst, 0) / kBK) * kBK;
  // exclusive limit: the tile's causal limit, or W for a tree
  const int c_end = TREE ? a.W : min(a.W, qoff + qend);

  for (int c0 = c_begin; c0 < c_end; c0 += kBK) {
    load_rows<KV, T, D, QUANT>(sK, LDQ, kb, ksb, a.c_sw, a.r_sw, c0, kBK,
                               a.W);
    load_rows<KV, T, D, QUANT>(sV, D, vb, vsb, a.c_sw, a.r_sw, c0, kBK,
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
      const int qpos = qoff + t;
      bool ok[4];
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int col = c0 + tx + 16 * j;
        bool seen;
        if (TREE) {
          const int rel = col - qoff;  // chunk node of this column
          seen = rel < 0 || (rel < a.T && ((anc[i] >> rel) & 1u));
        } else {
          seen = col <= qpos;
        }
        ok[j] = t < a.T && col < a.W && col >= kst && seen;
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
      // p is cast to V's working dtype before the product, as in the
      // TPU kernel
#pragma unroll
      for (int j = 0; j < 4; ++j)
        sP[(ty * 4 + i) * LDP + tx + 16 * j] = ptt::round_to<T>(p[j]);
    }
    __syncthreads();

#pragma unroll 4
    for (int c = 0; c < kBK; ++c) {
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

  T* ob = static_cast<T*>(a.out);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int t = q0 + ty * 4 + i;
    if (t >= a.T) continue;
    T* orow = ob + (((long long)b * a.T + t) * a.H + h) * D;
#pragma unroll
    for (int jj = 0; jj < DPT; ++jj)
      orow[tx + 16 * jj] =
          ptt::from_f<T>(l[i] > 0.f ? acc[i][jj] / l[i] : 0.f);
  }
}

template <typename T, typename KV, int D, bool TREE>
cudaError_t launch_typed(const ChunkArgs& a, int B, cudaStream_t stream) {
  const size_t smem =
      sizeof(float) * ((kBQ + kBK) * (D + 1) + kBK * D + kBQ * (kBK + 1));
  cudaError_t e = cudaFuncSetAttribute(
      flash_chunk_kernel<T, KV, D, TREE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  const dim3 grid((a.T + kBQ - 1) / kBQ, a.H, B);
  flash_chunk_kernel<T, KV, D, TREE><<<grid, kThreads, smem, stream>>>(a);
  return cudaGetLastError();
}

template <typename T, int D, bool TREE>
cudaError_t launch_kv(const ChunkArgs& a, int B, bool kv_int8,
                      cudaStream_t stream) {
  return kv_int8 ? launch_typed<T, int8_t, D, TREE>(a, B, stream)
                 : launch_typed<T, T, D, TREE>(a, B, stream);
}

template <typename T>
cudaError_t launch_d(const ChunkArgs& a, int B, int D, bool kv_int8,
                     cudaStream_t stream) {
  const bool tree = a.tree_bits != nullptr;
  if (D == 128)
    return tree ? launch_kv<T, 128, true>(a, B, kv_int8, stream)
                : launch_kv<T, 128, false>(a, B, kv_int8, stream);
  if (D == 64)
    return tree ? launch_kv<T, 64, true>(a, B, kv_int8, stream)
                : launch_kv<T, 64, false>(a, B, kv_int8, stream);
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
  if (B <= 0 || T <= 0 || HK <= 0 || H % HK != 0 || W < T ||
      (tree_bits != nullptr && T > 32))
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
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (q_dtype == 1)
    e = launch_d<__nv_bfloat16>(a, B, D, kv_int8 != 0, s);
  else if (q_dtype == 0)
    e = launch_d<float>(a, B, D, kv_int8 != 0, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
