// B6 fused rotate-half RoPE: the incubate op
// `fused_rotary_position_embedding` on q and k.
//
// Replaces the TPU kernel paddle_tpu/ops/pallas/fused.py `_rope_kernel`
// (wrapper `_rope_apply`, custom VJP `_rope_qk`, op `rope_qk`). For x
// (B, S, H, D) and (S, D/2) f32 tables, in f32 with one cast to x's
// dtype at the end:
//     o[..., i]          = x1 * cos[s, i] - x2 * sin[s, i] * sign
//     o[..., i + D / 2]  = x2 * cos[s, i] + x1 * sin[s, i] * sign
// with x1 = x[..., i] and x2 = x[..., i + D / 2]; sign = -1 is the VJP
// (the rotation by -theta). Products and sums are rounded one at a time
// (no fma contraction), as PyTorch's separate elementwise kernels
// round them in the plain version, so both give the same bits.
//
// What bounds it on the H100: bytes. Six f32 operations per element
// read and written, against the card's ~20 f32 operations per byte of
// bandwidth; at the Llama-2-7B prefill shape (B = 8, S = 1024, H = 32,
// D = 128, bf16) q and k move 268 MB, ~0.08 ms at 3.35 TB/s, and the
// tables (0.5 MB) stay in L2.
//
// What the design does about it:
// - every element of x is read once and written once, with vector
//   loads and stores of VEC pairs a thread (16 bytes where the head dim
//   and the strides allow: 8 bf16 or 4 f32 elements of each half), and
//   neighbouring threads on neighbouring chunks of one (b, s) row;
// - the table is read as (S, D/2) by (s, i): the TPU wrapper tiled it
//   per head with `jnp.tile` (a Mosaic workaround) and pre-split x into
//   halves; here one thread loads both halves of x itself;
// - x is read through its (batch, seq, head) strides, so q and k split
//   out of a fused qkv projection need no copy; the output is
//   contiguous;
// - any even head dim: VEC drops to 4, 2 or 1 pairs where D/2 or the
//   strides are not multiples of 8.
// One CTA per (b, s) row walks its H * D/2 / VEC chunks.

#include "common.cuh"

namespace {

struct RopeArgs {
  const void* x;        // (B, S, H, D), strided, last dim contiguous
  const float* cos;     // (S, D/2) f32, contiguous
  const float* sin;
  void* out;            // (B, S, H, D) contiguous
  int S, H, half;
  long long sb, ss, sh;  // element strides of x
  float sign;
};

// N f32 table entries at p (aligned to min(N, 4) floats) as loads of at
// most 16 bytes.
template <int N>
__device__ __forceinline__ void load_table(const float* p, float (&out)[N]) {
  constexpr int C = N < 4 ? N : 4;
#pragma unroll
  for (int j = 0; j < N; j += C) {
    float part[C];
    ptt::load_vec<float, C>(p + j, part);
#pragma unroll
    for (int i = 0; i < C; ++i) out[j + i] = part[i];
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(256) rope_kernel(const RopeArgs a) {
  const long long row = blockIdx.x;  // b * S + s
  const int s = static_cast<int>(row % a.S);
  const long long b = row / a.S;
  const int cpr = a.half / VEC;      // chunks per head
  const T* xr = static_cast<const T*>(a.x) + b * a.sb + s * a.ss;
  T* orow = static_cast<T*>(a.out) + row * a.H * (2LL * a.half);
  const float* crow = a.cos + (long long)s * a.half;
  const float* srow = a.sin + (long long)s * a.half;
  for (int t = threadIdx.x; t < a.H * cpr; t += blockDim.x) {
    const int h = t / cpr;
    const int i0 = (t % cpr) * VEC;
    const T* xh = xr + h * a.sh + i0;
    T* oh = orow + (long long)h * 2 * a.half + i0;
    float x1[VEC], x2[VEC], c[VEC], sn[VEC], o1[VEC], o2[VEC];
    ptt::load_vec<T, VEC>(xh, x1);
    ptt::load_vec<T, VEC>(xh + a.half, x2);
    load_table<VEC>(crow + i0, c);
    load_table<VEC>(srow + i0, sn);
#pragma unroll
    for (int i = 0; i < VEC; ++i) {
      const float si = __fmul_rn(sn[i], a.sign);
      o1[i] = __fsub_rn(__fmul_rn(x1[i], c[i]), __fmul_rn(x2[i], si));
      o2[i] = __fadd_rn(__fmul_rn(x2[i], c[i]), __fmul_rn(x1[i], si));
    }
    ptt::store_vec<T, VEC>(oh, o1);
    ptt::store_vec<T, VEC>(oh + a.half, o2);
  }
}

template <typename T, int VEC>
cudaError_t launch_vec(const RopeArgs& a, long long rows,
                       cudaStream_t stream) {
  const int chunks = a.H * (a.half / VEC);
  int threads = 32;
  while (threads < chunks && threads < 256) threads *= 2;
  rope_kernel<T, VEC><<<static_cast<unsigned>(rows), threads, 0, stream>>>(
      a);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_typed(const RopeArgs& a, long long rows, int vec,
                         cudaStream_t stream) {
  switch (vec) {
    case 1: return launch_vec<T, 1>(a, rows, stream);
    case 2: return launch_vec<T, 2>(a, rows, stream);
    case 4: return launch_vec<T, 4>(a, rows, stream);
    case 8:
      if constexpr (sizeof(T) == 2)
        return launch_vec<T, 8>(a, rows, stream);
      return cudaErrorInvalidValue;
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// x (B, S, H, 2 * half) with element strides (sb, ss, sh, 1); cos/sin
// (S, half) f32; out (B, S, H, 2 * half) contiguous. dtype: 0 = float32,
// 1 = bfloat16. vec: pairs a thread loads at once (1, 2, 4, or 8 for
// bfloat16); half, the strides and x's address must be multiples of it.
extern "C" int ptt_rope(const void* x, const void* cos, const void* sin,
                        void* out, int B, int S, int H, int half,
                        long long sb, long long ss, long long sh,
                        float sign, int dtype, int vec, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || half <= 0 || vec <= 0 ||
      half % vec != 0 || (long long)B * S > 0x7fffffffLL)
    return cudaErrorInvalidValue;
  RopeArgs a;
  a.x = x;
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.out = out;
  a.S = S;
  a.H = H;
  a.half = half;
  a.sb = sb;
  a.ss = ss;
  a.sh = sh;
  a.sign = sign;
  const long long rows = (long long)B * S;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t e;
  if (dtype == 1)
    e = launch_typed<__nv_bfloat16>(a, rows, vec, s);
  else if (dtype == 0)
    e = launch_typed<float>(a, rows, vec, s);
  else
    e = cudaErrorInvalidValue;
  return static_cast<int>(e);
}
