// B4a/B4b fused RMSNorm and B5a/B5b fused SwiGLU of the training model.
//
// Replaces the TPU kernels of paddle_tpu/ops/pallas/fused.py:
// `_rms_fwd_kernel` (B4a, the pallas_call in `_rms_norm_fwd`),
// `_rms_bwd_kernel` (B4b, `_rms_norm_bwd`), `_swiglu_fwd_kernel` (B5a,
// `_swiglu_2d`) and `_swiglu_bwd_kernel` (B5b, `_swiglu_bwd_rule`).
//
// Semantics, as the Pallas kernels compute them, all in f32 with one
// cast to the storage type at the end. x, g, u, d: (N, h) or (N, i)
// row-major, float32 or bfloat16, all of one dtype:
// - B4a: rstd = rsqrt(mean(x^2) + eps) per row, out = x * rstd * w in
//   x's dtype, and rstd as f32 (N,);
// - B4b: xhat = x * rstd, wg = g * w, dx = rstd * (wg - xhat *
//   mean(wg * xhat)) in x's dtype, and per CTA the f32 partial sums of
//   g * xhat over its rows, (n_blocks, h); the caller sums the partials
//   and casts them to w's dtype, as `_rms_norm_bwd` sums its per-block
//   partials. Rows past N add nothing (the TPU kernel's padded-row
//   rule: here the loop simply ends at N);
// - B5a: out = silu(g) * u in g's dtype;
// - B5b: sig = sigmoid(g), dsilu = sig * (1 + g * (1 - sig)),
//   dg = d * u * dsilu and du = d * g * sig, each in its input's dtype.
//
// What bounds them on the H100: bytes. Each does a handful of f32
// operations per element it reads or writes (B4a at the training
// shape: 4 per element, against the card's ~20 f32 operations per byte
// of bandwidth), so the least time is the traffic over 3.35 TB/s.
//
// What the design does about it (a first version: right before fast):
// - every tensor is read once and written once, with 16-byte loads and
//   stores (8 bf16 or two times 4 f32 per access, hence widths that are
//   multiples of 8); neighbouring threads touch neighbouring chunks;
// - RMSNorm rows are spread over one CTA: thread t holds the 8-element
//   chunks t and t + T of the row (C = 1 or 2 of them) in registers, so
//   the row is read from device memory once although it is needed
//   twice, before and after its sum of squares (or B4b's mean(wg *
//   xhat)), which one shuffle reduction per warp and one pass over 32
//   shared floats give. Widths up to 8192 (1024 chunks) fit in 512
//   threads of two chunks;
// - B4a runs one CTA per row. B4b runs one CTA per `rows` rows and
//   keeps each thread's share of the dw partial in registers across
//   them: no atomics, so dw comes out with the same bits on every run,
//   and the partials, (N / rows) * h * 4 bytes written here and read
//   once by the caller's sum, add 8% to the traffic at rows = 16;
// - B5a and B5b are flat: one 8-element chunk per thread, over all
//   N * i elements, in a grid-stride loop.
// Left for later: more bytes in flight per thread (the next row's loads
// issued before this row's reduction), and fusing the partials' sum.

#include "common.cuh"

namespace {

using bf16 = __nv_bfloat16;

constexpr int kMaxThreads = 512;                  // a row's CTA
constexpr int kMaxWidth = 2 * kMaxThreads * 8;    // two chunks a thread
constexpr int kFlatThreads = 256;                 // B5's CTA

// 8 consecutive elements of T at p (16-byte aligned) as floats, in one
// (bf16) or two (f32) 16-byte loads.
template <typename T>
__device__ __forceinline__ void load8(const T* __restrict__ p,
                                      float (&v)[8]) {
  constexpr int kN = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < 8; j += kN) {
    const uint4 raw = *reinterpret_cast<const uint4*>(p + j);
    const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
    for (int i = 0; i < kN; ++i) v[j + i] = ptt::to_f(e[i]);
  }
}

template <typename T>
__device__ __forceinline__ void store8(T* __restrict__ p,
                                       const float (&v)[8]) {
  constexpr int kN = 16 / sizeof(T);
#pragma unroll
  for (int j = 0; j < 8; j += kN) {
    uint4 raw;
    T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
    for (int i = 0; i < kN; ++i) e[i] = ptt::from_f<T>(v[j + i]);
    *reinterpret_cast<uint4*>(p + j) = raw;
  }
}

// The sum of x over the CTA (blockDim.x a multiple of 32), the same
// bits in every thread: each warp's butterfly, then every warp sums
// the warps' totals in the same order. `red` is 32 shared floats,
// free again when it returns.
__device__ __forceinline__ float block_sum(float x, float* red) {
  x = ptt::warp_sum(x);
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[threadIdx.x >> 5] = x;
  __syncthreads();
  x = ptt::warp_sum(lane < static_cast<int>(blockDim.x >> 5) ? red[lane]
                                                              : 0.f);
  __syncthreads();
  return x;
}

__device__ __forceinline__ float sigmoid(float x) {
  return 1.f / (1.f + expf(-x));
}

// B4a: one CTA per row; thread t holds chunks t + c * blockDim.x.
template <typename T, int C>
__global__ void rms_fwd_kernel(const T* __restrict__ x,
                               const T* __restrict__ w, T* __restrict__ out,
                               float* __restrict__ rstd, int h, float eps) {
  __shared__ float red[32];
  const int chunks = h / 8;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * h;
  float v[C][8];
  float ss = 0.f;
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = threadIdx.x + c * blockDim.x;
    if (k < chunks) {
      load8(x + base + k * 8, v[c]);
#pragma unroll
      for (int i = 0; i < 8; ++i) ss += v[c][i] * v[c][i];
    }
  }
  const float r = rsqrtf(block_sum(ss, red) / h + eps);
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = threadIdx.x + c * blockDim.x;
    if (k < chunks) {
      float wv[8], o[8];
      load8(w + k * 8, wv);
#pragma unroll
      for (int i = 0; i < 8; ++i) o[i] = v[c][i] * r * wv[i];
      store8(out + base + k * 8, o);
    }
  }
  if (threadIdx.x == 0) rstd[blockIdx.x] = r;
}

// B4b: one CTA per `rows` rows, the thread layout of B4a; dwp row
// blockIdx.x gets the CTA's partial sums of g * xhat.
template <typename T, int C>
__global__ void rms_bwd_kernel(const T* __restrict__ x,
                               const T* __restrict__ w,
                               const float* __restrict__ rstd,
                               const T* __restrict__ g, T* __restrict__ dx,
                               float* __restrict__ dwp, int n, int h,
                               int rows) {
  __shared__ float red[32];
  const int chunks = h / 8;
  float wv[C][8], acc[C][8];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = threadIdx.x + c * blockDim.x;
#pragma unroll
    for (int i = 0; i < 8; ++i) acc[c][i] = 0.f;
    if (k < chunks) load8(w + k * 8, wv[c]);
  }
  const int r0 = blockIdx.x * rows;
  const int r1 = min(r0 + rows, n);
  for (int row = r0; row < r1; ++row) {
    const int64_t base = static_cast<int64_t>(row) * h;
    const float rs = rstd[row];
    float xh[C][8], wg[C][8];
    float dot = 0.f;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = threadIdx.x + c * blockDim.x;
      if (k < chunks) {
        float gv[8];
        load8(x + base + k * 8, xh[c]);
        load8(g + base + k * 8, gv);
#pragma unroll
        for (int i = 0; i < 8; ++i) {
          xh[c][i] *= rs;
          wg[c][i] = gv[i] * wv[c][i];
          dot += wg[c][i] * xh[c][i];
          acc[c][i] += gv[i] * xh[c][i];
        }
      }
    }
    const float m = block_sum(dot, red) / h;
#pragma unroll
    for (int c = 0; c < C; ++c) {
      const int k = threadIdx.x + c * blockDim.x;
      if (k < chunks) {
        float o[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) o[i] = rs * (wg[c][i] - xh[c][i] * m);
        store8(dx + base + k * 8, o);
      }
    }
  }
#pragma unroll
  for (int c = 0; c < C; ++c) {
    const int k = threadIdx.x + c * blockDim.x;
    if (k < chunks)
      store8(dwp + static_cast<int64_t>(blockIdx.x) * h + k * 8, acc[c]);
  }
}

// B5a over `chunks` 8-element chunks.
template <typename T>
__global__ void swiglu_fwd_kernel(const T* __restrict__ g,
                                  const T* __restrict__ u,
                                  T* __restrict__ out, int64_t chunks) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       k < chunks; k += stride) {
    float gv[8], uv[8], o[8];
    load8(g + k * 8, gv);
    load8(u + k * 8, uv);
#pragma unroll
    for (int i = 0; i < 8; ++i) o[i] = gv[i] * sigmoid(gv[i]) * uv[i];
    store8(out + k * 8, o);
  }
}

// B5b over `chunks` 8-element chunks.
template <typename T>
__global__ void swiglu_bwd_kernel(const T* __restrict__ g,
                                  const T* __restrict__ u,
                                  const T* __restrict__ d,
                                  T* __restrict__ dg, T* __restrict__ du,
                                  int64_t chunks) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t k = static_cast<int64_t>(blockIdx.x) * blockDim.x +
                   threadIdx.x;
       k < chunks; k += stride) {
    float gv[8], uv[8], dv[8], a[8], b[8];
    load8(g + k * 8, gv);
    load8(u + k * 8, uv);
    load8(d + k * 8, dv);
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float sig = sigmoid(gv[i]);
      const float dsilu = sig * (1.f + gv[i] * (1.f - sig));
      a[i] = dv[i] * uv[i] * dsilu;
      b[i] = dv[i] * (gv[i] * sig);
    }
    store8(dg + k * 8, a);
    store8(du + k * 8, b);
  }
}

// Chunks a thread holds (1 or 2) and threads of a row's CTA (a multiple
// of 32) for width h; false for a width the kernels do not take.
bool row_layout(int h, int* c, int* threads) {
  if (h <= 0 || h % 8 || h > kMaxWidth) return false;
  const int chunks = h / 8;
  *c = chunks <= kMaxThreads ? 1 : 2;
  *threads = ((chunks + *c - 1) / *c + 31) / 32 * 32;
  return true;
}

template <typename T>
cudaError_t rms_fwd(const void* x, const void* w, void* out, void* rstd,
                    int n, int h, float eps, cudaStream_t s) {
  int c, t;
  if (n <= 0 || !row_layout(h, &c, &t)) return cudaErrorInvalidValue;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  T* op = static_cast<T*>(out);
  float* rp = static_cast<float*>(rstd);
  if (c == 1)
    rms_fwd_kernel<T, 1><<<n, t, 0, s>>>(xp, wp, op, rp, h, eps);
  else
    rms_fwd_kernel<T, 2><<<n, t, 0, s>>>(xp, wp, op, rp, h, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t rms_bwd(const void* x, const void* w, const void* rstd,
                    const void* g, void* dx, void* dwp, int n, int h,
                    int rows, cudaStream_t s) {
  int c, t;
  if (n <= 0 || rows <= 0 || !row_layout(h, &c, &t))
    return cudaErrorInvalidValue;
  const int blocks = (n + rows - 1) / rows;
  const T* xp = static_cast<const T*>(x);
  const T* wp = static_cast<const T*>(w);
  const float* rp = static_cast<const float*>(rstd);
  const T* gp = static_cast<const T*>(g);
  T* dxp = static_cast<T*>(dx);
  float* dwpp = static_cast<float*>(dwp);
  if (c == 1)
    rms_bwd_kernel<T, 1><<<blocks, t, 0, s>>>(xp, wp, rp, gp, dxp, dwpp, n,
                                              h, rows);
  else
    rms_bwd_kernel<T, 2><<<blocks, t, 0, s>>>(xp, wp, rp, gp, dxp, dwpp, n,
                                              h, rows);
  return cudaGetLastError();
}

// Blocks of kFlatThreads for `numel` elements (a multiple of 8).
bool flat_grid(long long numel, int* blocks, int64_t* chunks) {
  if (numel <= 0 || numel % 8) return false;
  *chunks = numel / 8;
  const int64_t b = (*chunks + kFlatThreads - 1) / kFlatThreads;
  *blocks = static_cast<int>(b < (1 << 30) ? b : (1 << 30));
  return true;
}

template <typename T>
cudaError_t swiglu_fwd(const void* g, const void* u, void* out,
                       long long numel, cudaStream_t s) {
  int blocks;
  int64_t chunks;
  if (!flat_grid(numel, &blocks, &chunks)) return cudaErrorInvalidValue;
  swiglu_fwd_kernel<T><<<blocks, kFlatThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(u),
      static_cast<T*>(out), chunks);
  return cudaGetLastError();
}

template <typename T>
cudaError_t swiglu_bwd(const void* g, const void* u, const void* d, void* dg,
                       void* du, long long numel, cudaStream_t s) {
  int blocks;
  int64_t chunks;
  if (!flat_grid(numel, &blocks, &chunks)) return cudaErrorInvalidValue;
  swiglu_bwd_kernel<T><<<blocks, kFlatThreads, 0, s>>>(
      static_cast<const T*>(g), static_cast<const T*>(u),
      static_cast<const T*>(d), static_cast<T*>(dg), static_cast<T*>(du),
      chunks);
  return cudaGetLastError();
}

}  // namespace

PTT_EXPORT_ERROR_STRING

// dtype: 0 = float32, 1 = bfloat16, for every tensor but rstd and the
// dw partials (f32).

// B4a: out (n, h), rstd (n,) f32.
extern "C" int ptt_rms_fwd(const void* x, const void* w, void* out,
                           void* rstd, int n, int h, float eps, int dtype,
                           void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return rms_fwd<bf16>(x, w, out, rstd, n, h, eps, s);
  if (dtype == 0) return rms_fwd<float>(x, w, out, rstd, n, h, eps, s);
  return cudaErrorInvalidValue;
}

// B4b: dx (n, h); dwp (ceil(n / rows), h) f32 partials.
extern "C" int ptt_rms_bwd(const void* x, const void* w, const void* rstd,
                           const void* g, void* dx, void* dwp, int n, int h,
                           int rows, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1)
    return rms_bwd<bf16>(x, w, rstd, g, dx, dwp, n, h, rows, s);
  if (dtype == 0)
    return rms_bwd<float>(x, w, rstd, g, dx, dwp, n, h, rows, s);
  return cudaErrorInvalidValue;
}

// B5a: out = silu(g) * u, numel elements.
extern "C" int ptt_swiglu_fwd(const void* g, const void* u, void* out,
                              long long numel, int dtype, void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return swiglu_fwd<bf16>(g, u, out, numel, s);
  if (dtype == 0) return swiglu_fwd<float>(g, u, out, numel, s);
  return cudaErrorInvalidValue;
}

// B5b: dg, du, numel elements.
extern "C" int ptt_swiglu_bwd(const void* g, const void* u, const void* d,
                              void* dg, void* du, long long numel, int dtype,
                              void* stream) {
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 1) return swiglu_bwd<bf16>(g, u, d, dg, du, numel, s);
  if (dtype == 0) return swiglu_bwd<float>(g, u, d, dg, du, numel, s);
  return cudaErrorInvalidValue;
}
