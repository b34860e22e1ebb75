// Hopper (sm_90a) primitives as inline PTX: mbarriers, TMA tensor loads
// (and the host's tensor-map encoder), cp.async rings, wgmma shared-memory
// descriptors and products, and setmaxnreg.
//
// Layout law of every operand tile in shared memory here: a TMA box of
// 64 bf16 columns (128 bytes, the 128-byte swizzle's limit) by R rows,
// written by the hardware with CU_TENSOR_MAP_SWIZZLE_128B into a
// 1024-byte aligned buffer. Row r lies at byte r * 128; its 16-byte
// chunk c is stored at chunk c ^ (r % 8). Eight rows (1024 bytes) form
// one swizzle atom. A tile wider than 64 columns is several such boxes,
// one after the other, R * 128 bytes apart.
//
// A wgmma descriptor (PTX ISA, "Matrix Descriptor") names such a tile:
// start address >> 4 (bits 0-13), leading byte offset >> 4 (16-29),
// stride byte offset >> 4 (32-45), layout 1 = 128-byte swizzle (62-63).
// The swizzle is applied to the address bits, so a descriptor may start
// anywhere 16-byte aligned inside an atom-aligned tile.
// - K-major operand (the contraction axis is the tile's columns: Q and dO
//   as A, K and V as B of q.k^T and dO.v^T): a k16 step reads 32 bytes of
//   each row, so step kk starts at box (kk / 4) + (kk % 4) * 32 bytes; the
//   stride byte offset is one atom, 1024 (the next 8 rows); the leading
//   byte offset is unused with the swizzle (set to 16).
// - MN-major operand (the contraction axis is the tile's rows: V of P.V,
//   K of dS.K, with N along the columns): a k16 step reads 16 rows, so
//   step kk starts at kk * 16 * 128 bytes; the stride byte offset is
//   1024 (the next 8 rows along K); the leading byte offset is the
//   distance between the 64-column boxes along N, R * 128.
//
// wgmma fragments (m64nNk16, f32 accumulator; PTX ISA, "Register
// Fragments and Shared Memory Matrix Layouts"): warp w of the warpgroup
// owns rows 16w .. 16w + 15; with g = lane / 4, t = lane % 4, register
// d[4j + e] holds row 16w + g + 8 * (e / 2), column 8j + 2t + (e % 2).
// The A fragment of a k16 slice from registers is mma.sync's m16n8k16 A:
// a[0] = (g, 2t..2t+1), a[1] = (g + 8, 2t..), a[2] = (g, 2t + 8..),
// a[3] = (g + 8, 2t + 8..), low half first. So accumulator columns
// 16kk .. 16kk + 15 become the A slice kk as pack(d[8kk], d[8kk + 1]),
// pack(d[8kk + 2], d[8kk + 3]), pack(d[8kk + 4], ..), pack(d[8kk + 6], ..).
#pragma once

#include <cuda.h>
#include <cudaTypedefs.h>
#include <stdint.h>

#include "mma.cuh"

namespace hop {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// ------------------------------------------------------------ mbarrier
__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// makes the initialised barriers visible to the async proxy (TMA)
__device__ __forceinline__ void fence_barrier_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

// one arrival, and `bytes` more to come from TMA copies
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar,
                                                      uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar,
                                              uint32_t parity) {
  uint32_t ok;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(ok)
      : "r"(bar), "r"(parity)
      : "memory");
  return ok != 0;
}

// Wait until the phase of parity `parity` has completed (a fresh barrier
// is in phase 0, so waiting on parity 1 returns at once). A wait that
// lasts over ~10 s of clock traps, so a protocol fault ends the launch
// with an error instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const long long t0 = clock64();
  while (!mbar_try_wait(bar, parity))
    if (clock64() - t0 > 20000000000LL) __trap();
}

// ------------------------------------------------------------------ TMA
// A 4-D box of `map` at coordinates (c0 innermost .. c3) into shared
// memory at `dst`, completing `bytes` on the barrier `bar`.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// Host: encode the TMA map of a 4-D tensor, dims innermost first with the
// byte strides of dims 1..3, boxes of `box` elements. cuTensorMapEncodeTiled
// comes through the runtime's driver entry point, so the library needs no
// -lcuda. Returns false when the driver refuses the map.
inline bool tma_map_4d(CUtensorMap* map, CUtensorMapDataType type,
                       const void* ptr, const cuuint64_t (&dims)[4],
                       const cuuint64_t (&strides)[3],
                       const cuuint32_t (&box)[4],
                       CUtensorMapSwizzle swizzle) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &fn, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &fn, cudaEnableDefault, &found);
#endif
    if (e != cudaSuccess || found != cudaDriverEntryPointSuccess ||
        fn == nullptr)
      return false;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return encode(map, type, 4, const_cast<void*>(ptr), dims, strides, box,
                unit, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// ------------------------------------------------------------ proxies
// Orders this thread's ordinary shared-memory stores before later reads
// of the same bytes by the async proxy (a wgmma operand written by
// threads, not by TMA), and its earlier reads before a TMA write.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// named barrier `id` (1..15; 0 is __syncthreads) over `count` threads
__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
// arrive at named barrier `id` without waiting: a producer's half of a
// bar_sync by the consumers (count the two sides' threads together); its
// earlier shared-memory writes are visible to them after their bar_sync
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// ------------------------------------------------------------- cp.async
// A ring of stages filled by every thread with cp.async (sm_80 and later):
// each thread issues its copies of a stage, commits them as one group, and
// waits until at most N of its groups are in flight; a __syncthreads then
// makes the stage visible to the whole CTA.
// 16 bytes from global `src` to shared `dst`: `src_bytes` (16 or 0) read,
// the rest zero-filled (src must still be a valid address).
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
// 4 bytes, likewise (`src_bytes` 4 or 0)
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// ---------------------------------------------------------------- wgmma
// descriptor of a 128-byte-swizzled tile (see the layout law above)
__device__ __forceinline__ uint64_t desc_sw128(uint32_t saddr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((saddr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) |
         (static_cast<uint64_t>(1) << 62);
}

// orders the warpgroup's register and shared-memory accesses before the
// next wgmma
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// wait until at most N committed groups are in flight
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keeps the compiler from moving accesses of registers that an async
// wgmma reads or writes across the wait that ends it.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

#define HOP_F4(i) "+f"(d[i]), "+f"(d[i + 1]), "+f"(d[i + 2]), "+f"(d[i + 3])
#define HOP_F16(i) HOP_F4(i), HOP_F4(i + 4), HOP_F4(i + 8), HOP_F4(i + 12)
#define HOP_F32(i) HOP_F16(i), HOP_F16(i + 16)
#define HOP_D32                                                          \
  "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, " \
  "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, " \
  "%30, %31"
#define HOP_D64                                                          \
  HOP_D32 ", %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, " \
          "%44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, "   \
          "%56, %57, %58, %59, %60, %61, %62, %63"

// d (64 x N f32, N / 2 registers a thread) = A B (+ d when accumulate),
// A (64 x 16) and B (16 x N) bf16 from shared memory through descriptors;
// TRANS_B 0 takes B K-major, 1 MN-major.
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[32], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOP_D32
      "}, %32, %33, p, 1, 1, 0, %35;\n}\n"
      : HOP_F32(0)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}
template <int TRANS_B>
__device__ __forceinline__ void wgmma_ss(float (&d)[64], uint64_t da,
                                         uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOP_D64
      "}, %64, %65, p, 1, 1, 0, %67;\n}\n"
      : HOP_F32(0), HOP_F32(32)
      : "l"(da), "l"(db), "r"(accumulate), "n"(TRANS_B));
}

// the same with A (64 x 16 bf16) from registers, the fragment above
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[32],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {" HOP_D32
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, %38;\n}\n"
      : HOP_F32(0)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TRANS_B));
}
template <int TRANS_B>
__device__ __forceinline__ void wgmma_rs(float (&d)[64],
                                         const uint32_t (&a)[4], uint64_t db,
                                         int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {" HOP_D64
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, %70;\n}\n"
      : HOP_F32(0), HOP_F32(32)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db),
        "r"(accumulate), "n"(TRANS_B));
}

#undef HOP_F4
#undef HOP_F16
#undef HOP_F32
#undef HOP_D32
#undef HOP_D64

// acc (64 x N) = X Y^T over D, issued but not waited for: X the
// warpgroup's 64 rows of the K-major tile at `x`, whose 64-column boxes
// are ROWS_X * 128 bytes apart; Y the N rows of the K-major tile at `y`
// (boxes ROWS_Y * 128 apart).
template <int D, int N, int ROWS_X, int ROWS_Y>
__device__ __forceinline__ void wgmma_xyt(float (&acc)[N / 2], uint32_t x,
                                          uint32_t y) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<0>(acc,
                desc_sw128(x + (kk / 4) * ROWS_X * 128 + (kk % 4) * 32, 16,
                           1024),
                desc_sw128(y + (kk / 4) * ROWS_Y * 128 + (kk % 4) * 32, 16,
                           1024),
                kk > 0);
}

// acc (64 x D) += P Z: P (64 x BN) from registers, rounded to bf16 from
// the score accumulator `p`; Z the BN x D tile at `z` as the MN-major B
// operand (its D / 64 boxes BN * 128 bytes apart). Issues the products
// and waits for them.
template <int D, int BN>
__device__ __forceinline__ void wgmma_pz(float (&acc)[D / 2],
                                         const float (&p)[BN / 2],
                                         uint32_t z) {
  uint32_t pa[BN / 16][4];
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      pa[kk][r] = ptt::pack_bf16(p[8 * kk + 2 * r], p[8 * kk + 2 * r + 1]);
  wgmma_fence();
#pragma unroll
  for (int kk = 0; kk < BN / 16; ++kk)
    wgmma_rs<1>(acc, pa[kk], desc_sw128(z + kk * 16 * 128, BN * 128, 1024),
                1);
  wgmma_commit();
  wgmma_wait<0>();
  fence_regs(acc);
  fence_regs(pa);
}

// ------------------------------------------------------------ setmaxnreg
// Move registers between the warpgroups of a warp-specialised CTA: the
// whole warpgroup executes it, and the kernel's entry count must be the
// launch bound's (ptxas reports it) so that what one gives up the other
// can take.
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

// 2^x (ex2.approx, subnormal results flushed to 0; 2^-inf = 0)
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

}  // namespace hop
