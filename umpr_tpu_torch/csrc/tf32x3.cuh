// Building blocks shared by K1 (gru_input_proj.cu), K4
// (gru_input_proj_bwd.cu), K7 (affinity_tiles.cu) and K9
// (gru_input_proj_dx.cu): f32-accurate products on the tensor cores
// (3xTF32) with mma.sync and wgmma, and cp.async copies into shared
// memory.
//
// 3xTF32.  An f32 value f is split into two TF32 values, big = f rounded
// to TF32 (11 significant bits) and small = (f - big) rounded to TF32;
// f - big is exact in f32.  A product a*b is then summed as
// a_small*b_big + a_big*b_small + a_big*b_big with f32 accumulation; the
// dropped a_small*b_small and the rounding of the small parts are each
// below 2^-22 of |a*b|, so the result keeps f32 accuracy.  This is the
// Hopper counterpart of the TPU kernels' Precision.HIGHEST (multi-pass
// bf16 products on the matrix unit), not the one-pass TF32 that f32 parity
// turns off.  The three products go in that fixed order, so a launch's
// bits do not depend on anything but its inputs.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace tf32x3 {

__device__ __forceinline__ uint32_t to_tf32(float f) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;" : "=r"(r) : "f"(f));
  return r;
}

// f = big + small (to within 2^-22 |f|), both as TF32 bit patterns
__device__ __forceinline__ void split(float f, uint32_t& big, uint32_t& small) {
  big = to_tf32(f);
  small = to_tf32(f - __uint_as_float(big));
}

// d += a (16x8, row) * b (8x8, col), TF32 in, f32 accumulation.  Fragment
// layout (g = lane / 4, t = lane % 4): a = A[g][t], A[g+8][t], A[g][t+4],
// A[g+8][t+4]; b = B[t][g], B[t+4][g]; d = D[g][2t], D[g][2t+1],
// D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// d += a * b in 3xTF32: (a_small, b_big), (a_big, b_small), (a_big, b_big)
__device__ __forceinline__ void mma3(float (&d)[4], const uint32_t (&a_big)[4],
                                     const uint32_t (&a_small)[4], uint32_t b0_big,
                                     uint32_t b1_big, uint32_t b0_small, uint32_t b1_small) {
  mma(d, a_small, b0_big, b1_big);
  mma(d, a_big, b0_small, b1_small);
  mma(d, a_big, b0_big, b1_big);
}

// acc += a * b in 3xTF32, one 8-deep step summed on its own from zero and
// then added to acc in f32 (round to nearest).  The tensor core's own f32
// accumulation rounds more coarsely than an f32 add, at the magnitude of
// its largest term: chained over a whole depth into one accumulator it
// missed a 1e-5 gate at E = 50, so each step's error is kept at the
// step's size, not the running sum's.
__device__ __forceinline__ void mma3_add(float (&acc)[4], const uint32_t (&a_big)[4],
                                         const uint32_t (&a_small)[4], uint32_t b0_big,
                                         uint32_t b1_big, uint32_t b0_small, uint32_t b1_small) {
  float t[4] = {0.f, 0.f, 0.f, 0.f};
  mma3(t, a_big, a_small, b0_big, b1_big, b0_small, b1_small);
#pragma unroll
  for (int r = 0; r < 4; ++r) acc[r] += t[r];
}

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;" ::"r"(smem_addr(dst)), "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;" ::: "memory");
}

// wait until at most n of this thread's committed groups are in flight
template <int n>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;" ::"n"(n) : "memory");
}

// ---- the IO types of K1-K4: float or bf16 in memory, f32 in registers.
// A bf16 value is exact in TF32 (8 exponent bits, 7 of mantissa), so its
// split has small = 0 and one TF32 product of two bf16 values is exact
// (K2, K3 and K1's wide-E kernels; K1's and K4's bf16 wgmma routes take
// native bf16 products, wgmma_bf16.cuh).

using bf16 = __nv_bfloat16;

template <class T>
constexpr bool is_bf16 = std::is_same<T, bf16>::value;

__device__ __forceinline__ float ld(float v) { return v; }
__device__ __forceinline__ float ld(bf16 v) { return __bfloat162float(v); }

// f32 -> T, bf16 rounded to nearest even (as XLA's astype)
template <class T>
__device__ __forceinline__ T io_from(float v) {
  if constexpr (is_bf16<T>)
    return __float2bfloat16_rn(v);
  else
    return v;
}

// v rounded to T's precision, in f32
template <class T>
__device__ __forceinline__ float round_to(float v) {
  return ld(io_from<T>(v));
}

// two neighbouring outputs as one 8-byte (f32) or 4-byte (bf16) store;
// p 8- or 4-byte aligned
template <class T>
__device__ __forceinline__ void store_pair(T* p, float a, float b) {
  if constexpr (is_bf16<T>)
    *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
  else
    *reinterpret_cast<float2*>(p) = make_float2(a, b);
}

// Copy the n contiguous T at src to dst (shared), all threads of the
// block together; 16-byte cp.async where src and dst are 16-byte aligned
// (vec), the tail and the unaligned case as 4-byte cp.async for f32 and
// as plain 2-byte copies for bf16 (cp.async has none that small; the
// caller's barrier before the data is read orders them as it does the
// copies' completion).
template <class T>
__device__ __forceinline__ void copy_span(T* dst, const T* src, int n, bool vec, int tid,
                                          int threads) {
  constexpr int PER = 16 / sizeof(T);
  int done = 0;
  if (vec) {
    const int nv = n / PER;
    for (int i = tid; i < nv; i += threads) cp_async16(dst + PER * i, src + PER * i);
    done = nv * PER;
  }
  for (int i = done + tid; i < n; i += threads) {
    if constexpr (is_bf16<T>)
      dst[i] = src[i];
    else
      cp_async4(dst + i, src + i);
  }
}

// ---- wgmma (Hopper warpgroup MMA), TF32, A from registers, B from shared

// A warpgroup (4 warps, 128 threads) computes D (64 x N) += A (64 x 8) B (8 x N).
// A: each warp's 16 rows in the mma fragment layout above (rows 16 w + g,
// 16 w + g + 8).  D: per n8 column group j, d[4j .. 4j+3] = D[16w+g][8j+2t],
// D[16w+g][8j+2t+1], D[16w+g+8][8j+2t], D[16w+g+8][8j+2t+1].  B: K-major
// (TF32 allows no other) without swizzle: 8x4 "core matrices" of 128
// contiguous bytes (8 rows of n, 4 k each), the two k halves 128 bytes
// apart, the n groups 256 bytes apart: element (n, k) of a step's tile at
// float (n / 8) * 64 + (k / 4) * 32 + (n % 8) * 4 + k % 4.
// scale_d = 0 overwrites D, 1 adds to it.
template <int N>
struct Wgmma;

template <>
struct Wgmma<128> {
  __device__ __forceinline__ static void run(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
          "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
          "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
          "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
          "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<64> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct Wgmma<56> {
  __device__ __forceinline__ static void run(float (&d)[28], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k8.f32.tf32.tf32 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27"
        "}, {%28, %29, %30, %31}, %32, p, 1, 1;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// the float offset of B element (n, k) in a step's tile (see above)
__device__ __forceinline__ int b_offset(int n, int k) {
  return (n >> 3) * 64 + (k >> 2) * 32 + (n & 7) * 4 + (k & 3);
}

// the shared-memory matrix descriptor of a B tile laid out as above
__device__ __forceinline__ uint64_t b_desc(const float* tile) {
  return static_cast<uint64_t>((smem_addr(tile) & 0x3FFFF) >> 4)  // start address
         | static_cast<uint64_t>(128 >> 4) << 16                     // k halves: 128 B apart
         | static_cast<uint64_t>(256 >> 4) << 32;                    // n groups: 256 B apart
}

// before a warpgroup's wgmmas read registers other instructions wrote
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}

// wait until at most n of the warpgroup's committed wgmma groups are pending
template <int n>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;" ::"n"(n) : "memory");
}

// keep the compiler from moving accesses of accumulator registers across
// the asynchronous wgmmas that own them
template <int n>
__device__ __forceinline__ void fence_regs(float (&d)[n]) {
#pragma unroll
  for (int i = 0; i < n; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// shared-memory writes of this thread visible to the async proxy (wgmma)
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
}

// barrier `id` (1..15) over `threads` threads of the block
__device__ __forceinline__ void named_barrier(int id, int threads) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "r"(threads) : "memory");
}

// cp.async of `bytes` (16 or 0) from src, the rest of the 16 zero-filled
__device__ __forceinline__ void cp_async16_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

// cp.async of `bytes` (4 or 0) from src, the rest of the 4 zero-filled
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src, int bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;" ::"r"(smem_addr(dst)), "l"(src),
               "r"(bytes)
               : "memory");
}

}  // namespace tf32x3
