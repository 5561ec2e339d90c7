// Building blocks of the bf16 routes of K1 (gru_input_proj.cu), K4
// (gru_input_proj_bwd.cu), K3's sweep (bigru_backward.cu) and K9
// (gru_input_proj_dx.cu): native bf16 products on Hopper's tensor cores,
// wgmma m64nNk16 (K1, K4) or mma.sync m16n8k16 (K3, K9) with bf16 operands
// and f32 accumulators.  The product of
// two bf16 values is exact in f32, so each k-step adds exact products into
// an f32 accumulator: the JAX kernels' bf16 path (bf16 operands, f32
// accumulation) with nothing widened and no TF32 split.
//
// A comes from registers (wgmma's A-from-registers form), as 32-bit pairs
// of bf16 (the lower k in the lower half); B from shared memory, K-major
// without swizzle, through a matrix descriptor.
//
// K1's bf16 streaming kernel (E past 256) and K9's bf16 kernel take A
// from row chunks of their input that cp.async copies into a shared ring
// (copy_rows, chunk_a, at the end).

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace wgmma_bf16 {

__device__ __forceinline__ uint32_t bits(__nv_bfloat16 v) { return __bfloat16_as_ushort(v); }

// two bf16 as one 32-bit A register: lo in the low half
__device__ __forceinline__ uint32_t pack(uint32_t lo, uint32_t hi) { return lo | hi << 16; }

// the two bf16 of a 32-bit register, in f32 (exact)
__device__ __forceinline__ float lo_f(uint32_t r) { return __uint_as_float(r << 16); }
__device__ __forceinline__ float hi_f(uint32_t r) { return __uint_as_float(r & 0xFFFF0000u); }

// two f32 rounded to bf16 (nearest even, as XLA's astype) as one register
__device__ __forceinline__ uint32_t round_pair(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// A warpgroup (4 warps, 128 threads) computes D (64 x N) += A (64 x 16) B (16 x N).
// A: warp w holds rows 16 w .. 16 w + 15 as mma.sync's m16n8k16 A fragment
// (g = lane / 4, t = lane % 4): a[0] = A[g][2t, 2t+1], a[1] = A[g+8][2t,
// 2t+1], a[2] = A[g][2t+8, 2t+9], a[3] = A[g+8][2t+8, 2t+9].  D: per n8
// column group j, d[4j .. 4j+3] = D[16w+g][8j+2t], D[16w+g][8j+2t+1],
// D[16w+g+8][8j+2t], D[16w+g+8][8j+2t+1].  B: K-major, no swizzle (the
// trailing 0 is tnspB): 8x8 "core matrices" of 128 contiguous bytes (8
// rows of n, 8 k each), the two k halves 128 bytes apart, the n groups
// 256 bytes apart (tile_offset, desc).  scale_d = 0 overwrites D, 1 adds.
template <int N>
struct WgmmaBf16;

template <>
struct WgmmaBf16<128> {
  __device__ __forceinline__ static void run(float (&d)[64], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, "
        "%32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
        "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63"
        "}, {%64, %65, %66, %67}, %68, p, 1, 1, 0;\n}\n"
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
struct WgmmaBf16<64> {
  __device__ __forceinline__ static void run(float (&d)[32], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31"
        "}, {%32, %33, %34, %35}, %36, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

template <>
struct WgmmaBf16<56> {
  __device__ __forceinline__ static void run(float (&d)[28], const uint32_t (&a)[4], uint64_t b,
                                             int scale_d) {
    asm volatile(
        "{\n.reg .pred p;\nsetp.ne.b32 p, %33, 0;\n"
        "wgmma.mma_async.sync.aligned.m64n56k16.f32.bf16.bf16 {"
        "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
        "%16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27"
        "}, {%28, %29, %30, %31}, %32, p, 1, 1, 0;\n}\n"
        : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
          "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
          "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
          "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27])
        : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(b), "r"(scale_d));
  }
};

// the bf16 offset of B element (n, k) in one k16 step's tile (see above)
__device__ __forceinline__ int tile_offset(int n, int k) {
  return (n >> 3) * 128 + (k >> 3) * 64 + (n & 7) * 8 + (k & 7);
}

// the shared-memory matrix descriptor of a B tile laid out as above
__device__ __forceinline__ uint64_t desc(const __nv_bfloat16* tile) {
  const uint32_t a = static_cast<uint32_t>(__cvta_generic_to_shared(tile));
  return static_cast<uint64_t>((a & 0x3FFFF) >> 4)       // start address
         | static_cast<uint64_t>(128 >> 4) << 16          // k halves: 128 B apart
         | static_cast<uint64_t>(256 >> 4) << 32;         // n groups: 256 B apart
}

// d += a (16x16, row) * b (16x8, col), bf16 in, f32 accumulation (one warp).
// Fragments (g = lane / 4, t = lane % 4): a = A[g][2t..2t+1],
// A[g+8][2t..2t+1], A[g][2t+8..2t+9], A[g+8][2t+8..2t+9]; b = B[2t..2t+1][g],
// B[2t+8..2t+9][g]; d = D[g][2t], D[g][2t+1], D[g+8][2t], D[g+8][2t+1].
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                         uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Four 8x8 bf16 matrices from shared memory: lane l gives the row address
// of matrix l / 8 (16-byte aligned, 8 contiguous bf16), and a[i] receives
// matrix i's elements [g][2t], [g][2t+1].  With rows m and columns k it
// yields an A fragment (matrices: rows 0-7 | 8-15 x k 0-7 | 8-15, rows
// first); with rows n and columns k, the b0, b1 of two n8 groups.
__device__ __forceinline__ void ldsm_x4(uint32_t (&a)[4], const __nv_bfloat16* row) {
  const uint32_t p = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(p)
               : "memory");
}

// Four 8x8 bf16 matrices from shared memory, transposed: lane l gives the
// row address of matrix l / 8 (16-byte aligned, 8 contiguous bf16), and
// a[i] receives matrix i's elements [2t][g], [2t+1][g] (g = lane / 4, t =
// lane % 4).  With rows k and columns m it yields the A fragment of A =
// that matrix transposed.
__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&a)[4], const __nv_bfloat16* row) {
  const uint32_t p = static_cast<uint32_t>(__cvta_generic_to_shared(row));
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];"
               : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
               : "r"(p)
               : "memory");
}

// ---- row chunks through cp.async
//
// A chunk is `rows` rows of n <= KC contiguous bf16, row r at src + r ld
// in global memory, copied to row r of a shared tile whose row stride XS
// is a multiple of 8.  U is the copy unit in bytes: 16, 8 or 4 where every
// row start is U-aligned (cp.async.cg for 16, .ca for 8 and 4); U = 2
// where a row may start at an odd bf16 (an odd row length or column
// offset): each row is copied in 4-byte pieces from its 4-byte aligned
// start, so its data lands row_shift<2>(its address) elements into its
// shared row, and its A fragments are read as 2-byte halves.  Bytes of a
// piece past the row's data are zero-filled (cp.async's src-size) and
// never read: chunk_a zeroes what lies past n by selects.

// cp.async of `bytes` (<= B) from src, the rest of the B zero-filled;
// src and dst B-aligned
template <int B>
__device__ __forceinline__ void cp_async_zfill(void* dst, const void* src, int bytes) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  if constexpr (B == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(d), "l"(src), "r"(bytes)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;" ::"r"(d), "l"(src), "n"(B),
                 "r"(bytes)
                 : "memory");
}

// the bf16 offset of a row's data in its shared row: 1 where U = 2 and the
// row starts at an odd bf16 address, else 0
template <int U>
__device__ __forceinline__ int row_shift(const __nv_bfloat16* p) {
  if constexpr (U == 2)
    return static_cast<int>(reinterpret_cast<uintptr_t>(p) >> 1 & 1);
  else
    return 0;
}

// the cp.asyncs of one chunk (see above), `threads` threads from t
template <int U, int KC>
__device__ __forceinline__ void copy_rows(__nv_bfloat16* dst, int XS, const __nv_bfloat16* src,
                                          size_t ld, int rows, int n, int t, int threads) {
  constexpr int B = U == 2 ? 4 : U;          // bytes a cp.async
  constexpr int P = 2 * KC / B + (U == 2);   // pieces a row
  for (int i = t; i < rows * P; i += threads) {
    const int r = i / P, p = i % P;
    const __nv_bfloat16* row = src + r * ld;
    const int sh = row_shift<U>(row);
    const int avail = 2 * (n + sh) - p * B;  // bytes of the row's data from this piece on
    if (avail > 0)
      cp_async_zfill<B>(dst + r * XS + p * (B / 2),
                        reinterpret_cast<const char*>(row - sh) + p * B, avail < B ? avail : B);
  }
}

// The A fragment of the k16 step at column kk of a shared chunk (rows 16
// warp .. + 15; copy_rows), zeros at columns n and past.  U >= 4: one
// ldmatrix.x4 (the rows 16-byte aligned) and selects (n is even there);
// U = 2: 2-byte halves of rows whose data starts sh0 (row g) and sh8 (row
// g + 8) elements in.
template <int U>
__device__ __forceinline__ void chunk_a(uint32_t (&a)[4], const __nv_bfloat16* tile, int XS,
                                        int kk, int n, int warp, int lane, int sh0, int sh8) {
  const int k = kk + 2 * (lane & 3);
  if constexpr (U == 2) {
    const __nv_bfloat16* p0 = tile + (warp * 16 + (lane >> 2)) * XS + sh0;
    const __nv_bfloat16* p8 = p0 + 8 * XS + sh8 - sh0;
    auto h = [&](const __nv_bfloat16* p, int c) { return c < n ? bits(p[c]) : 0u; };
    a[0] = pack(h(p0, k), h(p0, k + 1));
    a[1] = pack(h(p8, k), h(p8, k + 1));
    a[2] = pack(h(p0, k + 8), h(p0, k + 9));
    a[3] = pack(h(p8, k + 8), h(p8, k + 9));
  } else {
    ldsm_x4(a, tile + (warp * 16 + (lane & 7) + (lane >> 3 & 1) * 8) * XS + kk + (lane >> 4) * 8);
    if (k >= n) a[0] = a[1] = 0u;
    if (k + 8 >= n) a[2] = a[3] = 0u;
  }
}

}  // namespace wgmma_bf16
