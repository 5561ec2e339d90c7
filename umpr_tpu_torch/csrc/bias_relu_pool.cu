// K5 bias_relu_pool: bias + ReLU + 2x2/2 max-pool over a conv's raw output,
// with the window's first argmax.
//
// For x (N, H, W, C) NHWC f32 (H, W even), b (C,) f32 and each pooled
// position (n, h, w, c):
//   v_k = x[n, 2h + k/2, 2w + k%2, c] + b[c]          k = 0..3
//   a_k = v_k < 0 ? 0 : v_k                          (ReLU; NaN stays NaN)
//   yp  = max(max(a_0, a_1), max(a_2, a_3))          (NaN propagates)
//   idx = first k with a_k >= yp, else 3              (ties -> lowest k)
// yp is f32 (N, H/2, W/2, C); idx is uint8 of the same shape.
//
// bf16 IO (bias_relu_pool_bf16, --compute_dtype bfloat16): x, b and yp
// bf16.  The add rounds in the input type, as the TPU kernel's does
// (pool_pallas.py:67-70): x + b is formed in f32 and rounded once to bf16,
// which is the bf16 add's own rounding (the f32 sum of two bf16 values
// loses no bit that the bf16 rounding keeps).  ReLU, the max and the
// first-match compares run on those bf16 values in f32, exactly, and yp is
// stored as bf16 (exact).
//
// Replaces the TPU kernel B8a of umpr_tpu/ops/pool_pallas.py, _forward /
// _fwd_kernel (pallas_call at :127).  Same function; idx is stored as
// uint8 instead of bf16 (the same four values in half the bytes).  The add
// rounds in f32, the input type, as the TPU kernel's does.  The plain
// version is ops/pool_cuda.bias_relu_pool_ref.
//
// What bounds it on an H100: bytes.  It reads x once and writes yp and
// idx once, 5 operations per input element.  At VGG block 1 (B=64, 224 px:
// x = (64, 224, 224, 64), 822 MB) that is 822 + 206 + 51 MB = 1.08 GB, ~0.32
// ms at 3.35 TB/s, against 1.0 GFLOP (~15 us at 67 TFLOP/s f32); block 2
// (64, 112, 112, 128) is half of it.  In bf16 the bytes are 2.75/5.25 of
// those.
//
// Design: a thread owns V channels of one pooled position at a time: one
// 16-byte access (V = 4 for f32, 8 for bf16; pool_vec.cuh) when C % V ==
// 0 and the pointers are 16-byte aligned, else V = 1.  threadIdx.x walks
// the channel vectors of a position, so a warp's loads of one window
// corner cover contiguous channel runs; threadIdx.y walks positions.  Block b owns the `pix_per_block`
// consecutive pooled positions from b * pix_per_block.  The TPU's grid of
// row tiles becomes this flat split; nothing carries between blocks.
// TMA and shared-memory staging are later work.

#include "pool_vec.cuh"

namespace {

using pool_vec::bf16;

__device__ __forceinline__ float relu_keep_nan(float v) { return v < 0.f ? 0.f : v; }

// max that returns NaN when either side is NaN (torch.maximum's rule)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// v rounded to T's precision, in f32
template <class T>
__device__ __forceinline__ float round_to(float v) {
  if constexpr (std::is_same<T, bf16>::value)
    return __bfloat162float(__float2bfloat16_rn(v));
  else
    return v;
}

template <class T, int V>
__global__ void bias_relu_pool_kernel(const T* __restrict__ x, const T* __restrict__ b,
                                      T* __restrict__ yp, uint8_t* __restrict__ idx,
                                      long long pixels, int W2, int C, int pix_per_block) {
  const int c0 = threadIdx.x * V;
  float bias[V];
  pool_vec::load<T, V>(b + c0, bias);
  const size_t row = (size_t)2 * W2 * C;  // one input row of W = 2*W2 pixels
  const long long p_begin = (long long)blockIdx.x * pix_per_block;
  const long long p_end = min(pixels, p_begin + pix_per_block);
  for (long long p = p_begin + threadIdx.y; p < p_end; p += blockDim.y) {
    // p = (n*H2 + h)*W2 + w; the window's top row is input row 2*(n*H2 + h)
    const long long w = p % W2;
    const long long nh = p / W2;
    const size_t top = (size_t)(2 * nh) * row + (size_t)(2 * w) * C + c0;
    float v0[V], v1[V], v2[V], v3[V];
    pool_vec::load<T, V>(x + top, v0);
    pool_vec::load<T, V>(x + top + C, v1);
    pool_vec::load<T, V>(x + top + row, v2);
    pool_vec::load<T, V>(x + top + row + C, v3);
    float m[V];
    uint8_t k[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float a0 = relu_keep_nan(round_to<T>(v0[j] + bias[j]));
      const float a1 = relu_keep_nan(round_to<T>(v1[j] + bias[j]));
      const float a2 = relu_keep_nan(round_to<T>(v2[j] + bias[j]));
      const float a3 = relu_keep_nan(round_to<T>(v3[j] + bias[j]));
      m[j] = max_nan(max_nan(a0, a1), max_nan(a2, a3));
      k[j] = a0 >= m[j] ? 0 : a1 >= m[j] ? 1 : a2 >= m[j] ? 2 : 3;
    }
    const size_t out = (size_t)p * C + c0;
    pool_vec::store<T, V>(yp + out, m);
    pool_vec::store_idx<V>(idx + out, k);
  }
}

template <class T>
int run(const T* x, const T* b, T* yp, uint8_t* idx, long long pixels, int W2, int C, int vec,
        int block_y, int pix_per_block, void* stream) {
  constexpr int VEC = pool_vec::kVec<T>;
  if (pixels == 0 || C == 0) return 0;
  if ((vec != 1 && vec != VEC) || C % vec != 0 || block_y <= 0 || pix_per_block <= 0 ||
      (long long)(C / vec) * block_y > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (pixels + pix_per_block - 1) / pix_per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(C / vec, block_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == VEC)
    bias_relu_pool_kernel<T, VEC><<<(unsigned)blocks, block, 0, s>>>(x, b, yp, idx, pixels, W2,
                                                                     C, pix_per_block);
  else
    bias_relu_pool_kernel<T, 1><<<(unsigned)blocks, block, 0, s>>>(x, b, yp, idx, pixels, W2,
                                                                   C, pix_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x (N, 2*H2, 2*W2, C), b (C,) -> yp (N, H2, W2, C), idx (same) uint8;
// contiguous, on the device; x, b and yp f32 (bias_relu_pool) or bf16
// (bias_relu_pool_bf16).  pixels = N*H2*W2; vec is 16 / sizeof(T) (C a
// multiple of it, all pointers 16-byte aligned) or 1; the block is
// (C/vec, block_y) threads and owns pix_per_block positions.  Launches on
// `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int bias_relu_pool(const float* x, const float* b, float* yp, uint8_t* idx,
                              long long pixels, int W2, int C, int vec, int block_y,
                              int pix_per_block, void* stream) {
  return run(x, b, yp, idx, pixels, W2, C, vec, block_y, pix_per_block, stream);
}

extern "C" int bias_relu_pool_bf16(const bf16* x, const bf16* b, bf16* yp, uint8_t* idx,
                                   long long pixels, int W2, int C, int vec, int block_y,
                                   int pix_per_block, void* stream) {
  return run(x, b, yp, idx, pixels, W2, C, vec, block_y, pix_per_block, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
