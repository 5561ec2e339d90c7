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
// (64, 112, 112, 128) is half of it.
//
// Design: a thread owns V = 4 channels (one float4, when C % 4 == 0 and
// the pointers are 16-byte aligned; else V = 1) of one pooled position at
// a time.  threadIdx.x walks the channel vectors of a position, so a
// warp's loads of one window corner cover contiguous channel runs;
// threadIdx.y walks positions.  Block b owns the `pix_per_block`
// consecutive pooled positions from b * pix_per_block.  The TPU's grid of
// row tiles becomes this flat split; nothing carries between blocks.
// TMA and shared-memory staging are later work.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__device__ __forceinline__ float relu_keep_nan(float v) { return v < 0.f ? 0.f : v; }

// max that returns NaN when either side is NaN (torch.maximum's rule)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

template <int V>
__device__ __forceinline__ void load(const float* p, float (&v)[V]) {
  if constexpr (V == 4) {
    const float4 t = *reinterpret_cast<const float4*>(p);
    v[0] = t.x; v[1] = t.y; v[2] = t.z; v[3] = t.w;
  } else {
    v[0] = *p;
  }
}

template <int V>
__device__ __forceinline__ void store(float* p, const float (&v)[V]) {
  if constexpr (V == 4) {
    *reinterpret_cast<float4*>(p) = make_float4(v[0], v[1], v[2], v[3]);
  } else {
    *p = v[0];
  }
}

template <int V>
__global__ void bias_relu_pool_kernel(const float* __restrict__ x, const float* __restrict__ b,
                                      float* __restrict__ yp, uint8_t* __restrict__ idx,
                                      long long pixels, int W2, int C, int pix_per_block) {
  const int c0 = threadIdx.x * V;
  float bias[V];
  load<V>(b + c0, bias);
  const size_t row = (size_t)2 * W2 * C;  // one input row of W = 2*W2 pixels
  const long long p_begin = (long long)blockIdx.x * pix_per_block;
  const long long p_end = min(pixels, p_begin + pix_per_block);
  for (long long p = p_begin + threadIdx.y; p < p_end; p += blockDim.y) {
    // p = (n*H2 + h)*W2 + w; the window's top row is input row 2*(n*H2 + h)
    const long long w = p % W2;
    const long long nh = p / W2;
    const size_t top = (size_t)(2 * nh) * row + (size_t)(2 * w) * C + c0;
    float v0[V], v1[V], v2[V], v3[V];
    load<V>(x + top, v0);
    load<V>(x + top + C, v1);
    load<V>(x + top + row, v2);
    load<V>(x + top + row + C, v3);
    float m[V];
    uint8_t k[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float a0 = relu_keep_nan(v0[j] + bias[j]);
      const float a1 = relu_keep_nan(v1[j] + bias[j]);
      const float a2 = relu_keep_nan(v2[j] + bias[j]);
      const float a3 = relu_keep_nan(v3[j] + bias[j]);
      m[j] = max_nan(max_nan(a0, a1), max_nan(a2, a3));
      k[j] = a0 >= m[j] ? 0 : a1 >= m[j] ? 1 : a2 >= m[j] ? 2 : 3;
    }
    const size_t out = (size_t)p * C + c0;
    store<V>(yp + out, m);
    if constexpr (V == 4) {
      *reinterpret_cast<uchar4*>(idx + out) = make_uchar4(k[0], k[1], k[2], k[3]);
    } else {
      idx[out] = k[0];
    }
  }
}

}  // namespace

// x (N, 2*H2, 2*W2, C), b (C,) -> yp (N, H2, W2, C) f32, idx (same) uint8;
// contiguous, on the device.  pixels = N*H2*W2; vec is 4 (C % 4 == 0, all
// pointers 16-byte aligned) or 1; the block is (C/vec, block_y) threads
// and owns pix_per_block positions.  Launches on `stream` and returns the
// launch's cudaError_t (0 = success).
extern "C" int bias_relu_pool(const float* x, const float* b, float* yp, uint8_t* idx,
                              long long pixels, int W2, int C, int vec, int block_y,
                              int pix_per_block, void* stream) {
  if (pixels == 0 || C == 0) return 0;
  if ((vec != 1 && vec != 4) || C % vec != 0 || block_y <= 0 || pix_per_block <= 0 ||
      (long long)(C / vec) * block_y > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (pixels + pix_per_block - 1) / pix_per_block;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(C / vec, block_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == 4)
    bias_relu_pool_kernel<4><<<(unsigned)blocks, block, 0, s>>>(x, b, yp, idx, pixels, W2, C,
                                                                 pix_per_block);
  else
    bias_relu_pool_kernel<1><<<(unsigned)blocks, block, 0, s>>>(x, b, yp, idx, pixels, W2, C,
                                                                 pix_per_block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
