// K6 bias_relu_pool_bwd: the backward of K5.
//
// For dyp, yp (N, H2, W2, C) f32 and idx (same) uint8 from K5:
//   g = yp > 0 ? dyp : 0                             (the ReLU mask)
//   dx[n, 2h + k/2, 2w + k%2, c] = idx == k ? g : 0   k = 0..3, full size
//   db[c] = sum over n, h, w of g
// dx is f32 (N, 2*H2, 2*W2, C) with its zeros written; db is f32 (C,).
//
// bf16 IO (bias_relu_pool_bwd_bf16, --compute_dtype bfloat16): dyp, yp and
// dx bf16.  dx is exact: each entry is dyp or 0.  db is the f32 sum of the
// masked g, as the TPU kernel's (pool_pallas.py:109); the partials stay
// f32 and the wrapper rounds only the final sum to dyp's type (:189).
//
// Replaces the TPU kernel B8b of umpr_tpu/ops/pool_pallas.py, _backward /
// _bwd_kernel (pallas_call at :152).  The TPU summed db in VMEM scratch
// across its sequential grid.  Here block b writes its own (C,) partial
// db_part[b], summed afterwards in a fixed order by the wrapper: no float
// atomics, so repeated runs give the same bits.  The plain version is
// ops/pool_cuda.bias_relu_pool_bwd_ref.
//
// What bounds it on an H100: bytes.  It reads dyp, yp and idx once and
// writes dx once, 8 operations per pooled element.  At VGG block 1 (B=64,
// 224 px, C=64): 206 + 206 + 51 MB read, 822 MB written, ~1.29 GB or
// ~0.38 ms at 3.35 TB/s; block 2 half of it.
//
// Design: K5's layout.  A thread owns V channels (one 16-byte access, V
// = 4 for f32 and 8 for bf16, when C % V == 0 and the pointers are
// 16-byte aligned; else V = 1) of one pooled position at a time and
// writes that window's four dx corners; it keeps its channels' db sum in
// registers over its positions, in order.  At the end the block's
// threadIdx.y rows are added in order through shared memory and thread
// row 0 writes the block's partial.

#include "pool_vec.cuh"

namespace {

using pool_vec::bf16;

template <class T, int V>
__global__ void bias_relu_pool_bwd_kernel(const T* __restrict__ dyp,
                                          const uint8_t* __restrict__ idx,
                                          const T* __restrict__ yp, T* __restrict__ dx,
                                          float* __restrict__ db_part, long long pixels, int W2,
                                          int C, int pix_per_block) {
  extern __shared__ float rows[];  // (blockDim.y, C) per-row db sums
  const int c0 = threadIdx.x * V;
  const size_t row = (size_t)2 * W2 * C;
  const long long p_begin = (long long)blockIdx.x * pix_per_block;
  const long long p_end = min(pixels, p_begin + pix_per_block);
  float acc[V];
#pragma unroll
  for (int j = 0; j < V; ++j) acc[j] = 0.f;
  for (long long p = p_begin + threadIdx.y; p < p_end; p += blockDim.y) {
    const size_t in = (size_t)p * C + c0;
    float d[V], y[V];
    uint8_t k[V];
    pool_vec::load<T, V>(dyp + in, d);
    pool_vec::load<T, V>(yp + in, y);
    pool_vec::load_idx<V>(idx + in, k);
    float o0[V], o1[V], o2[V], o3[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float g = y[j] > 0.f ? d[j] : 0.f;
      acc[j] += g;
      o0[j] = k[j] == 0 ? g : 0.f;
      o1[j] = k[j] == 1 ? g : 0.f;
      o2[j] = k[j] == 2 ? g : 0.f;
      o3[j] = k[j] == 3 ? g : 0.f;
    }
    const long long w = p % W2;
    const long long nh = p / W2;
    const size_t top = (size_t)(2 * nh) * row + (size_t)(2 * w) * C + c0;
    pool_vec::store<T, V>(dx + top, o0);
    pool_vec::store<T, V>(dx + top + C, o1);
    pool_vec::store<T, V>(dx + top + row, o2);
    pool_vec::store<T, V>(dx + top + row + C, o3);
  }
#pragma unroll
  for (int j = 0; j < V; ++j) rows[threadIdx.y * C + c0 + j] = acc[j];
  __syncthreads();
  if (threadIdx.y != 0) return;
#pragma unroll
  for (int j = 0; j < V; ++j) {
    float s = 0.f;
    for (int r = 0; r < (int)blockDim.y; ++r) s += rows[r * C + c0 + j];
    db_part[(size_t)blockIdx.x * C + c0 + j] = s;
  }
}

template <class T>
int run(const T* dyp, const uint8_t* idx, const T* yp, T* dx, float* db_part, long long pixels,
        int W2, int C, int vec, int block_y, int pix_per_block, void* stream) {
  constexpr int VEC = pool_vec::kVec<T>;
  if (pixels == 0 || C == 0) return 0;
  if ((vec != 1 && vec != VEC) || C % vec != 0 || block_y <= 0 || pix_per_block <= 0 ||
      (long long)(C / vec) * block_y > 1024)
    return static_cast<int>(cudaErrorInvalidValue);
  const long long blocks = (pixels + pix_per_block - 1) / pix_per_block;
  const size_t smem = (size_t)block_y * C * sizeof(float);
  if (blocks > 0x7fffffffLL || smem > 48 * 1024) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 block(C / vec, block_y);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (vec == VEC)
    bias_relu_pool_bwd_kernel<T, VEC><<<(unsigned)blocks, block, smem, s>>>(
        dyp, idx, yp, dx, db_part, pixels, W2, C, pix_per_block);
  else
    bias_relu_pool_bwd_kernel<T, 1><<<(unsigned)blocks, block, smem, s>>>(
        dyp, idx, yp, dx, db_part, pixels, W2, C, pix_per_block);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dyp, yp (N, H2, W2, C), idx (same) uint8 -> dx (N, 2*H2, 2*W2, C) and
// db_part (ceil(pixels / pix_per_block), C) f32; contiguous, on the
// device; dyp, yp and dx f32 (bias_relu_pool_bwd) or bf16
// (bias_relu_pool_bwd_bf16).  pixels = N*H2*W2; vec, block_y and
// pix_per_block as for K5.  Launches on `stream` and returns the launch's
// cudaError_t (0 = success).
extern "C" int bias_relu_pool_bwd(const float* dyp, const uint8_t* idx, const float* yp,
                                  float* dx, float* db_part, long long pixels, int W2, int C,
                                  int vec, int block_y, int pix_per_block, void* stream) {
  return run(dyp, idx, yp, dx, db_part, pixels, W2, C, vec, block_y, pix_per_block, stream);
}

extern "C" int bias_relu_pool_bwd_bf16(const bf16* dyp, const uint8_t* idx, const bf16* yp,
                                       bf16* dx, float* db_part, long long pixels, int W2,
                                       int C, int vec, int block_y, int pix_per_block,
                                       void* stream) {
  return run(dyp, idx, yp, dx, db_part, pixels, W2, C, vec, block_y, pix_per_block, stream);
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
