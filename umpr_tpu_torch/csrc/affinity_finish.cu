// K8 affinity_finish: the R-Net affinity attention from K7's partials.
//
// Per sample b, from K7 (affinity_tiles.cu): the column partials
// col_val/col_idx (R, P), one per 128-row tile, and the final row maxima
// row_val (P,); the exists mask e (P,); U = gru_u and I = gru_i (P, D):
//   colmax[q], amax_u[q] = the best of col_val[r, q] over r (NaN first, then
//                          the larger value, then the lower index: the
//                          first argmax row of the whole column)
//   soft_u = masked_softmax(colmax, e)   soft_i = masked_softmax(row_val, e)
//   atte_u = soft_u^T U                  atte_i = soft_i^T I
// masked_softmax is ops/masking.py's: masked scores become -1e30, the max
// is taken over all P (NaN propagates), exp(s - max) is kept only where e,
// and divided by its sum.
//
// Replaces, with K7, the TPU kernels B9 (_tiled_forward, pallas_call at
// umpr_tpu/ops/attention_pallas.py:415) and B10 (_forward, :167).  B9 ran
// an online softmax across its column tiles and rescaled su outside the
// kernel; here the maxima are final before any exp, so both softmaxes are
// exact, in two passes over the (P,) scores.  atte_i is part of the kernel
// (B9 left it to one XLA matmul).
//
// What bounds it on an H100: bytes.  At B=64, P=8192, D=128 it reads the
// partials (268 MB), row_val, U and I (537 MB) once and writes (B, P)
// vectors: about 0.25 ms at 3.35 TB/s, against 0.3 GFLOP.
//
// Design: one block per sample, nothing carried between blocks and no
// atomics.  Every sum has a fixed order -- each thread adds its strided
// elements in turn, warps reduce by a fixed shuffle tree, the warps' sums
// are added in warp order -- so the result is the same bits on every run.
// The attended vectors: warp w takes positions p = w, w + 16, ...; lane l
// the columns l, l + 32, l + 64, l + 96 of each 128-wide chunk of D, so a
// warp reads whole 512-byte row pieces.  One block per sample leaves SMs
// idle at B < 132; that costs little beside K7.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 512;
constexpr int WARPS = THREADS / 32;
constexpr int DCHUNK = 128;  // columns of D per pass: 4 per lane
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ bool better(float v, int i, float cv, int ci) {
  const bool n = v != v, cn = cv != cv;
  if (n != cn) return n;
  if (!n && v != cv) return v > cv;
  return i < ci;
}

// max that returns NaN when either side is NaN (torch.amax's rule)
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a > b || a != a) ? a : b;
}

// block-wide max / sum in a fixed order; every thread gets the same bits
__device__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v = max_nan(v, __shfl_down_sync(0xffffffffu, v, off));
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WARPS; ++w) r = max_nan(r, red[w]);
  __syncthreads();
  return r;
}

__device__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(0xffffffffu, v, off);
  if (threadIdx.x % 32 == 0) red[threadIdx.x / 32] = v;
  __syncthreads();
  float r = red[0];
  for (int w = 1; w < WARPS; ++w) r += red[w];
  __syncthreads();
  return r;
}

// soft = masked_softmax(score, e) and atte = soft^T X for one sample
__device__ void softmax_attend(const float* __restrict__ score, const uint8_t* __restrict__ e,
                               const float* __restrict__ X, float* __restrict__ soft,
                               float* __restrict__ atte, int P, int D, float* red,
                               float (*part)[DCHUNK]) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  float m = -INFINITY;
  for (int q = tid; q < P; q += THREADS) m = max_nan(m, e[q] ? score[q] : NEG_INF);
  m = block_max(m, red);
  float l = 0.f;
  for (int q = tid; q < P; q += THREADS) {
    const float ex = e[q] ? expf(score[q] - m) : 0.f;
    soft[q] = ex;
    l += ex;
  }
  l = block_sum(l, red);  // its __syncthreads make soft[] visible to the block
  for (int q = tid; q < P; q += THREADS) soft[q] = soft[q] / l;
  __syncthreads();

  for (int d0 = 0; d0 < D; d0 += DCHUNK) {
    float acc[DCHUNK / 32];
#pragma unroll
    for (int k = 0; k < DCHUNK / 32; ++k) acc[k] = 0.f;
#pragma unroll 4
    for (int p = warp; p < P; p += WARPS) {
      const float s = soft[p];
      const float* row = X + (size_t)p * D + d0;
#pragma unroll
      for (int k = 0; k < DCHUNK / 32; ++k) {
        const int d = lane + 32 * k;
        if (d0 + d < D) acc[k] = fmaf(s, row[d], acc[k]);
      }
    }
#pragma unroll
    for (int k = 0; k < DCHUNK / 32; ++k) part[warp][lane + 32 * k] = acc[k];
    __syncthreads();
    if (tid < DCHUNK && d0 + tid < D) {
      float t = part[0][tid];
      for (int w = 1; w < WARPS; ++w) t += part[w][tid];
      atte[d0 + tid] = t;
    }
    __syncthreads();
  }
}

__global__ void __launch_bounds__(THREADS)
affinity_finish_kernel(const float* __restrict__ col_val, const int* __restrict__ col_idx,
                       const float* __restrict__ row_val, const uint8_t* __restrict__ exists,
                       const float* __restrict__ U, const float* __restrict__ I,
                       float* __restrict__ soft_u, float* __restrict__ soft_i,
                       float* __restrict__ atte_u, float* __restrict__ atte_i,
                       float* __restrict__ colmax, int* __restrict__ amax_u, int R, int P,
                       int D) {
  __shared__ float red[WARPS];
  __shared__ float part[WARPS][DCHUNK];
  const int b = blockIdx.x;
  const size_t bp = (size_t)b * P;

  for (int q = threadIdx.x; q < P; q += THREADS) {
    const size_t o = (size_t)b * R * P + q;
    float v = col_val[o];
    int ix = col_idx[o];
    for (int r = 1; r < R; ++r) {
      const float ov = col_val[o + (size_t)r * P];
      const int oi = col_idx[o + (size_t)r * P];
      if (better(ov, oi, v, ix)) {
        v = ov;
        ix = oi;
      }
    }
    colmax[bp + q] = v;
    amax_u[bp + q] = ix;
  }
  __syncthreads();

  softmax_attend(colmax + bp, exists, U + bp * D, soft_u + bp, atte_u + (size_t)b * D, P, D,
                 red, part);
  softmax_attend(row_val + bp, exists, I + bp * D, soft_i + bp, atte_i + (size_t)b * D, P, D,
                 red, part);
}

}  // namespace

// col_val, col_idx (B, R, P), row_val (B, P), exists (P,) uint8 0/1, U, I
// (B, P, D) -> soft_u, soft_i, colmax (B, P) f32, amax_u (B, P) int32,
// atte_u, atte_i (B, D) f32; contiguous, on the device.  Launches on
// `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int affinity_finish(const float* col_val, const int* col_idx, const float* row_val,
                               const uint8_t* exists, const float* U, const float* I,
                               float* soft_u, float* soft_i, float* atte_u, float* atte_i,
                               float* colmax, int* amax_u, int B, int R, int P, int D,
                               void* stream) {
  if (B == 0 || P == 0) return 0;
  if (R <= 0 || D <= 0) return static_cast<int>(cudaErrorInvalidValue);
  affinity_finish_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      col_val, col_idx, row_val, exists, U, I, soft_u, soft_i, atte_u, atte_i, colmax, amax_u,
      R, P, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
