// K7 affinity_tiles: the tiles of the R-Net affinity matrix, reduced to
// max / first-argmax partials without ever storing the matrix.
//
// For one sample b, T = I @ M (P, D) and U (P, D), f32, and the exists mask
// e (P,):
//   A[p, q]   = tanh(T[p] . U[q])                       p: item rows, q: user columns
//   row half  (final):   rowmax[p]  = max_q  where(e[q], A[p, q], -1e30)
//                        amax_i[p]  = the first q reaching it
//   col half (partial):  for each 128-row tile r of p:
//                        colpart[r, q] = max_{p in r} where(e[p], A[p, q], -1e30)
//                        colidx[r, q]  = the first p reaching it
// K8 (affinity_finish.cu) combines the column partials over r.  "First"
// and "max" follow torch.argmax / torch.amax: NaN beats every number and
// propagates, and a tie goes to the lowest index.  Under that total order
// the merge of two candidates does not depend on the order of merging, so
// the result is the same on every run.
//
// Replaces the two TPU kernels of umpr_tpu/ops/attention_pallas.py that
// compute the same function with the same residual contract:
//   B9  _tiled_forward / _tiled_kernel (pallas_call at :415), the column-
//       tiled flash-style kernel that umpr_tpu/ops/attention.py routes to
//       above 4 GiB of (B, P, P) f32, and
//   B10 _forward / _fwd_kernel (pallas_call at :167), the whole-P x P-tile
//       kernel taken with use_pallas=True.
// T = I @ M stays a torch.matmul outside, as the JAX package leaves it to
// XLA.  Not carried over: the TPU's online softmax across column tiles
// (K8 has the final maxima, so its softmax is exact in two passes), the
// 128-lane padding of P and D, and the _tile_q VMEM budget.
//
// What bounds it on an H100: operations.  At B=64, P=8192, D=128 the
// products are 2*B*P^2*D = 1.10e12 f32 FLOP, 16.4 ms at the 67 TFLOP/s of
// the CUDA cores (TF32 would break f32 parity), plus B*P^2 = 4.3e9 tanhf;
// T and U are 537 MB together and the partials 273 MB, under 0.3 ms of HBM.
//
// Design: one block per (128-row tile, sample).  It walks the column tiles
// in order; each 128 x 128 tile of T . U^T is a shared-memory SGEMM (depth
// in steps of 16, 8 x 8 outputs per thread on the rows {ty*4 + i, 64 +
// ty*4 + i} and columns {tx*4 + j, 64 + tx*4 + j}, read as float4).  The
// epilogue takes tanhf (the accurate one: -use_fast_math's tanh.approx
// would miss the 1e-5 gates), then reduces each row over the tile's
// columns with warp shuffles into running per-row maxima held in
// registers, and each column over the block's rows through shared memory
// into one partial per (row tile, column).  The matrix never reaches
// device memory.  Two blocks share an SM (launch bounds), so that one
// block's global-to-shared loads and barriers overlap the other's
// products; one block per SM (over 150 registers) gave the same bits
// more slowly (PERF.md).  3xTF32 wgmma and TMA staging are later work.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BR = 128;  // rows p per block
constexpr int BC = 128;  // columns q per column tile
constexpr int BK = 16;   // depth per shared-memory stage
constexpr int TX = 16;   // column lanes
constexpr int TY = 16;   // row lanes
constexpr int THREADS = TX * TY;
constexpr int WARPS = THREADS / 32;
constexpr int TM = 8;    // rows per thread
constexpr int TN = 8;    // columns per thread
constexpr int PAD = 4;   // keeps rows 16-byte aligned, halves store conflicts
constexpr int MIN_BLOCKS = 2;  // per SM: caps registers at 128 (no spills), so
                               // one block's loads overlap the other's products
constexpr float NEG_INF = -1e30f;  // the mask value of ops/masking.py

// does candidate (v, i) beat (cv, ci)?  NaN first, then the larger value,
// then the lower index: a total order, so merging is order-free
__device__ __forceinline__ bool better(float v, int i, float cv, int ci) {
  const bool n = v != v, cn = cv != cv;
  if (n != cn) return n;
  if (!n && v != cv) return v > cv;
  return i < ci;
}

__device__ __forceinline__ void merge(float& v, int& i, float ov, int oi) {
  if (better(ov, oi, v, i)) {
    v = ov;
    i = oi;
  }
}

// this thread's i-th row and j-th column within a tile
__device__ __forceinline__ int row_of(int ty, int i) { return (i / 4) * 64 + ty * 4 + (i % 4); }
__device__ __forceinline__ int col_of(int tx, int j) { return (j / 4) * 64 + tx * 4 + (j % 4); }

__global__ void __launch_bounds__(THREADS, MIN_BLOCKS)
affinity_tiles_kernel(const float* __restrict__ T, const float* __restrict__ U,
                      const uint8_t* __restrict__ exists, float* __restrict__ col_val,
                      int* __restrict__ col_idx, float* __restrict__ row_val,
                      int* __restrict__ row_idx, int P, int D) {
  __shared__ __align__(16) float Ts[BK][BR + PAD];  // T rows of the block, depth-major
  __shared__ __align__(16) float Us[BK][BC + PAD];  // U rows of the column tile
  __shared__ float cbuf_v[WARPS][BC];               // per-warp column partials
  __shared__ int cbuf_i[WARPS][BC];

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX, warp = tid / 32;
  const int rt = blockIdx.x, b = blockIdx.y, R = gridDim.x;
  const int row0 = rt * BR;
  const float* Tb = T + (size_t)b * P * D;
  const float* Ub = U + (size_t)b * P * D;

  bool row_in[TM], row_ex[TM];
  float rbest_v[TM];
  int rbest_i[TM];
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int p = row0 + row_of(ty, i);
    row_in[i] = p < P;
    row_ex[i] = row_in[i] && exists[p];
    rbest_v[i] = -INFINITY;  // empty: loses to every candidate
    rbest_i[i] = INT_MAX;
  }

  for (int col0 = 0; col0 < P; col0 += BC) {
    float acc[TM][TN];
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

    for (int k0 = 0; k0 < D; k0 += BK) {
      for (int e = tid; e < BR * BK; e += THREADS) {
        const int r = e / BK, c = e % BK, k = k0 + c;
        const int p = row0 + r, q = col0 + r;
        Ts[c][r] = (p < P && k < D) ? Tb[(size_t)p * D + k] : 0.f;
        Us[c][r] = (q < P && k < D) ? Ub[(size_t)q * D + k] : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < BK; ++kk) {
        const float4 a0 = *reinterpret_cast<const float4*>(&Ts[kk][ty * 4]);
        const float4 a1 = *reinterpret_cast<const float4*>(&Ts[kk][64 + ty * 4]);
        const float4 b0 = *reinterpret_cast<const float4*>(&Us[kk][tx * 4]);
        const float4 b1 = *reinterpret_cast<const float4*>(&Us[kk][64 + tx * 4]);
        const float a[TM] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
        const float bv[TN] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
        for (int i = 0; i < TM; ++i)
#pragma unroll
          for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
      }
      __syncthreads();
    }

    bool col_in[TN], col_ex[TN];
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int q = col0 + col_of(tx, j);
      col_in[j] = q < P;
      col_ex[j] = col_in[j] && exists[q];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int j = 0; j < TN; ++j) acc[i][j] = tanhf(acc[i][j]);

    // row half: each row's best over this tile's existing columns, across
    // the 16 column lanes of the half-warp, into the running maxima
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      float v = -INFINITY;
      int ix = INT_MAX;
#pragma unroll
      for (int j = 0; j < TN; ++j)
        if (col_in[j]) merge(v, ix, col_ex[j] ? acc[i][j] : NEG_INF, col0 + col_of(tx, j));
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1) {
        const float ov = __shfl_xor_sync(0xffffffffu, v, off);
        const int oi = __shfl_xor_sync(0xffffffffu, ix, off);
        merge(v, ix, ov, oi);
      }
      merge(rbest_v[i], rbest_i[i], v, ix);
    }

    // column half: each column's best over the block's existing rows; the
    // two row lanes of a warp by shuffle, the eight warps in shared memory
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      float v = -INFINITY;
      int ix = INT_MAX;
#pragma unroll
      for (int i = 0; i < TM; ++i)
        if (row_in[i]) merge(v, ix, row_ex[i] ? acc[i][j] : NEG_INF, row0 + row_of(ty, i));
      const float ov = __shfl_xor_sync(0xffffffffu, v, 16);
      const int oi = __shfl_xor_sync(0xffffffffu, ix, 16);
      merge(v, ix, ov, oi);
      if (ty % 2 == 0) {
        cbuf_v[warp][col_of(tx, j)] = v;
        cbuf_i[warp][col_of(tx, j)] = ix;
      }
    }
    __syncthreads();
    if (tid < BC && col0 + tid < P) {
      float v = cbuf_v[0][tid];
      int ix = cbuf_i[0][tid];
#pragma unroll
      for (int w = 1; w < WARPS; ++w) merge(v, ix, cbuf_v[w][tid], cbuf_i[w][tid]);
      const size_t o = ((size_t)b * R + rt) * P + col0 + tid;
      col_val[o] = v;
      col_idx[o] = ix;
    }
    // the next tile's first __syncthreads orders these reads of cbuf
    // before its writes
  }

  if (tx == 0) {
#pragma unroll
    for (int i = 0; i < TM; ++i) {
      if (!row_in[i]) continue;
      const size_t o = (size_t)b * P + row0 + row_of(ty, i);
      row_val[o] = rbest_v[i];
      row_idx[o] = rbest_i[i];
    }
  }
}

}  // namespace

// T, U (B, P, D) f32, exists (P,) uint8 0/1 -> col_val, col_idx (B, R, P)
// with R = ceil(P / 128), row_val, row_idx (B, P); f32 / int32, contiguous,
// on the device.  Launches on `stream` and returns the launch's
// cudaError_t (0 = success).
extern "C" int affinity_tiles(const float* T, const float* U, const uint8_t* exists,
                              float* col_val, int* col_idx, float* row_val, int* row_idx,
                              int B, int P, int D, void* stream) {
  if (B == 0 || P == 0) return 0;
  if (D <= 0 || B > 65535) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((P + BR - 1) / BR, B);
  affinity_tiles_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      T, U, exists, col_val, col_idx, row_val, row_idx, P, D);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
