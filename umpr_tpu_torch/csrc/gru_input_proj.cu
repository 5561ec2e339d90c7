// K1 gru_input_proj: the bi-GRU input projection for both directions.
//
//   xg (M, 6H) = x (M, E) @ [W_ih_fwd | W_ih_bwd] (E, 6H) + [b_ih_fwd | b_ih_bwd]
//
// M = N*L sentence-row tokens in true time; gate order per direction is
// [r | z | n].  f32 in, f32 out, f32 accumulation.
//
// Replaces two TPU kernels of umpr_tpu/ops/gru_pallas.py:
//   B3 _pallas_project_fwd / _proj_fwd_kernel (pallas_call at :319), the
//      projection itself, and
//   B5 _pallas_stack_pad / _stack_pad_kernel (pallas_call at :541), which
//      built the stacked [x | x time-flipped | 0-pad] (N, L*128) input
//      stream so one TPU matmul could feed both directions.
// Here x is read once, in true time, for both directions: the backward
// direction's reversed order is K2's loop order, so no stacked or flipped
// copy of x exists.  The TPU's 128-lane padding and interleaved gate layout
// are not reproduced.
//
// What bounds it on an H100: at the UMPR-R shapes (M=51,200, E=50, 6H=384)
// it reads 10.2 MB, writes 78.6 MB and does 2.0 GFLOP of f32 FMA -- about
// 27 us of HBM traffic against 29 us at the 67 TFLOP/s f32 (non-tensor-core)
// peak, so the two are close and operations bound it by a little.  The
// design is a plain shared-memory tiled SGEMM: 64x64 output tiles, K in
// steps of 16, 4x4 outputs per thread, the bias added in the epilogue.
// Columns are interleaved across threads so that neighbouring threads store
// neighbouring addresses.  Tensor cores (TF32 would break f32 parity) and
// TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;  // rows per block tile
constexpr int BN = 64;  // columns per block tile
constexpr int BK = 16;  // depth per shared-memory stage
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // columns per thread
constexpr int TX = BN / TN;  // 16 column lanes
constexpr int TY = BM / TM;  // 16 row lanes
constexpr int THREADS = TX * TY;

__global__ void __launch_bounds__(THREADS)
gru_input_proj_kernel(const float* __restrict__ x, const float* __restrict__ w,
                      const float* __restrict__ b, float* __restrict__ out,
                      int M, int K, int N) {
  __shared__ float xs[BK][BM + 1];  // x tile, transposed; +1 avoids bank conflicts on the store
  __shared__ float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.y * BM;
  const int col0 = blockIdx.x * BN;

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < K; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;
      const int gr = row0 + r, gc = k0 + c;
      xs[c][r] = (gr < M && gc < K) ? x[(size_t)gr * K + gc] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gr = k0 + r, gc = col0 + c;
      ws[r][c] = (gr < K && gc < N) ? w[(size_t)gr * N + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) bv[j] = ws[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int r = row0 + ty + i * TY;
    if (r >= M) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * TX;
      if (c < N) out[(size_t)r * N + c] = acc[i][j] + b[c];
    }
  }
}

}  // namespace

// x (M, K), w (K, N), b (N,), out (M, N): f32, contiguous, on the device.
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int gru_input_proj(const float* x, const float* w, const float* b,
                              float* out, int M, int K, int N, void* stream) {
  if (M == 0 || N == 0) return 0;
  const dim3 grid((N + BN - 1) / BN, (M + BM - 1) / BM);
  gru_input_proj_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, w, b, out, M, K, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
