// K9 gru_input_proj_dx: the bi-GRU's input gradient.
//
//   dx (M, E) = dxg (M, 6H) @ W_ih^T,   W_ih = [W_ih_fwd | W_ih_bwd] (E, 6H)
//
// M = N*L sentence-row tokens in true time; dxg is K3's output (both
// directions' gate gradients side by side, zeros at invalid steps) and
// W_ih the packed projection of BiGRU.kernel_operands.  Both directions
// projected the same x, so one product over all 6H columns sums their
// contributions.  f32 in, f32 out, f32 accumulation.
//
// Replaces the emit_dxc=True branch of the TPU kernel B4,
// umpr_tpu/ops/gru_pallas.py _pallas_project_bwd / _proj_bwd_kernel
// (pallas_call at :394): dxc = dxg @ W^T over the stacked [x | x
// time-flipped | pad] stream, which the wrapper then un-flipped.  Here dxg
// and dx are in true time, so there is no flip and no 128-lane padding.
// It is a kernel of its own: K4 (gru_input_proj_bwd.cu), which takes the
// other half of B4, splits over rows to reduce dW_ih, while this product
// is row-parallel with nothing to reduce across blocks.
//
// What bounds it on an H100: operations, by a little.  At the UMPR-R
// shapes (M=51,200, 6H=384, E=50) it does 2*M*6H*E = 1.97 GFLOP (29 us at
// the 67 TFLOP/s f32 CUDA-core peak) and moves 88.9 MB (27 us at
// 3.35 TB/s): one read of dxg, one write of dx, W_ih from cache.
//
// Design: K1's shared-memory tiled SGEMM with the second operand read
// transposed: 64 x 64 output tiles, depth in steps of 16, 4 x 4 outputs
// per thread, columns interleaved across threads so that neighbouring
// threads store neighbouring addresses.  W_ih^T's tile is loaded along
// W_ih's rows (contiguous in 6H) and stored transposed into shared memory.
// Tensor cores (TF32 would break f32 parity) and TMA are later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;  // rows per block tile
constexpr int BN = 64;  // columns (E) per block tile
constexpr int BK = 16;  // depth (6H) per shared-memory stage
constexpr int TM = 4;   // rows per thread
constexpr int TN = 4;   // columns per thread
constexpr int TX = BN / TN;
constexpr int TY = BM / TM;
constexpr int THREADS = TX * TY;

__global__ void __launch_bounds__(THREADS)
gru_input_proj_dx_kernel(const float* __restrict__ dxg, const float* __restrict__ w,
                         float* __restrict__ dx, int M, int G, int E) {
  __shared__ float gs[BK][BM + 1];  // dxg tile, depth-major
  __shared__ float ws[BK][BN + 1];  // W_ih^T tile, depth-major
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

  for (int k0 = 0; k0 < G; k0 += BK) {
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int r = i / BK, c = i % BK;  // row r of the tile, depth c
      const int gr = row0 + r, gc = k0 + c;
      gs[c][r] = (gr < M && gc < G) ? dxg[(size_t)gr * G + gc] : 0.f;
    }
    for (int i = tid; i < BN * BK; i += THREADS) {
      const int n = i / BK, c = i % BK;  // W_ih row col0 + n, depth c
      const int gn = col0 + n, gc = k0 + c;
      ws[c][n] = (gn < E && gc < G) ? w[(size_t)gn * G + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], bv[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = gs[kk][ty + i * TY];
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
      if (c < E) dx[(size_t)r * E + c] = acc[i][j];
    }
  }
}

}  // namespace

// dxg (M, G), w (E, G), dx (M, E): f32, contiguous, on the device.
// Launches on `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int gru_input_proj_dx(const float* dxg, const float* w, float* dx, int M, int G,
                                 int E, void* stream) {
  if (M == 0 || E == 0) return 0;
  const dim3 grid((E + BN - 1) / BN, (M + BM - 1) / BM);
  gru_input_proj_dx_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      dxg, w, dx, M, G, E);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
