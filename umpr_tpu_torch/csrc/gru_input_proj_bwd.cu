// K4 gru_input_proj_bwd: the weight gradients of K1's input projection.
//
//   dW_ih (E, 6H) = x^T (E, M) @ dxg (M, 6H),   db_ih (6H) = sum_m dxg[m]
//
// M = N*L sentence-row tokens.  dxg comes from K3 in true time for both
// directions, and K1 read x in true time for both, so x is used as it is:
// nothing is stacked or flipped.  f32 in, f32 out, f32 accumulation.
//
// Replaces the TPU kernel B4 of umpr_tpu/ops/gru_pallas.py,
// _pallas_project_bwd / _proj_bwd_kernel (pallas_call at :394), with
// emit_dxc=False: the GloVe table is frozen, so no input gradient is made.
// The TPU accumulated dW over a sequential grid in VMEM scratch; here the
// M axis is split across blocks (split-K): block (column tile, E tile,
// chunk) reduces `rows_per_block` rows into its own partial, and the
// partials are summed afterwards in a fixed order (no float atomics, the
// same bits on every run).
//
// What bounds it on an H100: at the UMPR-R shapes (M=51,200, E=50,
// 6H=384) it reads 88.9 MB (x 10.2 MB, dxg 78.6 MB) and does 2.0 GFLOP of
// f32 FMA: ~26.5 us of HBM traffic against ~29.3 us at the 67 TFLOP/s f32
// (non-tensor-core) peak, so operations bound it, by a little.  The design
// is a plain shared-memory tiled SGEMM like K1: 64x64 output tiles, 16 rows
// per stage, 4x4 outputs per thread; the E tile 0 blocks also sum dxg's
// columns for db.  Tensor cores (TF32 would break f32 parity) and TMA are
// later work.

#include <cuda_runtime.h>

namespace {

constexpr int BM = 64;  // dW rows (E) per block tile
constexpr int BN = 64;  // dW columns (6H) per block tile
constexpr int BK = 16;  // x/dxg rows per shared-memory stage
constexpr int TM = 4;   // dW rows per thread
constexpr int TN = 4;   // dW columns per thread
constexpr int TX = BN / TN;  // 16 column lanes
constexpr int TY = BM / TM;  // 16 row lanes
constexpr int THREADS = TX * TY;
static_assert(TY == BK, "db: row lane ty sums stage row ty");

__global__ void __launch_bounds__(THREADS)
gru_input_proj_bwd_kernel(const float* __restrict__ x, const float* __restrict__ dxg,
                          float* __restrict__ dw_part, float* __restrict__ db_part,
                          int M, int E, int G, int rows_per_block) {
  __shared__ float xs[BK][BM];
  __shared__ float gs[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int col0 = blockIdx.x * BN;
  const int e0 = blockIdx.y * BM;
  const int chunk = blockIdx.z;
  const int m_begin = chunk * rows_per_block;
  const int m_end = min(M, m_begin + rows_per_block);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.f;
  float db_acc[TN] = {0.f, 0.f, 0.f, 0.f};

  for (int m0 = m_begin; m0 < m_end; m0 += BK) {
    for (int i = tid; i < BK * BM; i += THREADS) {
      const int r = i / BM, c = i % BM;
      const int gm = m0 + r, ge = e0 + c;
      xs[r][c] = (gm < m_end && ge < E) ? x[(size_t)gm * E + ge] : 0.f;
    }
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int r = i / BN, c = i % BN;
      const int gm = m0 + r, gc = col0 + c;
      gs[r][c] = (gm < m_end && gc < G) ? dxg[(size_t)gm * G + gc] : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM], b[TN];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty + i * TY];
#pragma unroll
      for (int j = 0; j < TN; ++j) b[j] = gs[kk][tx + j * TX];
#pragma unroll
      for (int i = 0; i < TM; ++i)
#pragma unroll
        for (int j = 0; j < TN; ++j) acc[i][j] = fmaf(a[i], b[j], acc[i][j]);
    }
#pragma unroll
    for (int j = 0; j < TN; ++j) db_acc[j] += gs[ty][tx + j * TX];
    __syncthreads();
  }

  float* dw = dw_part + (size_t)chunk * E * G;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int e = e0 + ty + i * TY;
    if (e >= E) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int c = col0 + tx + j * TX;
      if (c < G) dw[(size_t)e * G + c] = acc[i][j];
    }
  }
  if (blockIdx.y != 0) return;
  // db: the row lanes' column sums, added in a fixed order
#pragma unroll
  for (int j = 0; j < TN; ++j) gs[ty][tx + j * TX] = db_acc[j];
  __syncthreads();
  if (tid < BN && col0 + tid < G) {
    float sum = 0.f;
    for (int r = 0; r < TY; ++r) sum += gs[r][tid];
    db_part[(size_t)chunk * G + col0 + tid] = sum;
  }
}

}  // namespace

// x (M, E), dxg (M, G) -> dw_part (ceil(M/rows_per_block) or 1, E, G),
// db_part (same count, G): f32, contiguous, on the device.  Launches on
// `stream` and returns the launch's cudaError_t (0 = success).
extern "C" int gru_input_proj_bwd(const float* x, const float* dxg, float* dw_part,
                                  float* db_part, int M, int E, int G, int rows_per_block,
                                  void* stream) {
  if (G == 0) return 0;
  if (rows_per_block <= 0 || rows_per_block % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int chunks = M > 0 ? (M + rows_per_block - 1) / rows_per_block : 1;
  const int e_tiles = E > 0 ? (E + BM - 1) / BM : 1;
  const dim3 grid((G + BN - 1) / BN, e_tiles, chunks);
  gru_input_proj_bwd_kernel<<<grid, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      x, dxg, dw_part, db_part, M, E, G, rows_per_block);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
