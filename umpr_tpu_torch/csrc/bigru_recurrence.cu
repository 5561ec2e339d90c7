// K2 bigru_recurrence: the masked bidirectional GRU recurrence.
//
// For each sentence row n with length len_n (>= 1) and each direction d:
//   fwd (d=0) runs t = 0 .. L-1, bwd (d=1) runs t = L-1 .. 0; step t is
//   valid when t < len_n, so the bwd state starts at the row's own last
//   token.  With xg_t = xg[n, t, d*3H:(d+1)*3H] and W = w_hh[d] (H, 3H):
//     hg = h @ W + b_hh[d]
//     r = sigmoid(xg_r + hg_r), z = sigmoid(xg_z + hg_z)
//     c = tanh(xg_n + r * hg_n)             (b_hn inside the reset gate)
//     h' = (1 - z) * c + z * h
//   A valid step stores h' into y and carries it; an invalid step stores 0
//   and leaves h frozen.  y (N, L, 2H) is in true time: fwd in columns
//   [0, H), bwd in [H, 2H).
//
// Replaces two TPU kernels of umpr_tpu/ops/gru_pallas.py:
//   B1 _pallas_forward / _fwd_kernel (pallas_call at :205) with
//      emit_hs=False: the recurrence, run there over a combined time axis
//      with the bwd lanes in reversed time, and
//   B6 _pallas_gru_outputs / _gru_out_kernel (pallas_call at :463), which
//      turned that combined-time output back into true time.  Here each
//      step stores straight into its true-time slot, so y is already B6's
//      y_sent and y_pos is a free view of it.
//
// Design: one block per (16-row tile, direction).  The TPU's sequential
// grid axis over time becomes a loop inside the block.  The block keeps
// that direction's W_hh (H x 3H f32, 48 KB at H=64) and the tile's state h
// in shared memory; thread (j, g) owns hidden unit j of 4 rows, so each
// W_hh column element read from shared memory feeds 4 rows' FMAs, and the
// h reads are warp-wide broadcasts.  The loop stops at the tile's longest
// row; later positions are stored as zeros.  N=2560 rows give 320 blocks.
//
// What bounds it on an H100: at the UMPR-R shapes (N=2560, L=20, H=64) it
// reads xg only at valid steps (at most 78.6 MB, about 41 MB for lengths
// uniform in 1..20), writes 26.2 MB of y and does 2.5 GFLOP of f32 FMA at
// most (about 1.3 at those lengths): ~20 us of HBM traffic and about as
// much f32 arithmetic at 67 TFLOP/s.  In practice the 20 dependent
// steps, each ending in a block barrier, and the shared-memory reads of
// W_hh bound it: the design spreads the rows over all SMs (320 blocks, 256
// threads each) so those latencies overlap across blocks.  Keeping W_hh in
// registers and tensor-core (wgmma) steps are later work.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;            // sentence rows per block
constexpr int RPT = 4;              // rows per thread
constexpr int GROUPS = ROWS / RPT;  // row groups; block = GROUPS * H threads

__device__ __forceinline__ float sigmoid(float v) { return 1.f / (1.f + expf(-v)); }

__global__ void __launch_bounds__(512)
bigru_recurrence_kernel(const float* __restrict__ xg, const int* __restrict__ lengths,
                        const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                        float* __restrict__ y, int N, int L, int H) {
  extern __shared__ float smem[];
  __shared__ int len_s[ROWS];
  __shared__ int maxlen_s;

  const int d = blockIdx.y;  // 0: fwd, 1: bwd
  const int G = 3 * H;
  float* w_s = smem;          // (H, 3H): this direction's W_hh
  float* h_s = smem + H * G;  // (ROWS, H): the tile's state
  const int tid = threadIdx.x;
  const int j = tid % H;  // hidden unit
  const int g = tid / H;  // row group
  const int row0 = blockIdx.x * ROWS;

  const float* w_src = w_hh + (size_t)d * H * G;
  for (int i = tid; i < H * G; i += blockDim.x) w_s[i] = w_src[i];
  for (int i = tid; i < ROWS * H; i += blockDim.x) h_s[i] = 0.f;
  if (tid < ROWS) {
    const int n = row0 + tid;
    len_s[tid] = n < N ? min(lengths[n], L) : 0;
  }
  __syncthreads();
  if (tid == 0) {
    int m = 0;
    for (int r = 0; r < ROWS; ++r) m = max(m, len_s[r]);
    maxlen_s = m;
  }
  __syncthreads();
  const int maxlen = maxlen_s;

  const float b_r = b_hh[d * G + j];
  const float b_z = b_hh[d * G + H + j];
  const float b_n = b_hh[d * G + 2 * H + j];
  int row[RPT], len[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    row[i] = row0 + g + i * GROUPS;
    len[i] = len_s[g + i * GROUPS];
  }
  const size_t y_stride = 2 * (size_t)H;
  const size_t xg_stride = 6 * (size_t)H;

  // positions past the tile's longest row: exact zeros
  for (int t = maxlen; t < L; ++t)
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      if (row[i] < N) y[((size_t)row[i] * L + t) * y_stride + d * H + j] = 0.f;

  for (int s = 0; s < maxlen; ++s) {
    const int t = d == 0 ? s : maxlen - 1 - s;
    float a_r[RPT], a_z[RPT], a_n[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      a_r[i] = b_r;
      a_z[i] = b_z;
      a_n[i] = b_n;
    }
    for (int k = 0; k < H; ++k) {
      const float w_r = w_s[k * G + j];
      const float w_z = w_s[k * G + H + j];
      const float w_n = w_s[k * G + 2 * H + j];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        const float hk = h_s[(g + i * GROUPS) * H + k];
        a_r[i] = fmaf(hk, w_r, a_r[i]);
        a_z[i] = fmaf(hk, w_z, a_z[i]);
        a_n[i] = fmaf(hk, w_n, a_n[i]);
      }
    }
    float h_new[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const float h_prev = h_s[(g + i * GROUPS) * H + j];
      const bool valid = t < len[i];
      h_new[i] = h_prev;
      if (valid) {
        const float* x = xg + ((size_t)row[i] * L + t) * xg_stride + d * G;
        const float r = sigmoid(x[j] + a_r[i]);
        const float z = sigmoid(x[H + j] + a_z[i]);
        const float c = tanhf(x[2 * H + j] + r * a_n[i]);
        h_new[i] = (1.f - z) * c + z * h_prev;
      }
      if (row[i] < N)
        y[((size_t)row[i] * L + t) * y_stride + d * H + j] = valid ? h_new[i] : 0.f;
    }
    __syncthreads();  // every read of the old state is done
#pragma unroll
    for (int i = 0; i < RPT; ++i) h_s[(g + i * GROUPS) * H + j] = h_new[i];
    __syncthreads();  // the new state is visible
  }
}

}  // namespace

// xg (N, L, 6H), lengths (N,) int32, w_hh (2, H, 3H), b_hh (2, 3H),
// y (N, L, 2H): contiguous, on the device.  Needs H <= 128 (threads and
// shared memory).  Launches on `stream`; returns the cudaError_t.
extern "C" int bigru_recurrence(const float* xg, const int* lengths, const float* w_hh,
                                const float* b_hh, float* y, int N, int L, int H,
                                void* stream) {
  if (N == 0 || L == 0) return 0;
  const size_t smem = (size_t)(3 * H * H + ROWS * H) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      bigru_recurrence_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((N + ROWS - 1) / ROWS, 2);
  bigru_recurrence_kernel<<<grid, GROUPS * H, smem, static_cast<cudaStream_t>(stream)>>>(
      xg, lengths, w_hh, b_hh, y, N, L, H);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
