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
//
// Any H: this shared-memory kernel takes H <= 128 (W_hh fits: 192 KB at
// H = 128, and 4H threads); past that a wide kernel (below) keeps W_hh in
// L2 and lets each thread own whole hidden units of all 16 rows, as the
// JAX package's bigru_scan takes any gru_size.

#include <cuda_runtime.h>

namespace {

constexpr int ROWS = 16;            // sentence rows per block
constexpr int RPT = 4;              // rows per thread
constexpr int GROUPS = ROWS / RPT;  // row groups; block = GROUPS * H threads
constexpr int MAX_SMEM_H = 128;     // the largest H of the shared-memory kernel

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

// ---- the wide kernel (H > 128, past the shared-memory kernel's W_hh and
// its 4H threads): 256 threads own the hidden units j = tid, tid + 256, ...
// of all 16 rows of the tile, so each W_hh element read feeds 16 rows'
// FMAs.  W_hh (3H^2 f32, 786 KB per direction at H = 256) is read from
// global memory, where both directions' 1.5 MB stay in L2; neighbouring
// threads read neighbouring units, so the reads are coalesced.  The state
// is double-buffered, transposed (h[k][row], so a k's 16 rows are four
// 16-byte loads), in shared memory, or in a global scratch buffer where
// 2 x 16 x H floats exceed it (H > 1814); one barrier per step.

constexpr int WTHREADS = 256;
// a block's shared memory on Hopper (227 KB), less the static arrays
constexpr size_t SMEM_LIMIT = 232448 - 256;

size_t wide_state_bytes(int H) { return (size_t)2 * ROWS * H * sizeof(float); }

__global__ void __launch_bounds__(WTHREADS)
bigru_recurrence_wide(const float* __restrict__ xg, const int* __restrict__ lengths,
                      const float* __restrict__ w_hh, const float* __restrict__ b_hh,
                      float* __restrict__ y, float* __restrict__ scratch, int N, int L, int H) {
  extern __shared__ float4 smem4[];
  __shared__ int len_s[ROWS];
  __shared__ int maxlen_s;
  const int d = blockIdx.y;
  const int G = 3 * H;
  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * ROWS;
  float* state = scratch == nullptr
                     ? reinterpret_cast<float*>(smem4)
                     : scratch + ((size_t)blockIdx.y * gridDim.x + blockIdx.x) * 2 * ROWS * H;
  const float* W = w_hh + (size_t)d * H * G;

  for (int i = tid; i < ROWS * H; i += WTHREADS) state[i] = 0.f;
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
  const size_t y_stride = 2 * (size_t)H;
  const size_t xg_stride = 6 * (size_t)H;

  // positions past the tile's longest row: exact zeros
  for (int t = maxlen; t < L; ++t)
    for (int i = tid; i < ROWS * H; i += WTHREADS) {
      const int n = row0 + i / H;
      if (n < N) y[((size_t)n * L + t) * y_stride + d * H + i % H] = 0.f;
    }

  for (int s = 0; s < maxlen; ++s) {
    const int t = d == 0 ? s : maxlen - 1 - s;
    const float* hc = state + (s & 1) * ROWS * H;  // h[k][row] before the step
    float* hn = state + ((s + 1) & 1) * ROWS * H;  // after it
    for (int j = tid; j < H; j += WTHREADS) {
      float a_r[ROWS], a_z[ROWS], a_n[ROWS];
      const float b_r = b_hh[d * G + j], b_z = b_hh[d * G + H + j], b_n = b_hh[d * G + 2 * H + j];
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        a_r[r] = b_r;
        a_z[r] = b_z;
        a_n[r] = b_n;
      }
      for (int k = 0; k < H; ++k) {
        const float w_r = __ldg(W + (size_t)k * G + j);
        const float w_z = __ldg(W + (size_t)k * G + H + j);
        const float w_n = __ldg(W + (size_t)k * G + 2 * H + j);
        const float4* h4 = reinterpret_cast<const float4*>(hc + k * ROWS);
#pragma unroll
        for (int q = 0; q < ROWS / 4; ++q) {
          const float4 h = h4[q];
          const float hv[4] = {h.x, h.y, h.z, h.w};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            a_r[4 * q + e] = fmaf(hv[e], w_r, a_r[4 * q + e]);
            a_z[4 * q + e] = fmaf(hv[e], w_z, a_z[4 * q + e]);
            a_n[4 * q + e] = fmaf(hv[e], w_n, a_n[4 * q + e]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const int n = row0 + r;
        const float h_prev = hc[j * ROWS + r];
        const bool valid = t < len_s[r];
        float h_new = h_prev;
        if (valid) {
          const float* x = xg + ((size_t)n * L + t) * xg_stride + d * G;
          const float rg = sigmoid(x[j] + a_r[r]);
          const float z = sigmoid(x[H + j] + a_z[r]);
          const float c = tanhf(x[2 * H + j] + rg * a_n[r]);
          h_new = (1.f - z) * c + z * h_prev;
        }
        hn[j * ROWS + r] = h_new;
        if (n < N) y[((size_t)n * L + t) * y_stride + d * H + j] = valid ? h_new : 0.f;
      }
    }
    __syncthreads();  // the new state is complete, and every read of the old one done
  }
}

}  // namespace

// xg (N, L, 6H), lengths (N,) int32, w_hh (2, H, 3H), b_hh (2, 3H),
// y (N, L, 2H): contiguous, on the device; any H >= 1.  scratch: 2 x
// ceil(N/16) x 2 x 16 x H floats where bigru_recurrence_scratch says so,
// else unused (may be null).  Launches on `stream`; returns the
// cudaError_t.
extern "C" int bigru_recurrence(const float* xg, const int* lengths, const float* w_hh,
                                const float* b_hh, float* y, float* scratch, int N, int L,
                                int H, void* stream) {
  if (N == 0 || L == 0) return 0;
  if (H <= 0) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const dim3 grid((N + ROWS - 1) / ROWS, 2);
  if (H <= MAX_SMEM_H) {
    const size_t smem = (size_t)(3 * H * H + ROWS * H) * sizeof(float);
    cudaError_t err = cudaFuncSetAttribute(
        bigru_recurrence_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    bigru_recurrence_kernel<<<grid, GROUPS * H, smem, s>>>(xg, lengths, w_hh, b_hh, y, N, L, H);
    return static_cast<int>(cudaGetLastError());
  }
  const bool shared = wide_state_bytes(H) <= SMEM_LIMIT;
  if (!shared && scratch == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = shared ? wide_state_bytes(H) : 0;
  cudaError_t err = cudaFuncSetAttribute(
      bigru_recurrence_wide, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  bigru_recurrence_wide<<<grid, WTHREADS, smem, s>>>(xg, lengths, w_hh, b_hh, y,
                                                     shared ? nullptr : scratch, N, L, H);
  return static_cast<int>(cudaGetLastError());
}

// floats of the scratch the wide kernel needs at (N, H): 0 where its state
// fits the shared memory (and for H <= 128, the shared-memory kernel)
extern "C" long long bigru_recurrence_scratch(int N, int H) {
  if (H <= MAX_SMEM_H || wide_state_bytes(H) <= SMEM_LIMIT) return 0;
  return (long long)((N + ROWS - 1) / ROWS) * 2 * 2 * ROWS * H;
}

extern "C" const char* error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
